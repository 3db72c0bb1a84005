"""The three module families as shared base classes: the port's copy of
the reference's ``modules/family.py``.

Reference analog (SURVEY.md §2.2): ``*-rancher`` (manager VM + control-plane
bootstrap), ``*-rancher-k8s`` (cluster registration + network envelope), and
``*-rancher-k8s-host`` (one VM per module instance that self-registers).
The reference repeats these as ~25 near-identical HCL modules; here each
family is one class and providers override the provider-specific envelope.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .base import DriverContext, Module, Resource, Variable


class ManagerModule(Module):
    """Manager family: provision a control-plane VM, install the container
    runtime, start the manager, mint API credentials.

    Reference analog: modules/triton-rancher/main.tf:20-137 (machine +
    install_docker_rancher.sh + install_rancher_master + setup_rancher_k8s +
    data.external api-key read), outputs.tf:1-11.
    """

    PROVIDER = ""  # e.g. "triton"
    OUTPUTS = ["manager_url", "manager_access_key", "manager_secret_key"]
    VARIABLES = [
        Variable("name", required=True),
        Variable("manager_image", default="tk8s/manager:2.0"),
        Variable("agent_image", default="tk8s/agent:2.0"),
        Variable("admin_password", default=""),
    ]

    def network_resources(self, config: Dict[str, Any], ctx: DriverContext
                          ) -> List[Resource]:
        """Provider network envelope (VPC/firewall analog); default none."""
        return []

    def apply(self, config: Dict[str, Any], ctx: DriverContext
              ) -> Tuple[Dict[str, Any], List[Resource]]:
        resources = self.network_resources(config, ctx)
        name = config["name"]
        inst = ctx.cloud.create_resource(
            f"{self.PROVIDER}_instance", f"{name}-manager",
            role="manager",
            manager_image=config.get("manager_image"),
        )
        resources.append(Resource(f"{self.PROVIDER}_instance", f"{name}-manager"))
        url = f"https://{inst['ip']}"
        creds = ctx.cloud.bootstrap_manager(name, url)
        ctx.cloud.create_resource("manager", name, url=url)
        resources.append(Resource("manager", name))
        return (
            {
                "manager_url": creds["url"],
                "manager_access_key": creds["access_key"],
                "manager_secret_key": creds["secret_key"],
            },
            resources,
        )


class ClusterModule(Module):
    """Cluster family: create-or-get the cluster registration plus the
    provider network envelope.

    Reference analog: modules/*-rancher-k8s/main.tf — data.external
    rancher_cluster (files/rancher_cluster.sh) + VPC/firewall where the
    provider needs one; outputs cluster_id/registration_token/ca_checksum.
    """

    PROVIDER = ""
    OUTPUTS = ["cluster_id", "registration_token", "ca_checksum"]
    VARIABLES = [
        Variable("name", required=True),
        Variable("manager_url", required=True),
        Variable("manager_access_key", required=True),
        Variable("manager_secret_key", required=True),
        Variable("k8s_version", default="v1.29.4"),
        Variable("k8s_network_provider", default="calico"),
    ]

    def network_resources(self, config: Dict[str, Any], ctx: DriverContext
                          ) -> Tuple[List[Resource], Dict[str, Any]]:
        """Returns (resources, extra_outputs) — e.g. gcp network name + tag
        consumed by host modules via interpolation
        (create/node_gcp.go: ``${module.cluster_*.gcp_compute_network_name}``)."""
        return [], {}

    def apply(self, config: Dict[str, Any], ctx: DriverContext
              ) -> Tuple[Dict[str, Any], List[Resource]]:
        resources, extra = self.network_resources(config, ctx)
        cluster = ctx.cloud.create_or_get_cluster(
            config["manager_url"], config["name"],
            k8s_version=config.get("k8s_version"),
            network_provider=config.get("k8s_network_provider"),
        )
        ctx.cloud.create_resource("cluster", cluster["id"], cluster_name=config["name"])
        resources.append(Resource("cluster", cluster["id"]))
        outputs = {
            "cluster_id": cluster["id"],
            "registration_token": cluster["registration_token"],
            "ca_checksum": cluster["ca_checksum"],
            **extra,
        }
        return outputs, resources


class HostModule(Module):
    """Host family: one VM that boots and self-registers into its cluster.

    Reference analog: modules/*-rancher-k8s-host/main.tf + the
    install_rancher_agent.sh.tpl cloud-init (docker install, optional disk
    mount, ``docker run rancher-agent --server --token --ca-checksum
    --<role>``) with role mapping control->controlplane.
    """

    PROVIDER = ""
    OUTPUTS: List[str] = []
    VARIABLES = [
        Variable("hostname", required=True),
        # Endpoint the agent registers against (reference wires
        # rancher_api_url into every host module the same way).
        Variable("manager_url", default=""),
        Variable("rancher_agent_image", default="tk8s/agent:2.0"),
        Variable("rancher_cluster_registration_token", required=True),
        Variable("rancher_cluster_ca_checksum", required=True),
        Variable("rancher_host_labels", default={}),
    ]

    ROLE_MAP = {"control": "controlplane", "etcd": "etcd", "worker": "worker"}

    def instance_attrs(self, config: Dict[str, Any]) -> Dict[str, Any]:
        return {}

    def extra_resources(self, config: Dict[str, Any], ctx: DriverContext
                        ) -> List[Resource]:
        """Optional block storage etc. (aws EBS, azure managed disk,
        gcp disk — reference host modules' optional disk blocks)."""
        return []

    def apply(self, config: Dict[str, Any], ctx: DriverContext
              ) -> Tuple[Dict[str, Any], List[Resource]]:
        hostname = config["hostname"]
        host_labels = config.get("rancher_host_labels") or {}
        roles = [self.ROLE_MAP[r] for r, on in sorted(host_labels.items())
                 if on and r in self.ROLE_MAP] or ["worker"]
        resources = [Resource(f"{self.PROVIDER}_instance", hostname)]
        ctx.cloud.create_resource(
            f"{self.PROVIDER}_instance", hostname,
            roles=roles, **self.instance_attrs(config))
        resources.extend(self.extra_resources(config, ctx))
        ctx.cloud.register_node(
            config["rancher_cluster_registration_token"],
            hostname, roles,
            labels={k: str(v) for k, v in host_labels.items()},
            ca_checksum=config["rancher_cluster_ca_checksum"],
        )
        return {}, resources

    def destroy(self, applied: Dict[str, Any], ctx: DriverContext) -> None:
        super().destroy(applied, ctx)
        # Destroying the host removes its cluster membership too — the
        # reference leaves that to the operator (delete the node in the
        # Rancher UI after the VM is gone); in-band removal keeps `get
        # cluster` health listings free of ghost entries and makes
        # `repair node` (destroy + re-create, same hostname) come back
        # Ready instead of inheriting the dead node's NotReady record.
        hostname = applied.get("config", {}).get("hostname")
        if hostname:
            ctx.cloud.deregister_node(hostname)
