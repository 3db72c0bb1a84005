"""Azure modules, including the HA (RKE-built, in-cluster manager)
variant: the port's copy of the reference's ``modules/azure.py``.

Reference analog: modules/azure-rancher (RG/vnet/subnet/NSG/VM),
modules/azure-rke (the HA manager: N VMs all
controlplane+etcd+worker, manager deployed *inside* the cluster with
Ingress+TLS, main.tf:115-361), modules/azure-rancher-k8s,
modules/azure-rancher-k8s-host (managed disk option, main.tf:56-66).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .base import DriverContext, Resource, Variable
from .family import ClusterModule, HostModule, ManagerModule
from .registry import register


def _azure_envelope(prefix: str, ctx: DriverContext, ports: List[int]) -> List[Resource]:
    res = []
    for rtype, rname, attrs in [
        ("azure_resource_group", f"{prefix}-rg", {}),
        ("azure_virtual_network", f"{prefix}-vnet", {}),
        ("azure_subnet", f"{prefix}-subnet", {}),
        ("azure_network_security_group", f"{prefix}-nsg", {"ingress": ports}),
    ]:
        ctx.cloud.create_resource(rtype, rname, **attrs)
        res.append(Resource(rtype, rname))
    return res


_AZURE_CRED_VARS = [
    Variable("azure_subscription_id", required=True),
    Variable("azure_client_id", required=True),
    Variable("azure_client_secret", required=True),
    Variable("azure_tenant_id", required=True),
    Variable("azure_location", default="West US 2"),
]


@register
class AzureManager(ManagerModule):
    SOURCE = "modules/azure-manager"
    ALIASES = ("azure-rancher",)
    PROVIDER = "azure"
    VARIABLES = ManagerModule.VARIABLES + _AZURE_CRED_VARS + [
        Variable("azure_size", default="Standard_D2s_v3"),
        Variable("azure_public_key_path", default="~/.ssh/id_rsa.pub"),
    ]

    def network_resources(self, config: Dict[str, Any], ctx: DriverContext
                          ) -> List[Resource]:
        return _azure_envelope(config["name"], ctx, [22, 80, 443])


@register
class AzureRkeManager(ManagerModule):
    """HA manager: node_count VMs, every node controlplane+etcd+worker, the
    manager running as an in-cluster Deployment behind Ingress + TLS.

    Reference analog: modules/azure-rke/main.tf:115-361 (count=node_count VM
    set, NSG with internal etcd/kubelet ports :65-113, rke_cluster with all
    roles :234-257, in-cluster Rancher addon YAML :258-361); the
    tls_cert/key-path inputs come from create/manager_azure.go:56-193 (whose
    cert-path-into-key-path bug, :155, is *not* reproduced here).
    """

    SOURCE = "modules/azure-rke-manager"
    ALIASES = ("azure-rke",)
    PROVIDER = "azure"
    OUTPUTS = ManagerModule.OUTPUTS + ["kube_config_yaml"]
    VARIABLES = ManagerModule.VARIABLES + _AZURE_CRED_VARS + [
        Variable("node_count", default=3),
        Variable("fqdn", required=True),
        Variable("tls_cert_path", required=True),
        Variable("tls_private_key_path", required=True),
        Variable("azure_size", default="Standard_D2s_v3"),
        Variable("azure_public_key_path", default="~/.ssh/id_rsa.pub"),
    ]

    def apply(self, config: Dict[str, Any], ctx: DriverContext
              ) -> Tuple[Dict[str, Any], List[Resource]]:
        name = config["name"]
        resources = _azure_envelope(
            name, ctx, [22, 80, 443, 2379, 2380, 6443, 10250])
        for i in range(int(config.get("node_count", 3))):
            vm = f"{name}-{i}"
            ctx.cloud.create_resource(
                "azure_instance", vm, roles=["controlplane", "etcd", "worker"])
            resources.append(Resource("azure_instance", vm))
        url = f"https://{config['fqdn']}"
        creds = ctx.cloud.bootstrap_manager(name, url)
        ctx.cloud.create_resource("manager", name, url=url, ha=True,
                                  node_count=int(config.get("node_count", 3)))
        resources.append(Resource("manager", name))
        # The manager's own cluster, with the manager deployed in-cluster.
        mgr_cluster = ctx.cloud.create_or_get_cluster(url, f"{name}-local")
        for i in range(int(config.get("node_count", 3))):
            ctx.cloud.register_node(
                mgr_cluster["registration_token"], f"{name}-{i}",
                ["controlplane", "etcd", "worker"],
                ca_checksum=mgr_cluster["ca_checksum"])
        ctx.cloud.apply_manifest(mgr_cluster["id"], {
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": "cluster-manager",
                         "namespace": "cattle-system",
                         "labels": {"app": "cluster-manager"}},
            "spec": {
                "replicas": int(config.get("node_count", 3)),
                "selector": {"matchLabels": {"app": "cluster-manager"}},
                "template": {
                    "metadata": {"labels": {"app": "cluster-manager"}},
                    "spec": {"containers": [{
                        "name": "manager",
                        "image": str(config.get("manager_image",
                                                "tk8s/manager:2.0")),
                        "ports": [{"containerPort": 80},
                                  {"containerPort": 443}],
                    }]},
                },
            },
        })
        ctx.cloud.apply_manifest(mgr_cluster["id"], {
            "apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
            "metadata": {"name": "cluster-manager", "namespace": "cattle-system"},
            "spec": {"tls": [{"hosts": [config["fqdn"]]}]},
        })
        outputs = {
            "manager_url": creds["url"],
            "manager_access_key": creds["access_key"],
            "manager_secret_key": creds["secret_key"],
            "kube_config_yaml": f"# kubeconfig for {name} (simulated)\n",
        }
        return outputs, resources


@register
class AzureCluster(ClusterModule):
    SOURCE = "modules/azure-k8s"
    ALIASES = ("azure-rancher-k8s",)
    PROVIDER = "azure"
    VARIABLES = ClusterModule.VARIABLES + _AZURE_CRED_VARS

    def network_resources(self, config: Dict[str, Any], ctx: DriverContext
                          ) -> Tuple[List[Resource], Dict[str, Any]]:
        res = _azure_envelope(config["name"], ctx,
                              [22, 80, 443, 2379, 2380, 6443, 10250])
        return res, {
            "azure_subnet_id": f"{config['name']}-subnet",
            # Host placement contract shared with the HCL twin's outputs.
            "azure_resource_group": f"{config['name']}-rg",
            "azure_location": str(config.get("azure_location", "")),
        }


@register
class AzureHost(HostModule):
    SOURCE = "modules/azure-k8s-host"
    ALIASES = ("azure-rancher-k8s-host",)
    PROVIDER = "azure"
    VARIABLES = HostModule.VARIABLES + _AZURE_CRED_VARS + [
        Variable("azure_size", default="Standard_D2s_v3"),
        Variable("azure_subnet_id", default=""),
        Variable("azure_public_key_path", default="~/.ssh/id_rsa.pub"),
        Variable("managed_disk_type", default=""),
        Variable("managed_disk_size", default=0),
        Variable("managed_disk_mount_path", default=""),
    ]

    def instance_attrs(self, config: Dict[str, Any]) -> Dict[str, Any]:
        return {"size": config.get("azure_size"),
                "subnet": config.get("azure_subnet_id")}

    def extra_resources(self, config: Dict[str, Any], ctx: DriverContext
                        ) -> List[Resource]:
        if not config.get("managed_disk_type"):
            return []
        name = f"{config['hostname']}-disk"
        ctx.cloud.create_resource("azure_managed_disk", name,
                                  type=config["managed_disk_type"],
                                  size=config.get("managed_disk_size"),
                                  mount=config.get("managed_disk_mount_path"))
        return [Resource("azure_managed_disk", name)]
