"""Spec-driven DAG loader: a JSON-able topology spec -> a StateDocument
(the port's copy of the reference's ``executor/dagspec.py``).

The chaos harness (``chaos/``) generates random module DAGs as *specs* --
small structured dicts naming a manager, clusters by provider family, and
their nodes/pools/jobsets -- rather than as documents, so failing
scenarios can be shrunk structurally (drop a cluster, drop a node) and
serialized into the regression corpus (``tests/chaos_corpus/*.json``).
This module is the single place a spec is materialized into the module
configs the engine applies: every consumer builds the byte-identical
document for the same spec.

Topology spec shape (all keys JSON-able)::

    {"manager": {"provider": "bare-metal", "name": "m1"},
     "clusters": [
       {"provider": "aws", "name": "c0", "nodes": ["w0", "w1"]},
       {"provider": "gke", "name": "h0"},
       {"provider": "gcp-gpu", "name": "ml",
        "pools": [{"name": "pool0", "accelerator": "h100-16"}],
        "jobsets": [{"name": "j0", "pool": "pool0"}]},
     ]}

Provider families (the driver shape matrix the modules layer ships):

* ``rancher`` -- manager-registered clusters with per-VM host modules
  (aws, azure, triton, vsphere, bare-metal, gcp);
* ``hosted`` -- provider-managed control planes imported into the manager
  (gke, aks), no host modules;
* ``gpu`` -- GKE clusters whose capacity is GPU node pools (gcp-gpu),
  plus optional JobSet workloads pinned to a pool. It stands in the
  place of the reference's ``tpu`` family (``gcp-tpu`` clusters of TPU
  slices): the twin of a reference spec (``chaos.generator.twin_spec``)
  names ``gcp-gpu`` and an ``h100-*`` accelerator, and materializes to
  the reference's document but in the twin's fields -- the provider slot
  of the keys (``cluster_gcp-gpu_ml``, ``node_gcp-gpu_ml_pool0``), the
  module sources and ``gpu_accelerator`` for ``tpu_accelerator``.

Credentials are canned constants: the simulator never validates values,
and constant configs keep generated documents content-addressed (the
parity fingerprints cover the config bytes).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..state import StateDocument

#: A GPU pool's accelerator when its spec names none.
DEFAULT_ACCELERATOR = "h100-16"

#: provider -> (family, has_manager_module)
PROVIDER_SHAPES: Dict[str, Dict[str, Any]] = {
    "aws": {"family": "rancher", "manager": True},
    "azure": {"family": "rancher", "manager": True},
    "triton": {"family": "rancher", "manager": True},
    "gcp": {"family": "rancher", "manager": True},
    "bare-metal": {"family": "rancher", "manager": True},
    "vsphere": {"family": "rancher", "manager": False},
    "gke": {"family": "hosted", "manager": False},
    "aks": {"family": "hosted", "manager": False},
    "gcp-gpu": {"family": "gpu", "manager": False},
}

MANAGER_PROVIDERS = tuple(sorted(
    p for p, s in PROVIDER_SHAPES.items() if s["manager"]))

# Canned provider credential/config blocks (required variables only).
_CREDS: Dict[str, Dict[str, Any]] = {
    "aws": {"aws_access_key": "AKIA-chaos", "aws_secret_key": "chaos-secret"},
    "azure": {"azure_subscription_id": "sub-chaos",
              "azure_client_id": "client-chaos",
              "azure_client_secret": "secret-chaos",
              "azure_tenant_id": "tenant-chaos"},
    "triton": {"triton_account": "chaos",
               "triton_key_path": "/tmp/chaos_id_rsa",
               "triton_key_id": "aa:bb:cc"},
    "gcp": {"gcp_path_to_credentials": "/tmp/chaos-creds.json",
            "gcp_project_id": "chaos-project"},
    "bare-metal": {},
    "vsphere": {"vsphere_user": "chaos", "vsphere_password": "chaos-pw",
                "vsphere_server": "vc.chaos.local",
                "vsphere_datacenter_name": "dc1",
                "vsphere_datastore_name": "ds1",
                "vsphere_resource_pool_name": "rp1",
                "vsphere_network_name": "net1"},
    "gke": {"gcp_path_to_credentials": "/tmp/chaos-creds.json",
            "gcp_project_id": "chaos-project"},
    "aks": {"azure_subscription_id": "sub-chaos",
            "azure_client_id": "client-chaos",
            "azure_client_secret": "secret-chaos",
            "azure_tenant_id": "tenant-chaos"},
    "gcp-gpu": {"gcp_path_to_credentials": "/tmp/chaos-creds.json",
                "gcp_project_id": "chaos-project"},
}


class DagSpecError(ValueError):
    """The topology spec is malformed (unknown provider, a jobset naming a
    pool the cluster does not declare, a vsphere manager...)."""


def _manager_refs() -> Dict[str, str]:
    return {
        "manager_url": "${module.cluster-manager.manager_url}",
        "manager_access_key": "${module.cluster-manager.manager_access_key}",
        "manager_secret_key": "${module.cluster-manager.manager_secret_key}",
    }


def _host_ip(i: int) -> str:
    return f"192.168.{100 + i // 200}.{10 + i % 200}"


def document_from_spec(topology: Dict[str, Any], name: str,
                       driver: Optional[Dict[str, Any]] = None,
                       backend_name: Optional[str] = None,
                       backend: Optional[Dict[str, Any]] = None
                       ) -> StateDocument:
    """Materialize a topology spec into a StateDocument.

    ``driver`` (fault plan, op_latency, ...) lands as the document's
    driver block; ``backend`` is its ``terraform.backend`` block, by
    default the in-process memory store named ``backend_name`` (or
    ``name``).
    """
    doc = StateDocument(name)
    doc.set_backend_config(backend or {"memory": {"name": backend_name
                                                  or name}})
    if driver:
        doc.set("driver", driver)

    mgr = topology.get("manager") or {}
    mprov = mgr.get("provider", "bare-metal")
    shape = PROVIDER_SHAPES.get(mprov)
    if shape is None or not shape["manager"]:
        raise DagSpecError(
            f"provider {mprov!r} has no manager module "
            f"(choices: {list(MANAGER_PROVIDERS)})")
    mcfg: Dict[str, Any] = {
        "source": f"modules/{mprov}-manager",
        "name": mgr.get("name", "m1"),
        **_CREDS[mprov],
    }
    if mprov == "bare-metal":
        mcfg["host"] = "192.168.0.10"
    doc.set_manager(mcfg)

    host_serial = 0
    for cl in topology.get("clusters", []):
        prov = cl.get("provider", "")
        cname = cl.get("name", "")
        shape = PROVIDER_SHAPES.get(prov)
        if shape is None:
            raise DagSpecError(
                f"unknown cluster provider {prov!r} "
                f"(choices: {sorted(PROVIDER_SHAPES)})")
        family = shape["family"]
        if family == "rancher":
            ckey = doc.add_cluster(prov, cname, {
                "source": f"modules/{prov}-k8s", "name": cname,
                **_manager_refs(), **_CREDS[prov],
            })
            for hostname in cl.get("nodes", []):
                host_serial += 1
                hcfg: Dict[str, Any] = {
                    "source": f"modules/{prov}-k8s-host",
                    "hostname": hostname,
                    "rancher_host_labels": {"worker": True},
                    "rancher_cluster_registration_token":
                        f"${{module.{ckey}.registration_token}}",
                    "rancher_cluster_ca_checksum":
                        f"${{module.{ckey}.ca_checksum}}",
                    **_CREDS[prov],
                }
                if prov == "bare-metal":
                    hcfg["host"] = _host_ip(host_serial)
                if prov == "vsphere":
                    hcfg["vsphere_template_name"] = "ubuntu-tpl"
                doc.add_node(ckey, hostname, hcfg)
        elif family == "hosted":
            doc.add_cluster(prov, cname, {
                "source": f"modules/{prov}-k8s", "name": cname,
                "node_count": int(cl.get("node_count", 1)),
                **_manager_refs(), **_CREDS[prov],
            })
        elif family == "gpu":
            ckey = doc.add_cluster(prov, cname, {
                "source": "modules/gcp-gpu-k8s", "name": cname,
                **_manager_refs(), **_CREDS[prov],
            })
            pools = cl.get("pools", [])
            pool_keys: Dict[str, str] = {}
            pool_accels: Dict[str, str] = {}
            for pool in pools:
                pname = pool.get("name", "")
                pool_accels[pname] = pool.get("accelerator",
                                              DEFAULT_ACCELERATOR)
                pool_keys[pname] = doc.add_node(ckey, pname, {
                    "source": "modules/gcp-gpu-nodepool",
                    "pool_name": pname,
                    "gke_cluster_name": cname,
                    "cluster_id": f"${{module.{ckey}.cluster_id}}",
                    "gpu_accelerator": pool_accels[pname],
                    "spot": True,
                    **_CREDS["gcp-gpu"],
                })
            for job in cl.get("jobsets", []):
                jname = job.get("name", "")
                pname = job.get("pool", "")
                if pname not in pool_keys:
                    raise DagSpecError(
                        f"jobset {jname!r} names pool {pname!r} which "
                        f"cluster {cname!r} does not declare")
                pkey = pool_keys[pname]
                doc.set(f"module.job_{cname}_{jname}", {
                    "source": "modules/gpu-jobset",
                    "job_name": jname,
                    "cluster_id": f"${{module.{ckey}.cluster_id}}",
                    # The jobset sizes itself (num_workers) from the
                    # accelerator of the pool it is pinned to.
                    "gpu_accelerator": pool_accels[pname],
                    "slice_id": f"${{module.{pkey}.slice_id}}",
                })
    return doc


def gpu_pools(topology: Dict[str, Any]) -> List[Dict[str, str]]:
    """Every GPU pool a topology declares, as ``{cluster, pool, slice_id,
    accelerator}`` rows (pool-id naming contract: ``<cluster>-<pool>``,
    modules/gcp_gpu.py) -- the role of the reference's ``tpu_slices``. The
    accelerator rides along so consumers verify repaired labels against
    the pool's REAL shape, not an assumed one."""
    out: List[Dict[str, str]] = []
    for cl in topology.get("clusters", []):
        if PROVIDER_SHAPES.get(cl.get("provider", ""), {}).get("family") \
                != "gpu":
            continue
        for pool in cl.get("pools", []):
            out.append({"cluster": cl["name"], "pool": pool["name"],
                        "slice_id": f"{cl['name']}-{pool['name']}",
                        "accelerator": pool.get("accelerator",
                                                DEFAULT_ACCELERATOR)})
    return out
