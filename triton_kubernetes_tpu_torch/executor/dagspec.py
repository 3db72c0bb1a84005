"""Spec-driven document loader: a JSON-able topology spec -> a StateDocument
of GPU pools (the port's copy of the reference's ``executor/dagspec.py``,
for the ``gcp-gpu`` provider family).

Topology spec shape (all keys JSON-able)::

    {"manager": {"provider": "bare-metal", "name": "m1"},
     "clusters": [
       {"provider": "gcp-gpu", "name": "ml",
        "pools": [{"name": "pool0", "accelerator": "h100-16"}],
        "jobsets": [{"name": "j0", "pool": "pool0"}]},
     ]}

The reference's spec names ``gcp-tpu`` clusters of TPU slices; the twin
of one is the same spec with ``gcp-gpu`` and an ``h100-*`` accelerator,
and gives the same module keys with ``gcp-gpu`` in the provider slot
(``cluster_gcp-gpu_ml``, ``node_gcp-gpu_ml_pool0``, ``job_ml_j0``). The
configs are the port's workflow configs
(``workflows/providers/gcp_gpu.py``) with canned credentials: the
simulator never validates values.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..state import StateDocument
from ..workflows.providers import gcp_gpu

PROVIDER = "gcp-gpu"
DEFAULT_ACCELERATOR = "h100-16"
_CREDS = {"gcp_path_to_credentials": "/tmp/chaos-creds.json",
          "gcp_project_id": "chaos-project"}


class DagSpecError(ValueError):
    """The topology spec is malformed (a provider other than the manager's
    ``bare-metal`` or the clusters' ``gcp-gpu``, a jobset naming a pool
    the cluster does not declare)."""


def document_from_spec(topology: Dict[str, Any], name: str,
                       driver: Optional[Dict[str, Any]] = None,
                       backend_name: Optional[str] = None,
                       backend: Optional[Dict[str, Any]] = None
                       ) -> StateDocument:
    """Materialize a topology spec into a StateDocument.

    ``driver`` (its fault plan) lands as the document's
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
    if mgr.get("provider", "bare-metal") != "bare-metal":
        raise DagSpecError(
            f"provider {mgr.get('provider')!r} has no manager module "
            f"(choices: ['bare-metal'])")
    doc.set_manager({"source": "modules/bare-metal-manager",
                     "name": mgr.get("name", "m1"), "host": "192.168.0.10"})
    for cl in topology.get("clusters", []):
        if cl.get("provider", "") != PROVIDER:
            raise DagSpecError(
                f"unknown cluster provider {cl.get('provider')!r} "
                f"(choices: [{PROVIDER!r}])")
        cname = cl.get("name", "")
        ckey = doc.add_cluster(PROVIDER, cname,
                               gcp_gpu.cluster_config(cname, **_CREDS))
        pool_keys: Dict[str, str] = {}
        for pool in cl.get("pools", []):
            pname = pool.get("name", "")
            pool_keys[pname] = doc.add_node(ckey, pname, gcp_gpu.node_config(
                ckey, pname, pool.get("accelerator", DEFAULT_ACCELERATOR),
                spot=True, **_CREDS))
        for job in cl.get("jobsets", []):
            jname, pname = job.get("name", ""), job.get("pool", "")
            if pname not in pool_keys:
                raise DagSpecError(
                    f"jobset {jname!r} names pool {pname!r} which "
                    f"cluster {cname!r} does not declare")
            pkey = pool_keys[pname]
            doc.set(f"module.job_{cname}_{jname}", gcp_gpu.jobset_config(
                ckey, pkey, doc.get(f"module.{pkey}"), jname))
    return doc


def gpu_pools(topology: Dict[str, Any]) -> List[Dict[str, str]]:
    """Every GPU pool a topology declares, as ``{cluster, pool, slice_id,
    accelerator}`` rows (pool-id naming contract: ``<cluster>-<pool>``,
    modules/gcp_gpu.py)."""
    return [{"cluster": cl["name"], "pool": pool["name"],
             "slice_id": f"{cl['name']}-{pool['name']}",
             "accelerator": pool.get("accelerator", DEFAULT_ACCELERATOR)}
            for cl in topology.get("clusters", [])
            if cl.get("provider") == PROVIDER
            for pool in cl.get("pools", [])]
