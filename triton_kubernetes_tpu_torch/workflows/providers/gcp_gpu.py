"""Config documents of GKE GPU clusters, pools and JobSets: the H100 twin
of the reference's ``workflows/providers/gcp_tpu.py``.

The reference asks its questions through the workflow resolver and writes
the answers into the state document. These are plain functions: given the
answers, each returns the module config the reference would store (the
same keys, ``gpu_accelerator`` in place of ``tpu_accelerator`` and
``tpu_topology``, the GPU modules' sources), for the HCL modules
``gcp-gpu-k8s``, ``gcp-gpu-nodepool`` and ``gpu-jobset``. No prompts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ...modules.gcp_gpu import JOBSET_SOURCE, JOBSET_VARIABLES, \
    NODEPOOL_SOURCE
from ...topology.gpus import parse_accelerator

CLUSTER_SOURCE = "modules/gcp-gpu-k8s"


def parse_cluster_key(key: str) -> Tuple[str, str]:
    """``cluster_{provider}_{name}`` -> (provider, name), the reference's
    key scheme: a provider holds no ``_``, a name may."""
    provider, sep, name = key.removeprefix("cluster_").partition("_")
    if not key.startswith("cluster_") or not sep or not provider or not name:
        raise ValueError(f"not a cluster key: {key!r}")
    return provider, name


def cluster_config(name: str, gcp_path_to_credentials: str,
                   gcp_project_id: str, gcp_region: str = "us-east5",
                   k8s_version: str = "1.31",
                   system_node_count: int = 1) -> Dict[str, Any]:
    """A GKE control plane destined for GPU node pools (``gcp-gpu-k8s``),
    imported into the cluster manager."""
    return {
        "source": CLUSTER_SOURCE,
        "name": name,
        "manager_url": "${module.cluster-manager.manager_url}",
        "manager_access_key": "${module.cluster-manager.manager_access_key}",
        "manager_secret_key": "${module.cluster-manager.manager_secret_key}",
        "gcp_path_to_credentials": gcp_path_to_credentials,
        "gcp_project_id": gcp_project_id,
        "gcp_region": gcp_region,
        "k8s_version": k8s_version,
        "system_node_count": int(system_node_count),
    }


def node_config(cluster_key: str, pool_name: str, accelerator: str,
                gcp_path_to_credentials: str, gcp_project_id: str,
                reserved: bool = False, spot: bool = False
                ) -> Dict[str, Any]:
    """One GPU pool as a node pool (``gcp-gpu-nodepool``); the pool's name
    takes the hostname slot of the reference's key scheme. Raises
    ``ValueError`` for an accelerator no machine shape or whole hosts
    hold, as the reference fails at prompt time rather than apply time."""
    parse_accelerator(accelerator)
    cluster_name = parse_cluster_key(cluster_key)[1]
    return {
        "source": NODEPOOL_SOURCE,
        "pool_name": pool_name,
        "gke_cluster_name": cluster_name,
        "cluster_id": f"${{module.{cluster_key}.cluster_id}}",
        "gcp_path_to_credentials": gcp_path_to_credentials,
        "gcp_project_id": gcp_project_id,
        "gpu_accelerator": accelerator,
        "reserved": bool(reserved),
        "spot": bool(spot),
    }


def jobset_config(cluster_key: str, pool_key: str,
                  pool_config: Dict[str, Any], job_name: str,
                  image: Optional[str] = None,
                  command: Optional[List[str]] = None,
                  env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """A training workload attached to a provisioned pool
    (``gpu-jobset``); defaults are the module's."""
    return {
        "source": JOBSET_SOURCE,
        "job_name": job_name,
        "cluster_id": f"${{module.{cluster_key}.cluster_id}}",
        "gpu_accelerator": pool_config.get("gpu_accelerator", "h100-8"),
        "slice_id": f"${{module.{pool_key}.slice_id}}",
        "image": image or JOBSET_VARIABLES["image"],
        "command": list(command or JOBSET_VARIABLES["command"]),
        "env": dict(env or {}),
    }
