"""GKE GPU node pools and GPU JobSets: the H100 twins of the reference's
``gcp-tpu-nodepool`` and ``tpu-jobset`` modules (``modules/gcp_tpu.py``).

The reference's modules apply themselves to a cloud API through its
``Module`` registry; these are plain functions over the same config
documents that return what the HCL twins under ``terraform/modules/``
(``gcp-gpu-nodepool``, ``gpu-jobset``) create: the node pool's Terraform
JSON, the Kubernetes manifests applied beside it, and the module's
outputs.

* :func:`render_gpu_nodepool` -- one GPU pool as a GKE node pool: node
  count from the pool's hosts, each node an A3 machine with its H100s as
  a ``guest_accelerator`` (where the reference's TPU pool takes a
  ``placement_policy.tpu_topology``), labelled for the scheduler, and the
  CUDA runtime, NVIDIA device plugin and health DaemonSets.
* :func:`render_gpu_jobset` -- a training workload pinned to one pool
  (headless Service + indexed Job).
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..topology.daemonsets import (
    render_gpu_device_plugin,
    render_gpu_health_daemonset,
    render_gpu_runtime_daemonset,
)
from ..topology.gpus import GpuPoolSpec
from ..topology.jobset import (
    DEFAULT_TRAIN_COMMAND,
    render_headless_service,
    render_jobset,
)
from ..topology.labels import LABEL_PREFIX, host_labels_for_pool

NODEPOOL_SOURCE = "modules/gcp-gpu-nodepool"
JOBSET_SOURCE = "modules/gpu-jobset"
REQUIRED = object()
# name -> default (REQUIRED: the config must give it), as the HCL
# modules' variables.tf.json declare them.
NODEPOOL_VARIABLES: Dict[str, Any] = {
    "pool_name": REQUIRED,
    "gke_cluster_name": REQUIRED,
    "cluster_id": REQUIRED,
    "gcp_path_to_credentials": REQUIRED,
    "gcp_project_id": REQUIRED,
    "gcp_region": "us-east5",
    "gpu_accelerator": REQUIRED,  # e.g. "h100-16"
    "reserved": False,
    "spot": False,
    "runtime_image": "",
    "auto_repair": True,
}
NODEPOOL_OUTPUTS = ["slice_id", "num_hosts", "num_gpus", "node_names",
                    "cluster_id"]
JOBSET_VARIABLES: Dict[str, Any] = {
    "job_name": REQUIRED,
    "cluster_id": REQUIRED,
    "gpu_accelerator": REQUIRED,
    "slice_id": REQUIRED,
    "image": "tk8s/torch-cuda-runtime:0.1.0",
    "command": list(DEFAULT_TRAIN_COMMAND),
    "env": {},
    "namespace": "default",
}


def _resolved(config: Dict[str, Any],
              variables: Dict[str, Any]) -> Dict[str, Any]:
    """The config with every default filled in; raises ``ValueError``
    naming a required variable the config lacks."""
    missing = [k for k, v in variables.items()
               if v is REQUIRED and config.get(k) in (None, "")]
    if missing:
        raise ValueError(f"missing required variables: {missing}")
    return {k: config.get(k, v) for k, v in variables.items()}


def render_gpu_nodepool(config: Dict[str, Any]) -> Dict[str, Any]:
    """One GPU pool: ``{"terraform": ..., "manifests": [...], "outputs":
    {...}}`` -- the ``google_container_node_pool`` as Terraform JSON, the
    three host-software DaemonSets, and the module's outputs."""
    cfg = _resolved(config, NODEPOOL_VARIABLES)
    spec = GpuPoolSpec.from_accelerator(cfg["gpu_accelerator"])
    pool_name, cluster = cfg["pool_name"], cfg["gke_cluster_name"]
    slice_id = f"{cluster}-{pool_name}"
    pool = {
        "name": pool_name,
        "cluster": cluster,
        "location": cfg["gcp_region"],
        "node_count": spec.num_hosts,
        "placement_policy": [{"type": "COMPACT"}],
        "management": [{"auto_repair": bool(cfg["auto_repair"]),
                        "auto_upgrade": False}],
        "node_config": [{
            "machine_type": spec.machine_type,
            "spot": bool(cfg["spot"]),
            "labels": {
                f"{LABEL_PREFIX}/slice-id": slice_id,
                f"{LABEL_PREFIX}/accelerator": spec.accelerator,
                f"{LABEL_PREFIX}/gpus-per-host": str(spec.gpus_per_host),
            },
            "guest_accelerator": [{
                "type": spec.generation.gke_accelerator,
                "count": spec.gpus_per_host,
                "gpu_driver_installation_config": [
                    {"gpu_driver_version": "LATEST"}],
            }],
            "reservation_affinity": [{
                "consume_reservation_type": ("ANY_RESERVATION"
                                             if cfg["reserved"]
                                             else "NO_RESERVATION")}],
        }],
    }
    kwargs = {"image": cfg["runtime_image"]} if cfg["runtime_image"] else {}
    manifests = [render_gpu_runtime_daemonset(spec, **kwargs),
                 render_gpu_device_plugin(spec),
                 render_gpu_health_daemonset(spec, **kwargs)]
    outputs = {
        "slice_id": slice_id,
        "num_hosts": spec.num_hosts,
        "num_gpus": spec.gpus,
        "node_names": [f"{cluster}-{pool_name}-{i}"
                       for i in range(spec.num_hosts)],
        "cluster_id": cfg["cluster_id"],
    }
    return {"terraform": {"resource": {
                "google_container_node_pool": {"gpu": pool}}},
            "manifests": manifests, "outputs": outputs,
            "node_labels": host_labels_for_pool(spec, slice_id)}


def render_gpu_jobset(config: Dict[str, Any]) -> Dict[str, Any]:
    """A training workload pinned to one pool: ``{"manifests": [Service,
    Job], "outputs": {...}}``."""
    cfg = _resolved(config, JOBSET_VARIABLES)
    spec = GpuPoolSpec.from_accelerator(cfg["gpu_accelerator"])
    name = cfg["job_name"]
    svc = render_headless_service(name, cfg["namespace"])
    job = render_jobset(name, spec, cfg["slice_id"], image=cfg["image"],
                        command=list(cfg["command"] or []),
                        namespace=cfg["namespace"], env=dict(cfg["env"]))
    container = job["spec"]["template"]["spec"]["containers"][0]
    env = {e["name"]: e["value"] for e in container["env"] if "value" in e}
    return {"manifests": [svc, job], "outputs": {
        "job_name": name,
        "num_workers": spec.num_hosts,
        "coordinator": env["JAX_COORDINATOR_ADDRESS"],
        "cluster_id": cfg["cluster_id"],
    }}


def jobset_container(rendered: Dict[str, Any]) -> Dict[str, Any]:
    """The worker container of a :func:`render_gpu_jobset` rendering."""
    job: List[Dict[str, Any]] = [m for m in rendered["manifests"]
                                 if m["kind"] == "Job"]
    return job[0]["spec"]["template"]["spec"]["containers"][0]
