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

The same renders apply themselves through the port's executor as
registered :class:`~.base.Module` classes, the twins of the reference's
``GcpTpuCluster``, ``GcpTpuNodePool`` and ``TpuJobSet``:

* :class:`GcpGpuCluster` (``gcp-gpu-k8s``) -- the GKE control plane, its
  network and firewall, and its registration with the manager (kind
  ``gke-gpu``);
* :class:`GcpGpuNodePool` (``gcp-gpu-nodepool``) -- one GPU pool: the
  operator's unit of scaling, preemption and repair, since its hosts form
  one JobSet world;
* :class:`GpuJobSet` (``gpu-jobset``) -- the training workload's
  Service and Job.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

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
from .base import DriverContext, Module, Resource, Variable
from .registry import register

CLUSTER_SOURCE = "modules/gcp-gpu-k8s"
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


def _variables(variables: Dict[str, Any]) -> List[Variable]:
    return [Variable(k, required=True) if v is REQUIRED
            else Variable(k, default=v) for k, v in variables.items()]


# The DaemonSets a pool installs, by base name (each a per-shape variant,
# ``<base>-<machine type>-<gpus>g``).
_POOL_DAEMONSETS = ("gpu-torch-runtime", "gpu-device-plugin", "gpu-health")


@register
class GcpGpuCluster(Module):
    """GKE control plane destined for GPU node pools, imported into the
    manager (the HCL twin: ``terraform/modules/gcp-gpu-k8s``)."""

    SOURCE = CLUSTER_SOURCE
    OUTPUTS = ["cluster_id", "endpoint", "gcp_compute_network_name"]
    VARIABLES = [
        Variable("name", required=True),
        Variable("manager_url", required=True),
        Variable("manager_access_key", required=True),
        Variable("manager_secret_key", required=True),
        Variable("gcp_path_to_credentials", required=True),
        Variable("gcp_project_id", required=True),
        Variable("gcp_region", default="us-east5"),
        Variable("k8s_version", default="1.29"),
        # System pool for non-GPU pods (device-plugin controllers, CoreDNS).
        Variable("system_node_count", default=1),
        Variable("system_machine_type", default="n1-standard-4"),
    ]

    def apply(self, config: Dict[str, Any], ctx: DriverContext
              ) -> Tuple[Dict[str, Any], List[Resource]]:
        name = config["name"]
        net = f"{name}-network"
        ctx.cloud.create_resource("gcp_compute_network", net)
        # Data-centre-network firewall: SSH, HTTPS, the API server and the
        # trainers' rendezvous port (the HCL module's list).
        ctx.cloud.create_resource("gcp_compute_firewall", f"{name}-dcn",
                                  ports=[22, 443, 6443, 8476])
        hosted = ctx.cloud.create_hosted_cluster(
            "gke", name,
            project=config["gcp_project_id"],
            region=config.get("gcp_region"),
            k8s_version=config.get("k8s_version"),
            network=net,
        )
        ctx.cloud.create_node_pool(
            "gke", name, "system-pool",
            node_count=int(config.get("system_node_count", 1)),
            machine_type=config.get("system_machine_type"),
        )
        imported = ctx.cloud.create_or_get_cluster(
            config["manager_url"], name, imported=True, kind="gke-gpu")
        ctx.cloud.create_resource("cluster", imported["id"], cluster_name=name)
        resources = [Resource("gcp_compute_network", net),
                     Resource("gcp_compute_firewall", f"{name}-dcn"),
                     Resource("gke_cluster", name),
                     Resource("cluster", imported["id"])]
        return ({"cluster_id": imported["id"],
                 "endpoint": hosted["endpoint"],
                 "gcp_compute_network_name": net}, resources)


@register
class GcpGpuNodePool(Module):
    """One GPU pool as a GKE node pool: what :func:`render_gpu_nodepool`
    renders, created on the driver. One node a GPU host, each carrying
    its pool id and worker id, and the pool's three DaemonSets."""

    SOURCE = NODEPOOL_SOURCE
    OUTPUTS = list(NODEPOOL_OUTPUTS)
    VARIABLES = _variables(NODEPOOL_VARIABLES)

    def apply(self, config: Dict[str, Any], ctx: DriverContext
              ) -> Tuple[Dict[str, Any], List[Resource]]:
        rendered = render_gpu_nodepool(config)
        tf = rendered["terraform"]["resource"]["google_container_node_pool"][
            "gpu"]
        node = tf["node_config"][0]
        accel = node["guest_accelerator"][0]
        pool_name, cluster_name = tf["name"], tf["cluster"]
        pool = ctx.cloud.create_node_pool(
            "gke", cluster_name, pool_name,
            node_count=tf["node_count"],
            node_labels=rendered["node_labels"],
            machine_type=node["machine_type"],
            accelerator=accel["type"],
            gpus_per_host=accel["count"],
            placement_policy=dict(tf["placement_policy"][0]),
            reserved=bool(config.get("reserved")),
            spot=bool(node["spot"]),
            management=dict(tf["management"][0]),
        )
        cluster_id = config["cluster_id"]
        for manifest in rendered["manifests"]:
            ctx.cloud.apply_manifest(cluster_id, manifest)
        outputs = dict(rendered["outputs"],
                       node_names=[n["name"] for n in pool["nodes"]])
        return (outputs,
                [Resource("gke_node_pool", f"{cluster_name}/{pool_name}")])

    def destroy(self, applied: Dict[str, Any], ctx: DriverContext) -> None:
        cfg = applied.get("config", {})
        cluster = ctx.cloud.get_resource("gke_cluster",
                                         cfg.get("gke_cluster_name", ""))
        if cluster:
            pools = cluster.get("node_pools", {})
            pools.pop(cfg.get("pool_name", ""), None)
            # Last GPU pool gone: uninstall the pool DaemonSets too (only
            # what apply() installs, never an operator's own gpu-*
            # workloads).
            if not any(p.get("gpus_per_host") for p in pools.values()):
                cluster_id = applied.get("outputs", {}).get("cluster_id", "")
                names = [m["metadata"]["name"] for m in
                         ctx.cloud.get_manifests(cluster_id, "DaemonSet")]
                for ds in names:
                    if any(ds.startswith(base + "-")
                           for base in _POOL_DAEMONSETS):
                        ctx.cloud.delete_manifest(cluster_id, "DaemonSet", ds)
        super().destroy(applied, ctx)


@register
class GpuJobSet(Module):
    """A multi-host training workload pinned to one GPU pool: what
    :func:`render_gpu_jobset` renders, applied to the cluster."""

    SOURCE = JOBSET_SOURCE
    OUTPUTS = ["job_name", "num_workers", "coordinator"]
    VARIABLES = _variables(JOBSET_VARIABLES)

    def apply(self, config: Dict[str, Any], ctx: DriverContext
              ) -> Tuple[Dict[str, Any], List[Resource]]:
        rendered = render_gpu_jobset(config)
        cluster_id = rendered["outputs"]["cluster_id"]
        for manifest in rendered["manifests"]:
            ctx.cloud.apply_manifest(cluster_id, manifest)
        return (dict(rendered["outputs"]),
                [Resource("k8s_job", rendered["outputs"]["job_name"])])

    def destroy(self, applied: Dict[str, Any], ctx: DriverContext) -> None:
        """Remove the Job and its headless Service from the cluster."""
        out = applied.get("outputs", {})
        cluster_id = out.get("cluster_id", "")
        name = out.get("job_name") or applied.get("config", {}).get(
            "job_name", "")
        ctx.cloud.delete_manifest(cluster_id, "Job", name)
        ctx.cloud.delete_manifest(cluster_id, "Service", name)
        super().destroy(applied, ctx)
