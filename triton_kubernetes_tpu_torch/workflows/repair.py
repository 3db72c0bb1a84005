"""Pool repair: the port's ``repair_slice_auto``, the programmatic path of
the reference's ``repair slice`` (``workflows/repair.py``) for a GPU pool.

On a GPU fleet the unit that dies together is the pool: its hosts form
one JobSet world (``topology/jobset.py``), so a spot reclaim of one host
ends the world exactly as a slice reclaim does on a TPU fleet. The loop
is the reference's: detect the preempted pool from the driver's cloud
state, cordon the surviving node objects, destroy + re-apply the pool's
module with its identical config, then verify that the replacement's
hosts carry the exact labels the scheduler was promised -- pool id,
worker id, worker count, GPUs a host
(``topology/labels.host_labels_for_pool``), in place of the reference's
ICI coordinates. The reference's interactive ``repair node``/``repair
slice`` verbs (prompts, ``--set`` overrides) are not ported; this is
what the operator's ``replace-preempted-slice`` rule calls, with the
same selection errors and typed exceptions.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..executor.cloudsim import CloudSimulator
from ..executor.engine import load_executor_state, save_executor_state
from ..state import parse_cluster_key
from ..topology.gpus import GpuPoolSpec
from ..topology.labels import verify_pool_labels
from ..utils import metrics


class WorkflowError(RuntimeError):
    pass


class NoPreemptedSlicesError(WorkflowError):
    """The driver's cloud state records no preempted GPU pool."""


def _counted_repair(kind: str, fn: Callable[[], str]) -> str:
    """Run a repair and record its outcome (``tk8s_repairs_total{kind,
    outcome}``): ``ok`` on success, ``failed`` on any error -- including
    the typed nothing-to-repair case, which an alerting rule watching
    repair failures should see."""
    try:
        result = fn()
    except BaseException:
        metrics.counter("tk8s_repairs_total").inc(kind=kind,
                                                  outcome="failed")
        raise
    metrics.counter("tk8s_repairs_total").inc(
        kind=kind, outcome="ok" if result else "aborted")
    return result


def repair_slice_auto(backend, executor, manager: str, cluster: str,
                      slice_id: str = "") -> str:
    """Replace a preempted GPU pool of ``cluster`` and restore its labels;
    returns the pool's module key. ``slice_id`` (``<cluster>-<pool>``)
    names the pool; empty auto-targets the one preempted pool. Raises
    :class:`NoPreemptedSlicesError` when nothing is preempted and
    :class:`WorkflowError` for every other refusal."""
    return _counted_repair("slice", lambda: _repair_slice(
        backend, executor, manager, cluster, slice_id))


def _select(backend, manager: str, cluster: str):
    """The reference's non-interactive manager and cluster selection, with
    its error strings."""
    states = backend.states()
    if not states:
        raise WorkflowError("No cluster managers.")
    if manager not in states:
        raise WorkflowError(
            f"Selected cluster manager '{manager}' does not exist.")
    state = backend.state(manager)
    clusters = state.clusters()
    if not clusters:
        raise WorkflowError("No clusters.")
    if cluster not in clusters:
        raise WorkflowError(f"A cluster named '{cluster}', does not exist.")
    return state, clusters[cluster]


def _repair_slice(backend, executor, manager: str, cluster: str,
                  slice_id: str) -> str:
    """Detect -> cordon -> replace -> verify, against the driver's
    persisted cloud state. The replacement re-applies the pool module's
    IDENTICAL config, so the pool comes back with the same pool id,
    accelerator and per-host labels."""
    state, cluster_key = _select(backend, manager, cluster)
    state.set_backend_config(backend.executor_backend_config(manager))
    nodes = state.nodes(cluster_key)  # pool name -> module key
    _, cluster_name = parse_cluster_key(cluster_key)
    view = executor.cloud_view(state)
    # Filter on cluster AND pool: sibling clusters reuse default pool
    # names ("pool0"), and a preemption over there must never churn this
    # cluster's healthy pool.
    preempted = {
        sid: info for sid, info in view.preempted_slices().items()
        if info["cluster"] == cluster_name and info["pool"] in nodes
    }
    slice_id = _pick_preempted(slice_id, preempted)
    if slice_id in preempted:
        pool_name = preempted[slice_id]["pool"]
    else:
        # A named pool the state does not record as preempted.
        pool_name = next((p for p in nodes
                          if f"{cluster_name}-{p}" == slice_id), None)
        if pool_name is None:
            raise WorkflowError(
                f"Slice '{slice_id}' does not match any pool of cluster "
                f"'{cluster_name}'.")
    pool_key = nodes[pool_name]

    # Cordon the stale node objects before teardown: nothing new may
    # schedule onto a half-dead pool while it is being replaced.
    est = load_executor_state(state)
    sim = CloudSimulator(est.cloud)
    sim.cordon_slice(slice_id)
    est.cloud = sim.to_dict()
    save_executor_state(state, est)

    # Replace: same module config (a repair is a replacement).
    pool_cfg = dict(state.get(f"module.{pool_key}"))
    executor.destroy(state, targets=[pool_key])
    state.delete(f"module.{pool_key}")
    backend.persist(state)
    state.set(f"module.{pool_key}", pool_cfg)
    executor.apply(state)
    backend.persist(state)

    # Verify the restored labels from the replacement's nodes.
    spec = GpuPoolSpec.from_accelerator(pool_cfg["gpu_accelerator"])
    gke = executor.cloud_view(state).get_resource("gke_cluster",
                                                  cluster_name)
    pool = (gke or {}).get("node_pools", {}).get(pool_name, {})
    labels = [n.get("labels", {}) for n in pool.get("nodes", [])]
    problems = verify_pool_labels(labels, spec, slice_id)
    if problems:
        raise WorkflowError(
            "pool replacement came back with wrong labels: "
            + "; ".join(problems))
    return pool_key


def _pick_preempted(slice_id: str, preempted: Dict[str, Dict]) -> str:
    """The named pool, else the one preempted pool."""
    if slice_id:
        return slice_id
    if not preempted:
        raise NoPreemptedSlicesError(
            "No preempted GPU pools detected — name one with "
            "slice_id=<cluster>-<pool> if you want to replace it anyway.")
    if len(preempted) == 1:
        return next(iter(preempted))
    raise WorkflowError(
        f"Multiple preempted slices: {sorted(preempted)}. Repair one "
        "at a time with slice_id=<id>.")
