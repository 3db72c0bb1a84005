"""JobSet and headless-service rendering for multi-host training on GPU
pools: the H100 twin of the reference's ``topology/jobset.py``.

The env contract is the one ``train/__main__.parse_distributed_env``
reads: ``JAX_COORDINATOR_ADDRESS`` (worker 0's stable DNS name through
the headless Service, the rendezvous ``tcp://host:port``), ``TPU_WORKER_ID``
from the indexed Job's completion index, ``NUM_TPU_WORKERS``. The names
are the reference's, so one contract serves both packages, and as in the
reference they count hosts: a pod a host. A host's pod is granted all of
its GPUs (``nvidia.com/gpu``) and ``GPUS_PER_HOST`` says how many; its
command starts the rank command (``python -m
triton_kubernetes_tpu_torch.train`` unless told otherwise) once a GPU
through ``parallel/host_launch.py``, so a pool of h hosts of g GPUs
trains as a world of h * g ranks, rank ``worker * g + LOCAL_RANK`` on
``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..constants import COORDINATOR_PORT
from ..constants import EXIT_RESUME as RESUME_EXIT_CODE
from .gpus import GpuPoolSpec
from .labels import selector_for_pool

DEFAULT_TRAIN_COMMAND = ["python", "-m", "triton_kubernetes_tpu_torch.train"]
# What a pod runs in front of the rank command: one rank a GPU of the host.
HOST_LAUNCH = ["python", "-m", "triton_kubernetes_tpu_torch.parallel.host_launch",
               "--"]
# The field a pod's worker id comes from: the indexed Job's completion
# index.
COMPLETION_INDEX_FIELD = (
    "metadata.annotations['batch.kubernetes.io/job-completion-index']")


def render_headless_service(name: str,
                            namespace: str = "default") -> Dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "clusterIP": "None",  # headless: DNS per pod
            "selector": {"jobset.tk8s.io/name": name},
            "ports": [{"name": "jax-coordinator", "port": COORDINATOR_PORT}],
        },
    }


def resize_jobset(
    name: str,
    spec: GpuPoolSpec,
    workers: int,
    *,
    image: str,
    command: List[str],
    namespace: str = "default",
    env: Optional[Dict[str, str]] = None,
    trace_dir: Optional[str] = None,
    slice_id: Optional[str] = None,
) -> Dict[str, Any]:
    """The Job of an elastically resized train fleet: :func:`render_jobset`
    with ``completions`` forced to ``workers``, so hostnames, coordinator
    and ``NUM_TPU_WORKERS`` follow the new count (an indexed Job's
    completions cannot change: a resize is a replace, the checkpoint
    carries the progress)."""
    if workers < 1:
        raise ValueError(f"resize_jobset: workers={workers} must be >= 1")
    return render_jobset(
        name, spec, slice_id if slice_id is not None else f"{name}-elastic",
        image, command, namespace=namespace, env=env,
        completions=workers, trace_dir=trace_dir)


def render_jobset(
    name: str,
    spec: GpuPoolSpec,
    slice_id: str,
    image: str,
    command: List[str],
    namespace: str = "default",
    env: Optional[Dict[str, str]] = None,
    completions: Optional[int] = None,
    trace_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """An indexed-Job manifest: one pod per GPU host of the pool, each
    granted the host's GPUs and running ``command`` once a GPU
    (:data:`HOST_LAUNCH`). ``trace_dir`` adds ``--trace-jsonl`` into a
    hostPath volume mounted there, so a dead worker's trace outlives its
    pod (each rank writes its own, ``.rankN``)."""
    n = completions if completions is not None else spec.num_hosts
    hostnames = ",".join(
        f"{name}-{i}.{name}.{namespace}.svc" for i in range(n))
    coordinator = f"{name}-0.{name}.{namespace}.svc:{COORDINATOR_PORT}"
    base_env = {
        "TPU_WORKER_HOSTNAMES": hostnames,
        "JAX_COORDINATOR_ADDRESS": coordinator,
        "GPUS_PER_HOST": str(spec.gpus_per_host),
        "NUM_TPU_WORKERS": str(n),
    }
    base_env.update(env or {})
    command = list(command)
    if trace_dir is not None:
        command += ["--trace-jsonl", f"{trace_dir}/trace.jsonl"]
    command = HOST_LAUNCH + command
    container = {
        "name": "worker",
        "image": image,
        "command": command,
        "env": (
            [{"name": k, "value": v} for k, v in sorted(base_env.items())]
            + [{
                # Worker id comes from the indexed-Job completion index.
                "name": "TPU_WORKER_ID",
                "valueFrom": {"fieldRef": {
                    "fieldPath": COMPLETION_INDEX_FIELD}},
            }]
        ),
        "ports": [{"containerPort": COORDINATOR_PORT}],
        "resources": {"limits": {"nvidia.com/gpu": str(spec.gpus_per_host)}},
    }
    pod_extra: Dict[str, Any] = {}
    if trace_dir is not None:
        # hostPath, not emptyDir: the pod that died is the one whose
        # ledger the postmortem needs.
        container["volumeMounts"] = [
            {"name": "tk8s-trace", "mountPath": trace_dir}]
        pod_extra["volumes"] = [
            {"name": "tk8s-trace",
             "hostPath": {"path": trace_dir,
                          "type": "DirectoryOrCreate"}}]
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": {"jobset.tk8s.io/name": name,
                       "jobset.tk8s.io/slice-id": slice_id},
        },
        "spec": {
            "completions": n,
            "parallelism": n,
            "completionMode": "Indexed",
            # Real failures fail the Job; a preemption-warned worker's
            # RESUME_EXIT_CODE after its emergency checkpoint, or a
            # disrupted pod, recreates the pod, which resumes (the command
            # must pass --resume).
            "backoffLimit": 0,
            "podFailurePolicy": {"rules": [
                {"action": "Ignore",
                 "onExitCodes": {"containerName": "worker",
                                 "operator": "In",
                                 "values": [RESUME_EXIT_CODE]}},
                {"action": "Ignore",
                 "onPodConditions": [{"type": "DisruptionTarget",
                                      "status": "True"}]},
                {"action": "FailJob",
                 "onExitCodes": {"containerName": "worker",
                                 "operator": "NotIn",
                                 "values": [RESUME_EXIT_CODE]}},
            ]},
            "template": {
                "metadata": {"labels": {"jobset.tk8s.io/name": name}},
                "spec": {
                    "subdomain": name,  # pairs with the headless service
                    "restartPolicy": "Never",
                    "nodeSelector": selector_for_pool(spec, slice_id),
                    "containers": [container],
                    **pod_extra,
                },
            },
        },
    }
