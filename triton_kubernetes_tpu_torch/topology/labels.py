"""Kubernetes node labels of a GPU pool: the H100 twin of the reference's
``topology/labels.py``.

Two label families land on every GPU node: GKE's own
``cloud.google.com/gke-accelerator`` (which GKE sets on GPU nodes and the
NVIDIA device plugin and schedulers read), and the port's
``gpu.tk8s.io/*``: generation, pool (slice) id, worker id, worker count
and GPUs per host. The reference's ICI coordinates (``ici-x/y/z``) and
topology label have no counterpart: a host's eight GPUs are joined all to
all by NVLink, and hosts by the data-centre network, so there is no torus
position to label.
"""

from __future__ import annotations

from typing import Dict, List

from .gpus import GpuPoolSpec

LABEL_PREFIX = "gpu.tk8s.io"
GKE_ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"


def host_labels_for_pool(spec: GpuPoolSpec,
                         slice_id: str) -> List[Dict[str, str]]:
    """Per-host label dicts for one pool, in worker-id order."""
    return [{
        GKE_ACCELERATOR_LABEL: spec.generation.gke_accelerator,
        f"{LABEL_PREFIX}/generation": spec.generation.name,
        f"{LABEL_PREFIX}/slice-id": slice_id,
        f"{LABEL_PREFIX}/worker-id": str(worker_id),
        f"{LABEL_PREFIX}/num-workers": str(spec.num_hosts),
        f"{LABEL_PREFIX}/gpus-per-host": str(spec.gpus_per_host),
    } for worker_id in range(spec.num_hosts)]


def verify_pool_labels(node_labels: List[Dict[str, str]],
                       spec: GpuPoolSpec, slice_id: str) -> List[str]:
    """Check a pool's per-host labels are the complete, ordered set
    :func:`host_labels_for_pool` emits. Returns human-readable problems;
    empty means they are exactly that."""
    expected = host_labels_for_pool(spec, slice_id)
    if len(node_labels) != len(expected):
        return [f"pool {slice_id}: {len(node_labels)} labeled hosts, "
                f"expected {len(expected)}"]
    problems: List[str] = []
    for worker_id, (got, want) in enumerate(zip(node_labels, expected)):
        for key, value in want.items():
            if got.get(key) != value:
                problems.append(
                    f"pool {slice_id} worker {worker_id}: label {key}="
                    f"{got.get(key)!r}, expected {value!r}")
    return problems


def selector_for_pool(spec: GpuPoolSpec, slice_id: str) -> Dict[str, str]:
    """nodeSelector that pins a workload to one pool, so a multi-host job
    never straddles pools."""
    return {
        GKE_ACCELERATOR_LABEL: spec.generation.gke_accelerator,
        f"{LABEL_PREFIX}/slice-id": slice_id,
    }
