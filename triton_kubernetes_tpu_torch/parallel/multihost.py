"""Multi-process training: the hybrid mesh, per-process batch rows, the
fused gradient exchange, coordinated checkpoints, a local launcher and,
over it, the elastic-restart storyline and the goodput harness -- the
port of ``triton_kubernetes_tpu/parallel/multihost.py``.

In the port one process drives one device, and ranks meet through
``torch.distributed``: gloo for ``cpu``, NCCL for ``cuda``. The reference's
``enable_cpu_collectives`` has no counterpart: the backend follows the
device, and nothing falls back from NCCL to gloo or from a card to the CPU.
Every axis of the mesh may span processes -- FSDP and tensor shards live on
different ranks -- where the reference keeps its ICI axes inside a
process and only ``data``/``stage`` across; so the coordinated checkpoint
gathers sharded leaves to its writer (:class:`CoordinatedCheckpoint`).

Environments that cannot host cross-process collectives raise
:class:`MultiHostUnavailable` with a bounded ``reason`` slug (the
reference's, plus ``no-nccl``, ``ranks-share-a-card`` -- more NCCL ranks
than cards: two NCCL ranks cannot share one device -- and
``no-world-size``); the trainer turns it into ``EXIT_UNSUPPORTED``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import COORDINATOR_PORT, EXIT_UNSUPPORTED  # noqa: F401
from .mesh import (AXIS_DATA, AXIS_FSDP, AXIS_STAGE, MESH_AXES, Mesh,
                   MeshConfig, create_mesh)
from .sharding import local_shape, local_slices, spec_axes

REASON_NO_DISTRIBUTED = "no-jax-distributed"
REASON_NO_CPU_COLLECTIVES = "no-cpu-collectives"
REASON_NO_COLLECTIVES_FLAG = "no-cpu-collectives-flag"
REASON_NO_PROCESS_ARRAY = "no-process-local-array-api"
REASON_HOST_CEILING = "host-parallel-ceiling"
# The port's own: a card without NCCL, more NCCL ranks than cards, a world
# size nobody gave, and a fleet shape that asks a process for more than one
# device.
REASON_NO_NCCL = "no-nccl"
REASON_RANKS_SHARE_CARD = "ranks-share-a-card"
REASON_NO_WORLD_SIZE = "no-world-size"
REASON_DEVICES_PER_PROCESS = "one-device-per-process"


class MultiHostUnavailable(RuntimeError):
    """This environment cannot run the multi-process harness. Carries a
    bounded ``reason`` slug so skips are typed and greppable."""

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


class MeshPlacementError(ValueError):
    """A mesh request the fleet cannot hold, or a batch that does not
    divide across processes."""


# --------------------------------------------------------------- capability

def backend_for(device_type: str) -> str:
    """The collectives backend of a device type: gloo for the CPU, NCCL
    for the card."""
    return "nccl" if device_type == "cuda" else "gloo"


def support_report(device_type: str = "cpu",
                   n_processes: int = 1) -> Dict[str, Any]:
    """What this torch can do for ``device_type`` with ``n_processes``
    ranks on this machine, without initializing anything. Keys: ``ok``
    plus a ``reason`` slug when not ok. A CUDA rank owns one card: NCCL
    refuses two ranks on one device, so a world wider than the cards here
    is ``ranks-share-a-card``."""
    import torch.distributed as dist

    if not dist.is_available():
        return {"ok": False, "reason": REASON_NO_DISTRIBUTED,
                "detail": f"torch {torch.__version__} has no "
                          f"torch.distributed"}
    if device_type == "cuda":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            return {"ok": False, "reason": REASON_NO_NCCL,
                    "detail": "no CUDA device with NCCL here; a CUDA run "
                              "does not fall back to gloo or the CPU"}
        cards = torch.cuda.device_count()
        if n_processes > cards:
            return {"ok": False, "reason": REASON_RANKS_SHARE_CARD,
                    "detail": f"{n_processes} NCCL ranks on {cards} "
                              f"card(s): each rank needs a card of its own "
                              f"(NCCL refuses two ranks on one device)"}
        return {"ok": True, "reason": "",
                "detail": f"torch {torch.__version__} with NCCL"}
    if not dist.is_gloo_available():
        return {"ok": False, "reason": REASON_NO_CPU_COLLECTIVES,
                "detail": "torch has no gloo backend; cross-process CPU "
                          "programs cannot run"}
    return {"ok": True, "reason": "",
            "detail": f"torch {torch.__version__} with gloo CPU collectives"}


def require_multihost(device_type: str = "cpu",
                      n_processes: int = 1) -> None:
    """Raise :class:`MultiHostUnavailable` (typed reason) unless this
    environment can run cross-process collectives on ``device_type`` for
    ``n_processes`` local ranks."""
    rep = support_report(device_type, n_processes)
    if not rep["ok"]:
        raise MultiHostUnavailable(rep["detail"], rep["reason"])


def _world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_index() -> int:
    return _world()[0]


def process_count() -> int:
    return _world()[1]


# ------------------------------------------------------------- hybrid mesh

def create_hybrid_mesh(config: Optional[MeshConfig] = None,
                       world: Optional[int] = None,
                       device_type: str = "cuda") -> Mesh:
    """The mesh over every process (one device each). The reference
    confines its ICI axes to one process's devices; here a process is one
    device, so every axis spans processes and the only placement error is
    a mesh the fleet does not hold (:class:`MeshPlacementError`)."""
    try:
        return create_mesh(config or MeshConfig(), world, device_type)
    except ValueError as e:
        raise MeshPlacementError(
            f"{e} (the port runs one device a process: the mesh's product "
            f"is the process count)") from e


def default_mesh_config(base: MeshConfig,
                        n_processes: Optional[int] = None) -> MeshConfig:
    """The multi-process default: a ``data`` of 0 means "auto", the
    processes the other axes leave (the process count when they are all
    1, as in the reference); explicit values are checked against the
    fleet by :func:`create_hybrid_mesh`."""
    n = n_processes if n_processes is not None else process_count()
    data = base.data
    if not data:
        fixed = 1
        for size in (base.stage, base.fsdp, base.seq, base.expert,
                     base.tensor):
            fixed *= max(size, 1)
        data = max(n // fixed, 1)
    return MeshConfig(data=data, stage=base.stage, fsdp=base.fsdp,
                      seq=base.seq, expert=base.expert, tensor=base.tensor)


# ----------------------------------------------- fused DCN gradient sync

def supports_fused_dcn(mesh: Mesh) -> bool:
    """True when ``mesh`` is pure data parallelism (every non-``data``
    axis is 1) -- the layout :func:`make_fused_dcn_step` handles."""
    return all(mesh.shape[a] == 1 for a in MESH_AXES if a != AXIS_DATA)


def make_fused_dcn_step(config: Any, mesh: Mesh, optimizer: Any):
    """A data-parallel train step that exchanges gradients ONCE per step:
    each rank computes its gradients on its own rows (the one-device loss
    and backward), the gradients and the loss and aux metrics are packed
    into one flat f32 buffer, one ``all_reduce`` crosses the ``data``
    axis, the buffer is divided by ``n_data``, and every rank applies the
    same update to its replica. The loss is the mean of the ranks'
    per-shard means, the global mean when shards are equal (the trainer
    checks ``batch % (data * fsdp) == 0``). Raises
    :class:`MeshPlacementError` on meshes with sharded non-data axes."""
    from ..models import llama
    from ..train.trainer import TrainState, _check_model, _tokens, loss_fn
    from .collectives import all_reduce_sum

    if not supports_fused_dcn(mesh):
        raise MeshPlacementError(
            f"fused DCN sync needs a pure data-parallel mesh (every "
            f"non-data axis 1), got {dict(mesh.shape)}; sharded "
            f"params/activations must use the sharded step")
    n_data = mesh.shape[AXIS_DATA]

    def step(state: TrainState, batch: Dict[str, Any]):
        model = state.model
        _check_model(model, config)
        if model.mesh is not None:
            raise ValueError("the fused step trains a replica: build the "
                             "state without a mesh")
        params = list(model.parameters())
        for p in params:
            p.grad = None
        attn = llama.resolve_attention(config, model.device)
        total, metrics = loss_fn(model, _tokens(batch, model.device),
                                 config, attn)
        total.backward()
        packed = torch.cat(
            [(p.grad if p.grad is not None else torch.zeros_like(p))
             .reshape(-1) for p in params]
            + [torch.stack([metrics["loss"].float(),
                            metrics["aux_loss"].float()])])
        # The one crossing: gradients and metrics in a single buffer.
        packed = all_reduce_sum(packed, mesh, (AXIS_DATA,)) / n_data
        grads, off = [], 0
        for p in params:
            grads.append(packed[off:off + p.numel()].view_as(p))
            off += p.numel()
        metrics = {"loss": packed[-2], "aux_loss": packed[-1],
                   "grad_norm": optimizer.update(params, grads,
                                                 state.opt_state)}
        state.step += 1
        return state, metrics

    return step


# ------------------------------------------------- per-process data sharding

def process_batch_bounds(global_batch: int,
                         process_index_: Optional[int] = None,
                         num_processes: Optional[int] = None
                         ) -> Tuple[int, int]:
    """[lo, hi) rows of the global batch this process owns when the batch
    splits across all processes, process-major."""
    rank, world = _world()
    p = process_index_ if process_index_ is not None else rank
    n = num_processes if num_processes is not None else world
    if n < 1 or not 0 <= p < n:
        raise MeshPlacementError(
            f"process_index {p} out of range for {n} processes")
    if global_batch % n:
        raise MeshPlacementError(
            f"global batch {global_batch} must divide across {n} "
            f"processes (each host feeds only its own shard)")
    rows = global_batch // n
    return p * rows, (p + 1) * rows


def _batch_rows(mesh: Mesh, spec: Any, global_rows: int,
                microbatches: int = 0, rank: Optional[int] = None
                ) -> np.ndarray:
    """The global rows ``rank`` holds, in the order its step takes them.

    With ``stage`` 1 that is its block of the rows under ``spec``. Under
    ``stage`` > 1 GPipe cuts the rows into ``microbatches`` (default the
    stage count) global microbatches of B / M rows, and the reference's
    stage buffer ``[M, mb, S, D]`` splits each microbatch's rows over the
    spec's axes (``P(stage, (data, fsdp), seq)``): the rank then holds its
    block of every microbatch, concatenated in microbatch order, so its
    m-th local microbatch is its share of global microbatch m."""
    m = (microbatches or mesh.shape[AXIS_STAGE]) \
        if mesh.shape[AXIS_STAGE] > 1 else 1
    if global_rows % m:
        raise MeshPlacementError(
            f"global batch {global_rows} must divide into {m} microbatches")
    mb = global_rows // m
    shards = mesh.axes_size(mesh.live_axes(spec_axes(tuple(spec)[0])))
    if m > 1 and mb % shards:
        raise MeshPlacementError(
            f"a microbatch's {mb} rows must divide into the {shards} row "
            f"shards under pipeline stages")
    sl = local_slices((mb,), tuple(spec)[:1], mesh, rank)[0]
    return np.concatenate([np.arange(i * mb + sl.start, i * mb + sl.stop)
                           for i in range(m)])


def make_batch_placer(mesh: Mesh, spec: Any = None, microbatches: int = 0
                      ) -> Callable[[Any], Any]:
    """A ``place`` function for a batch: takes one *global* host batch
    (a dict of batch-major arrays) and returns this rank's rows under
    ``spec`` (default the trainer's ``batch_spec``: rows over data and
    fsdp, data-major) -- the rows this rank's step takes. Ownership comes
    from the spec, not from process arithmetic: ranks that differ only
    along stage, seq or tensor hold the same rows. Under ``stage`` > 1
    the rows are those of the step's ``microbatches`` global microbatches
    (default the stage count, as ``make_train_step``'s), each split over
    the spec's axes as the reference's stage buffer splits them
    (:func:`_batch_rows`)."""
    if spec is None:
        spec = ((AXIS_DATA, AXIS_FSDP), None)

    def place(batch: Any) -> Any:
        return {k: np.asarray(v)[_batch_rows(mesh, spec, len(v),
                                             microbatches)]
                for k, v in batch.items()}

    return place


def local_batch_rows(mesh: Mesh, spec: Any, global_rows: int,
                     microbatches: int = 0) -> int:
    """How many batch rows THIS rank computes under ``spec``."""
    return len(_batch_rows(mesh, spec, global_rows, microbatches))


def local_full_value(leaf: Any, full_shape: Optional[Sequence[int]] = None
                     ) -> np.ndarray:
    """A leaf this rank holds whole, as a host array. With
    ``full_shape``, a block of a leaf sharded across processes raises
    :class:`MeshPlacementError`: only a gather assembles it
    (:func:`gather_full_value`)."""
    arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
           else np.asarray(leaf))
    if full_shape is not None and tuple(arr.shape) != tuple(full_shape):
        raise MeshPlacementError(
            f"leaf block {arr.shape} of a {tuple(full_shape)} leaf is "
            f"sharded across processes: gather it (gather_full_value)")
    return arr


def local_block(leaf: np.ndarray, mesh: Mesh, spec: Any,
                rank: Optional[int] = None) -> np.ndarray:
    """This rank's block of a full host array under ``spec`` -- the
    inverse of :func:`gather_full_value`."""
    leaf = np.asarray(leaf)
    return leaf[local_slices(tuple(leaf.shape), spec, mesh, rank)]


def gather_full_value(block: Optional[torch.Tensor], shape: Sequence[int],
                      spec: Any, mesh: Mesh,
                      holders: Optional[Sequence[int]] = None
                      ) -> Optional[np.ndarray]:
    """Point to point: the full f32 value of a leaf on rank 0 (None on
    the others), from the block each rank holds under ``spec``. ``holders``
    are the ranks that hold it (default all; a layer's leaf lives on its
    stage's ranks only). Of each distinct block one holder sends -- the
    first in rank order, which is coordinate 0 of every axis the leaf is
    replicated along -- and the other ranks take no part. Rank 0 receives
    the blocks one at a time into one block-sized buffer and copies each to
    the host as it arrives, so the gather holds one block on its device
    beyond its own, whatever the world size."""
    import torch.distributed as dist

    rank, world = _world()
    if world == 1:
        return local_full_value(block, shape).astype(np.float32, copy=False)
    holders = list(range(world)) if holders is None else list(holders)
    sources: Dict[Tuple[Tuple[int, int], ...], int] = {}
    for r in holders:
        key = tuple((sl.start, sl.stop)
                    for sl in local_slices(shape, spec, mesh, r))
        sources.setdefault(key, r)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    if rank != 0:
        if rank in sources.values():
            dist.send(block.detach().to(device=device, dtype=torch.float32)
                      .contiguous(), dst=0)
        return None
    full = np.empty(tuple(shape), np.float32)
    buf = None
    for r in sources.values():
        if r == 0:
            part = block.detach().float()
        else:
            if buf is None:
                buf = torch.empty(local_shape(shape, spec, mesh),
                                  dtype=torch.float32, device=device)
            dist.recv(buf, src=r)
            part = buf
        full[local_slices(shape, spec, mesh, r)] = part.cpu().numpy()
    return full


def barrier(name: str = "") -> None:
    """Cross-process sync point (no-op single-process)."""
    import torch.distributed as dist

    del name
    if process_count() > 1:
        dist.barrier()


def _process_max(value: int) -> int:
    """Max over every process's int -- one tiny collective; every process
    must call it at the same program point."""
    import torch.distributed as dist

    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(value)], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def agree_from_rank0(value: Optional[int]) -> Optional[int]:
    """Every process's copy of rank 0's verdict (a step number or None):
    one tiny max-collective, so control flow that gates a collective
    branches the same way on every rank. Collective; non-rank-0 arguments
    are ignored; ``value`` must be >= 0."""
    if process_count() == 1:
        return value
    mine = 0
    if process_index() == 0:
        if value is not None and value < 0:
            raise ValueError(f"agree_from_rank0 needs value >= 0, "
                             f"got {value}")
        mine = 1 if value is None else int(value) + 2
    agreed = _process_max(mine)
    return None if agreed <= 1 else agreed - 2


# ----------------------------------------------- synced preemption agreement

class SyncedPreemptionGuard:
    """A :class:`..train.resilience.PreemptionGuard` whose ``requested``
    is a cross-process *agreement*: every read runs one tiny all-reduce
    (max over per-process flags), so all workers stop on the same step.
    Every process must read ``requested`` at identical loop positions;
    ``check_every`` thins the collectives (the read count still aligns).
    Single-process instances never build a collective."""

    def __init__(self, signals: Optional[Tuple[int, ...]] = None,
                 check_every: int = 1):
        from ..train.resilience import PreemptionGuard

        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        self._base = PreemptionGuard(signals) if signals is not None \
            else PreemptionGuard()
        self.check_every = check_every
        self._calls = 0
        self._agreed = False

    def install(self) -> "SyncedPreemptionGuard":
        self._base.install()
        return self

    def uninstall(self) -> None:
        self._base.uninstall()

    def trip(self) -> None:
        self._base.trip()

    @property
    def signum(self):
        return self._base.signum

    @property
    def requested(self) -> bool:
        if self._agreed:
            return True
        if process_count() == 1:
            return self._base.requested
        self._calls += 1
        if self._calls % self.check_every:
            return False
        self._agreed = _process_max(int(self._base.requested)) > 0
        return self._agreed

    def __enter__(self) -> "SyncedPreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


# ------------------------------------------- coordinated checkpoint wrapper

def _stage_holders(mesh: Mesh, glob: str, config: Any) -> List[int]:
    """The ranks holding parameter ``glob``: a layer's, its stage's."""
    ranks = list(range(mesh.size))
    if not glob.startswith("layers."):
        return ranks
    per = config.num_layers // mesh.shape["stage"]
    stage = int(glob.split(".")[1]) // per
    return [r for r in ranks if mesh.coordinate(r)["stage"] == stage]


def _global_names(config: Any) -> List[Tuple[str, Tuple[int, ...]]]:
    from ..models.llama import _global_shapes

    return list(_global_shapes(config))


def host_tree(state: Any):
    """Collective: the state of a model built over a mesh as the
    one-device state's saved tree -- its paths, order and full shapes --
    on rank 0 (a :class:`..train.checkpoint.HostTree` of host tensors),
    None elsewhere. Leaves are gathered one at a time."""
    from ..train.checkpoint import HostTree

    model, opt = state.model, state.opt_state
    mesh, config = model.mesh, model.config
    names = [n for n, _ in model.named_parameters()]
    local = {model.layout[n][0]: i for i, n in enumerate(names)}
    params = list(model.parameters())
    leaves: List[Tuple[str, Any]] = [(".step", int(state.step))]
    groups = ((".model.", params), (".opt_state.mu.", opt.mu),
              (".opt_state.nu.", opt.nu))
    for prefix, tensors in groups:
        if prefix == ".opt_state.mu.":
            leaves.append((".opt_state.count", int(opt.count)))
        for glob, shape in _global_names(config):
            i = local.get(glob)
            spec = _spec_of(glob, mesh)
            full = gather_full_value(
                tensors[i] if i is not None else None, shape, spec, mesh,
                _stage_holders(mesh, glob, config))
            if full is not None:
                leaves.append((prefix + glob, torch.from_numpy(full)))
    return HostTree(leaves) if process_index() == 0 else None


def _spec_of(glob: str, mesh: Mesh):
    from ..models.llama import LEAF_AXES
    from .sharding import logical_to_spec

    return logical_to_spec(LEAF_AXES[glob.rsplit(".", 1)[-1]], mesh=mesh)


def host_template(state: Any):
    """The host tree a restore reads into: the one-device state's paths,
    full shapes and dtypes."""
    from ..train.checkpoint import HostTree

    config = state.model.config
    names = _global_names(config)
    leaves: List[Tuple[str, Any]] = [(".step", 0)]
    leaves += [(f".model.{n}", np.zeros(s, np.float32)) for n, s in names]
    leaves.append((".opt_state.count", 0))
    for prefix in (".opt_state.mu.", ".opt_state.nu."):
        leaves += [(prefix + n, np.zeros(s, np.float32)) for n, s in names]
    return HostTree(leaves)


def place_host_tree(host: Any, state: Any) -> Any:
    """Copy this rank's blocks of a restored host tree into ``state``."""
    model, opt = state.model, state.opt_state
    values = dict(host.leaves)
    with torch.no_grad():
        for i, (name, p) in enumerate(model.named_parameters()):
            glob, shape, spec = model.layout[name]
            sl = local_slices(shape, spec, model.mesh)
            for prefix, t in ((".model.", p), (".opt_state.mu.", opt.mu[i]),
                              (".opt_state.nu.", opt.nu[i])):
                t.copy_(torch.from_numpy(
                    np.ascontiguousarray(values[prefix + glob][sl])))
    state.step = int(values[".step"])
    opt.count = int(values[".opt_state.count"])
    return state


class CoordinatedCheckpoint:
    """Single-writer checkpoint coordination over a
    :class:`..train.checkpoint.CheckpointManager`, in the reference's
    format: rank 0 writes a full host tree (the one-device state's paths,
    so a save at one world size restores at another), every rank barriers
    on the commit, restores read the same files on every rank.

    The port **differs** from the reference here: the reference's DCN axes
    carry only replicated state, so its process 0 holds every byte. A port
    process is one device, and FSDP, tensor and stage shards live on
    different ranks, so rank 0 assembles each leaf from one holder of each
    of its blocks (:func:`gather_full_value`), one leaf at a time, before
    the manager writes: the gather adds one block to rank 0's device
    memory, and rank 0's host holds the full tree, as the reference's
    process 0 does. A restore reads the full tree and re-slices each leaf
    on every rank. Coordinated saves are synchronous (the barrier is the commit
    point). A state built without a mesh (a replica) saves as it is."""

    def __init__(self, mgr: Any):
        self._mgr = mgr
        self._rank0 = process_index() == 0

    @property
    def directory(self) -> str:
        return self._mgr.directory

    @property
    def last_restored_step(self):
        return self._mgr.last_restored_step

    @property
    def save_stats(self):
        return self._mgr.save_stats

    @property
    def restore_stats(self):
        return self._mgr.restore_stats

    def _fresh(self):
        if not self._rank0:
            self._mgr.reload()
        return self._mgr

    def latest_step(self):
        """Rank 0's answer on every rank (one tiny collective: call in
        lockstep)."""
        return agree_from_rank0(
            self._mgr.latest_step() if self._rank0 else None)

    def all_steps(self):
        return self._fresh().all_steps()

    def latest_verified_step(self):
        return agree_from_rank0(
            self._mgr.latest_verified_step() if self._rank0 else None)

    def manifest(self, step: int):
        return self._fresh().manifest(step)

    def _check_fits(self, manifest: Dict[str, Any], state_like: Any) -> None:
        self._mgr._check_fits(manifest, self._tree_like(state_like))

    def verify_step(self, step: int) -> None:
        """Per rank (not through rank 0): a resume's candidate loop is not
        lockstep, and rank 0 may quarantine a candidate a slower peer has
        not scanned yet."""
        from ..train.checkpoint import CheckpointIntegrityError

        try:
            self._mgr.verify_step(step)
        except CheckpointIntegrityError:
            raise
        except OSError as e:
            raise CheckpointIntegrityError(
                f"step {step} vanished mid-verify "
                f"(quarantined by the writer rank): {e}",
                reason="missing-step") from e

    def quarantine(self, step: int, reason: str = "corrupt") -> str:
        if self._rank0:
            return self._mgr.quarantine(step, reason)
        return f"(quarantined by rank 0: step {step}, {reason})"

    @staticmethod
    def _sharded(state: Any) -> bool:
        return getattr(getattr(state, "model", None), "mesh", None) \
            is not None

    def _tree_like(self, state: Any) -> Any:
        return host_template(state) if self._sharded(state) else state

    def save(self, step: int, state: Any, wait: bool = True,
             kind: str = "scheduled") -> None:
        del wait  # coordinated saves are always synchronous
        host = host_tree(state) if self._sharded(state) else state
        if self._rank0:
            # The commit barrier is reached even when the write fails:
            # peers unblock, THEN rank 0 re-raises.
            try:
                self._mgr.save(step, host, wait=True, kind=kind)
            finally:
                self.barrier(f"ckpt-save-{kind}-{step}")
            return
        self.barrier(f"ckpt-save-{kind}-{step}")

    def restore(self, state_like: Any, step: Optional[int] = None,
                verify: bool = True) -> Any:
        template = self._tree_like(state_like)
        self.barrier(f"ckpt-restore-enter-{step}")
        if self._rank0:
            # Rank 0 decides (and quarantines) first; the barrier orders
            # its renames before any other rank reads.
            try:
                host = self._mgr.restore(template, step=step, verify=verify)
            finally:
                self.barrier(f"ckpt-restore-decided-{step}")
        else:
            self.barrier(f"ckpt-restore-decided-{step}")
            self._mgr.reload()
            host = self._mgr.restore(template, step=step, verify=False)
        if self._sharded(state_like):
            return place_host_tree(host, state_like)
        return host

    def barrier(self, name: str) -> None:
        barrier(f"tk8s-{name}")

    def close(self) -> None:
        self._mgr.close()


# ------------------------------------------------------------ local launcher

def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def pick_coordinator_port(tag: str = "") -> int:
    """Deterministic coordinator port for a local run: the coordinator
    port plus a stable offset derived from ``tag``, advanced past any port
    already in use."""
    base = COORDINATOR_PORT + 1 + (zlib.crc32(tag.encode()) % 2000)
    for port in range(base, base + 100):
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError(f"no free coordinator port in [{base}, {base + 100})")


@dataclass
class WorkerExit:
    """One worker's outcome: its log file is the rank-tagged record
    (worker-N.log), its tail inlined for failure triage."""

    process_id: int
    returncode: int
    log_path: str
    tail: str = ""


@dataclass
class LaunchReport:
    returncodes: List[int] = field(default_factory=list)
    workers: List[WorkerExit] = field(default_factory=list)
    wall_seconds: float = 0.0
    killed: bool = False           # the preempt plan fired
    report: Optional[Dict[str, Any]] = None  # rank 0's --report-json

    @property
    def ok(self) -> bool:
        return all(rc == 0 for rc in self.returncodes)


def worker_env(process_id: int, n_processes: int, port: int,
               extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment one local worker runs under: the variables the
    JobSet injects (``topology/jobset.py``), one intra-op thread, and the
    repository on ``PYTHONPATH``. A port process drives one device (the
    reference's ``devices_per_process`` is always 1 here)."""
    env = dict(os.environ)
    env.update({
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "TPU_WORKER_ID": str(process_id),
        "NUM_TPU_WORKERS": str(n_processes),
        "OMP_NUM_THREADS": "1",
        "OPENBLAS_NUM_THREADS": "1",
        "PYTHONPATH": _repo_root() + os.pathsep + env.get("PYTHONPATH", ""),
    })
    env.update(extra or {})
    return env


def _pin_to_core(core: int) -> Optional[Callable[[], None]]:
    if not hasattr(os, "sched_setaffinity"):
        return None

    def pin() -> None:
        try:
            os.sched_setaffinity(0, {core})
        except OSError:
            pass  # containers may deny affinity; run unpinned

    return pin


def _tail(path: str, n: int = 20) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return ""


def _device_type_of(args: Sequence[str]) -> str:
    args = list(args)
    for i, a in enumerate(args):
        if a == "--device" and i + 1 < len(args):
            return torch.device(args[i + 1]).type
        if a.startswith("--device="):
            return torch.device(a.split("=", 1)[1]).type
    return "cuda"


def require_one_device_per_process(devices_per_process: int) -> None:
    """A port process drives one device (``cuda:rank``, or the CPU):
    anything else is :class:`MultiHostUnavailable`, reason
    ``one-device-per-process``."""
    if devices_per_process != 1:
        raise MultiHostUnavailable(
            f"devices_per_process={devices_per_process}: a process of the "
            f"port drives one device; give a fleet of N devices as "
            f"n_processes=N", REASON_DEVICES_PER_PROCESS)


def launch_trainers(trainer_args: Sequence[str], *, n_processes: int = 2,
                    run_dir: str,
                    tag: str = "", port: Optional[int] = None,
                    env_extra: Optional[Dict[str, str]] = None,
                    timeout: float = 600.0, pin_cores: bool = True,
                    preempt_after_marker: Optional[str] = None,
                    preempt_grace: float = 120.0,
                    report_json: bool = True) -> LaunchReport:
    """Run the trainer as ``n_processes`` local workers and wait.

    Every worker runs ``python -m triton_kubernetes_tpu_torch.train
    <trainer_args> --distributed on`` under :func:`worker_env`; its output
    lands in ``run_dir/worker-N.log``. A worker that dies while its peers
    run gets the peers killed at once (they would wait in a collective
    the dead rank never joins); ``TK8S_TEST_CRASH_RANK`` in ``env_extra``
    makes that rank exit at startup. ``preempt_after_marker``: once the
    string appears in worker 0's log, SIGTERM goes to every worker;
    stragglers are killed after ``preempt_grace``.

    Raises :class:`MultiHostUnavailable` when the environment cannot host
    the run (gloo for ``--device cpu``, NCCL and a card a rank
    otherwise)."""
    require_multihost(_device_type_of(trainer_args), n_processes)
    os.makedirs(run_dir, exist_ok=True)
    port = port if port is not None else pick_coordinator_port(tag or run_dir)
    n_cores = os.cpu_count() or 1
    report_path = os.path.join(run_dir, "report.json")
    args = list(trainer_args) + ["--distributed", "on"]
    if report_json and "--report-json" not in args:
        args += ["--report-json", report_path]

    procs: List[subprocess.Popen] = []
    logs: List[str] = []
    t0 = time.perf_counter()
    killed = False
    try:
        for i in range(n_processes):
            log_path = os.path.join(run_dir, f"worker-{i}.log")
            logs.append(log_path)
            env = worker_env(i, n_processes, port, env_extra)
            preexec = _pin_to_core(i % n_cores) if pin_cores else None
            with open(log_path, "w") as log_f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "triton_kubernetes_tpu_torch.train",
                     *args],
                    cwd=_repo_root(), env=env, stdout=log_f,
                    stderr=subprocess.STDOUT, preexec_fn=preexec))
        deadline = t0 + timeout
        deliver_kill = preempt_after_marker is not None
        log_offset = 0
        log_carry = ""
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs):
                break
            if not killed and any(rc not in (None, 0) for rc in rcs):
                # A worker died while peers still run: reap them now.
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
                break
            if any(rc == 0 for rc in rcs):
                deliver_kill = False  # run is ending cleanly: no kill
            if time.perf_counter() >= deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
                break
            if deliver_kill and not killed:
                try:
                    with open(logs[0], errors="replace") as f:
                        f.seek(log_offset)
                        chunk = f.read()
                        log_offset = f.tell()
                except OSError:
                    chunk = ""
                window = log_carry + chunk
                if preempt_after_marker in window:
                    for p in procs:
                        if p.poll() is None:
                            p.send_signal(signal.SIGTERM)
                    killed = True
                    deadline = time.perf_counter() + preempt_grace
                else:
                    keep = len(preempt_after_marker) - 1
                    log_carry = window[-keep:] if keep > 0 else ""
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    wall = time.perf_counter() - t0
    workers = [WorkerExit(i, p.returncode, logs[i], _tail(logs[i]))
               for i, p in enumerate(procs)]
    report = None
    if os.path.exists(report_path):
        try:
            with open(report_path) as f:
                report = json.load(f)
        except ValueError:
            report = None
    return LaunchReport(
        returncodes=[p.returncode for p in procs], workers=workers,
        wall_seconds=wall, killed=killed, report=report)


# ------------------------------------------------------- elastic restart

@dataclass
class ElasticPhase:
    """One fleet shape in an elastic restart storyline: how many worker
    processes (and devices each: always 1 in the port), plus per-phase
    trainer-arg overrides (e.g. a larger ``--steps`` target) and an
    optional preemption marker ending the phase early."""

    n_processes: int
    devices_per_process: int = 1
    extra_args: Sequence[str] = ()
    preempt_after_marker: Optional[str] = None
    preempt_grace: float = 120.0


def elastic_restart(
    trainer_args: Sequence[str],
    *,
    phases: Sequence[ElasticPhase],
    run_dir: str,
    tag: str = "",
    timeout: float = 600.0,
    env_extra: Optional[Dict[str, str]] = None,
    pin_cores: bool = True,
) -> List[LaunchReport]:
    """Run the trainer through a sequence of differently-sized fleets --
    the 4 -> 2 -> 4 storyline as one call.

    Phase 0 launches fresh; every later phase appends ``--resume
    --elastic`` so the restart negotiates its mesh from the newest
    manifest's recorded shape instead of its flags (the trainer args must
    therefore carry ``--checkpoint-dir``/``--emergency-dir``): the model
    axes are kept and ``data`` absorbs the fleet, and the coordinated
    checkpoint's one-device tree re-slices onto the new mesh. Each phase
    gets its own ``run_dir/phase-N-PxD`` directory and coordinator port.
    Stops early when a phase neither finished nor exited for resume (rc
    75). Every phase's ``devices_per_process`` is checked before the first
    launch (:func:`require_one_device_per_process`)."""
    from ..train.resilience import EXIT_RESUME

    for ph in phases:
        require_one_device_per_process(ph.devices_per_process)
    reports: List[LaunchReport] = []
    for idx, ph in enumerate(phases):
        args = list(trainer_args) + list(ph.extra_args)
        if idx and "--resume" not in args:
            args.append("--resume")
        if idx and "--elastic" not in args:
            args.append("--elastic")
        phase_dir = os.path.join(
            run_dir,
            f"phase-{idx}-{ph.n_processes}x{ph.devices_per_process}")
        rep = launch_trainers(
            args, n_processes=ph.n_processes, run_dir=phase_dir, tag=f"{tag or run_dir}-p{idx}",
            env_extra=env_extra, timeout=timeout, pin_cores=pin_cores,
            preempt_after_marker=ph.preempt_after_marker,
            preempt_grace=ph.preempt_grace)
        reports.append(rep)
        if not all(rc in (0, EXIT_RESUME) for rc in rep.returncodes):
            break
    return reports


# ------------------------------------------------------------------ goodput

@dataclass
class GoodputReport:
    """Useful-steps/s including the recovery window -- the honest
    scale-out metric ("Podracer architectures", PAPERS.md section
    goodput). ``useful_steps`` counts only steps that survived into the
    final state; steps trained past the last durable checkpoint and then
    replayed after the kill are ``wasted_steps`` and still cost wall
    clock, which is what goodput charges for."""

    n_processes: int = 0
    target_steps: int = 0
    useful_steps: int = 0
    wasted_steps: int = 0
    wall_seconds: float = 0.0            # both phases + relaunch overhead
    goodput_steps_per_sec: float = 0.0   # useful_steps / wall_seconds
    raw_steps_per_sec: float = 0.0       # uninterrupted phase-2 rate
    emergency_step: Optional[int] = None
    resumed_step: Optional[int] = None
    phases: List[Dict[str, Any]] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {
            "n_processes": self.n_processes,
            "target_steps": self.target_steps,
            "useful_steps": self.useful_steps,
            "wasted_steps": self.wasted_steps,
            "wall_seconds": round(self.wall_seconds, 3),
            "goodput_steps_per_sec": round(self.goodput_steps_per_sec, 4),
            "raw_steps_per_sec": round(self.raw_steps_per_sec, 4),
            "emergency_step": self.emergency_step,
            "resumed_step": self.resumed_step,
            "phases": self.phases,
        }


def run_goodput(
    trainer_args: Sequence[str],
    *,
    n_processes: int = 2,
    devices_per_process: int = 1,
    run_dir: str,
    target_steps: int,
    kill_marker: str = "checkpoint saved",
    tag: str = "goodput",
    timeout: float = 600.0,
    env_extra: Optional[Dict[str, str]] = None,
) -> GoodputReport:
    """One kill -> emergency-checkpoint -> verified-restore -> continue
    cycle across processes, timed end to end.

    Phase 1 launches the trainers and SIGTERMs every worker once
    ``kill_marker`` appears in rank 0's log (by default the first
    scheduled checkpoint's commit, so the kill lands mid-run with durable
    progress behind it). Workers emergency-checkpoint and exit 75. Phase 2
    relaunches with ``--resume``; the trainer restores the newest
    *verified* step (the emergency save) and finishes. The clock never
    stops: recovery time, replayed steps and relaunch overhead all land in
    the denominator.

    ``trainer_args`` must NOT contain ``--resume``/``--steps``; pass
    ``target_steps`` instead. Raises :class:`MultiHostUnavailable` (typed)
    when the environment cannot host the run, or for a
    ``devices_per_process`` other than 1, and ``RuntimeError`` when a
    phase breaks protocol (wrong exit codes, no emergency checkpoint, lost
    steps)."""
    from ..train.resilience import EXIT_RESUME

    require_one_device_per_process(devices_per_process)
    base = list(trainer_args) + ["--steps", str(target_steps)]
    t0 = time.perf_counter()
    phase1 = launch_trainers(
        base, n_processes=n_processes,
        run_dir=os.path.join(run_dir, "phase1"), tag=f"{tag}-1",
        timeout=timeout, preempt_after_marker=kill_marker,
        env_extra=env_extra)
    if not phase1.killed:
        raise RuntimeError(
            f"phase 1 finished before the kill marker {kill_marker!r} "
            f"appeared -- lower --checkpoint-every or raise --steps "
            f"(rcs={phase1.returncodes})")
    if any(rc != EXIT_RESUME for rc in phase1.returncodes):
        tails = "\n".join(w.tail for w in phase1.workers
                          if w.returncode != EXIT_RESUME)
        raise RuntimeError(
            f"preempted workers must exit {EXIT_RESUME}, got "
            f"{phase1.returncodes}:\n{tails}")
    p1 = phase1.report or {}
    phase2 = launch_trainers(
        base + ["--resume"], n_processes=n_processes,
        run_dir=os.path.join(run_dir, "phase2"), tag=f"{tag}-2",
        timeout=timeout, env_extra=env_extra)
    wall = time.perf_counter() - t0
    if any(rc != 0 for rc in phase2.returncodes):
        tails = "\n".join(w.tail for w in phase2.workers if w.returncode)
        raise RuntimeError(
            f"resumed run failed (rcs={phase2.returncodes}):\n{tails}")
    p2 = phase2.report or {}
    resumed = int(p2.get("start_step", 0))
    done = resumed + int(p2.get("steps", 0))
    if done != target_steps:
        raise RuntimeError(
            f"resumed run ended at step {done}, wanted {target_steps}")
    wasted = max(int(p1.get("steps", 0)) - resumed, 0)
    return GoodputReport(
        n_processes=n_processes, target_steps=target_steps,
        useful_steps=done, wasted_steps=wasted, wall_seconds=wall,
        goodput_steps_per_sec=done / max(wall, 1e-9),
        raw_steps_per_sec=float(p2.get("steps_per_sec", 0.0)),
        emergency_step=p1.get("emergency_step"),
        resumed_step=resumed,
        phases=[
            {"phase": "preempted", "returncodes": phase1.returncodes,
             "steps": p1.get("steps"), "losses": p1.get("losses"),
             "wall_seconds": round(phase1.wall_seconds, 3)},
            {"phase": "resumed", "returncodes": phase2.returncodes,
             "steps": p2.get("steps"), "losses": p2.get("losses"),
             "wall_seconds": round(phase2.wall_seconds, 3)},
        ])
