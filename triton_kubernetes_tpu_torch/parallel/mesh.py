"""The six-axis device mesh -- the port of
``triton_kubernetes_tpu/parallel/mesh.py``.

Axis vocabulary, outermost (lowest bandwidth) first:

- ``data``   -- pure data parallelism (params replicated);
- ``stage``  -- pipeline stages (``train/pipeline.pipeline_forward``);
- ``fsdp``   -- fully sharded data parallelism: batch AND params sharded;
- ``seq``    -- sequence parallelism (``ops/ring_attention.py``);
- ``expert`` -- expert parallelism of an MoE layer;
- ``tensor`` -- Megatron tensor parallelism, innermost.

Unused axes have size 1. In the port one process drives one device, so a
mesh lays the ranks of a ``torch.distributed`` process group out on the
six axes, rank-major with ``tensor`` innermost: rank ``r`` sits at the
coordinates of ``r`` in a C-order array of the mesh's shape, as the
reference reshapes its device list. :func:`create_mesh` returns a
:class:`Mesh`, which holds that layout and the
``torch.distributed.device_mesh.DeviceMesh`` with the six named dims over
the group's ranks (``Mesh.device_mesh``) and hands out the process group
of any set of axes (:meth:`Mesh.group`). A mesh built without a process
group (``world`` given, nothing initialized) is layout only: its
coordinates and blocks are computed, its collectives are not available.

The device type is explicit: ``cuda`` (collectives over NCCL) unless the
caller asks for ``cpu`` (gloo). Nothing falls back from one to the other.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

AXIS_DATA = "data"
AXIS_STAGE = "stage"
AXIS_FSDP = "fsdp"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_TENSOR = "tensor"

# Outermost (lowest bandwidth) -> innermost.
MESH_AXES: Tuple[str, ...] = (
    AXIS_DATA, AXIS_STAGE, AXIS_FSDP, AXIS_SEQ, AXIS_EXPERT, AXIS_TENSOR)


@dataclass(frozen=True)
class MeshConfig:
    """Requested parallelism degrees. ``-1`` on at most one axis means
    "absorb all remaining devices" (MaxText's convention)."""

    data: int = 1
    stage: int = 1
    fsdp: int = -1
    seq: int = 1
    expert: int = 1
    tensor: int = 1

    def sizes(self) -> Dict[str, int]:
        return {
            AXIS_DATA: self.data,
            AXIS_STAGE: self.stage,
            AXIS_FSDP: self.fsdp,
            AXIS_SEQ: self.seq,
            AXIS_EXPERT: self.expert,
            AXIS_TENSOR: self.tensor,
        }

    def resolve(self, n_devices: int) -> Dict[str, int]:
        """Fill in the -1 axis and validate the product against n_devices."""
        sizes = self.sizes()
        wildcard = [a for a, s in sizes.items() if s == -1]
        if len(wildcard) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wildcard}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wildcard:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"fixed axes product {fixed} does not divide {n_devices} devices")
            sizes[wildcard[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices but {n_devices} are available")
        for axis, s in sizes.items():
            if s < 1:
                raise ValueError(f"axis {axis!r} resolved to {s}")
        return sizes


class Mesh:
    """The six named axes over the ranks ``0 .. size-1`` of a process
    group, ``rank`` this process's. ``shape`` maps every axis to its size
    (outermost first, as ``jax.sharding.Mesh.shape``)."""

    axis_names: Tuple[str, ...] = MESH_AXES

    def __init__(self, sizes: Dict[str, int], rank: int = 0,
                 device_type: str = "cuda", device_mesh=None):
        self.shape: Dict[str, int] = {a: int(sizes.get(a, 1))
                                      for a in MESH_AXES}
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.device_type = device_type
        self.device_mesh = device_mesh
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    @property
    def distributed(self) -> bool:
        """Whether collectives run: a process group is initialized."""
        import torch.distributed as dist

        return dist.is_available() and dist.is_initialized()

    def coordinate(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Each axis's index of ``rank`` (default: this process's)."""
        r = self.rank if rank is None else rank
        out: Dict[str, int] = {}
        for axis in reversed(MESH_AXES):
            out[axis] = r % self.shape[axis]
            r //= self.shape[axis]
        return {a: out[a] for a in MESH_AXES}

    def rank_of(self, coordinate: Dict[str, int]) -> int:
        r = 0
        for axis in MESH_AXES:
            r = r * self.shape[axis] + coordinate.get(axis, 0)
        return r

    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def axes_index(self, axes: Sequence[str],
                   rank: Optional[int] = None) -> int:
        """This rank's index in the flattened ``axes`` (first axis major),
        the order in which a dim sharded over several axes is split."""
        c = self.coordinate(rank)
        i = 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def group_ranks(self, axes: Sequence[str],
                    rank: Optional[int] = None) -> List[int]:
        """The ranks that differ from ``rank`` only along ``axes``, in
        the flattened order of ``axes``."""
        base = self.coordinate(rank)
        ranks = [base]
        for a in axes:
            ranks = [dict(c, **{a: i}) for c in ranks
                     for i in range(self.shape[a])]
        return [self.rank_of(c) for c in ranks]

    def live_axes(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """``axes`` less those of size 1, in mesh order."""
        want = set(axes)
        return tuple(a for a in MESH_AXES if a in want and self.shape[a] > 1)

    def group(self, axes: Sequence[str]):
        """The process group of this rank's peers along ``axes``, or None
        when that group is this rank alone (a collective over it is the
        identity, and none is issued). The first request creates the
        groups of every set of live axes (:meth:`_create_groups`)."""
        live = self.live_axes(axes)
        if not live:
            return None
        if not self.distributed:
            raise RuntimeError(
                f"mesh {self.shape}: a collective over {live} needs an "
                f"initialized process group (this mesh is layout only)")
        if not self._groups:
            self._create_groups()
        return self._groups[live]

    def _create_groups(self) -> None:
        """Every group of every non-empty set of the live axes, in one
        fixed order (the sets by size, then in mesh order; a set's groups
        by their first rank). ``new_group`` is collective over the world
        and names a group by the count made before it, so every rank must
        create the same groups in the same order; ranks reach their first
        collective at different points of a step (under GPipe a first
        stage gathers the embedding over ``fsdp`` before its first shift
        along ``stage``, a later stage shifts first), so the first request
        makes them all."""
        import itertools

        import torch.distributed as dist

        live_all = self.live_axes(MESH_AXES)
        for n in range(1, len(live_all) + 1):
            for live in itertools.combinations(live_all, n):
                mine = None
                seen = set()
                for r in range(self.size):
                    ranks = tuple(self.group_ranks(live, r))
                    if ranks in seen:
                        continue
                    seen.add(ranks)
                    g = dist.new_group(list(ranks))
                    if self.rank in ranks:
                        mine = g
                self._groups[live] = mine


def create_mesh(config: Optional[MeshConfig] = None,
                world: Optional[int] = None,
                device_type: str = "cuda",
                rank: Optional[int] = None) -> Mesh:
    """The six-axis mesh over the default process group's ranks
    (``world`` defaults to its size, or 1 with no group). With a group,
    the mesh also builds the ``DeviceMesh`` of the six named dims
    (``Mesh.device_mesh``), ``data`` outermost and ``tensor`` innermost;
    without one it is layout only, at ``rank`` (default 0)."""
    import torch.distributed as dist

    config = config or MeshConfig()
    live = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if live else 1
    sizes = config.resolve(world)
    if not live:
        return Mesh(sizes, rank or 0, device_type)
    if world != dist.get_world_size():
        raise ValueError(f"a mesh of {world} over a process group of "
                         f"{dist.get_world_size()}")
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(sizes[a] for a in MESH_AXES)
    dm = DeviceMesh(device_type, torch.arange(world).reshape(shape),
                    mesh_dim_names=MESH_AXES)
    return Mesh(sizes, dist.get_rank(), device_type, dm)


def batch_shard_axes() -> Tuple[str, ...]:
    """Mesh axes over which the global batch dimension is split."""
    return (AXIS_DATA, AXIS_FSDP)


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


@dataclass(frozen=True)
class ParallelismPlan:
    """A resolved plan: mesh config + the knobs the trainer needs to know
    about (whether ring attention is on, how many microbatches for PP)."""

    mesh_config: MeshConfig = field(default_factory=MeshConfig)
    ring_attention: bool = False  # shard sequence via ops.ring_attention
    microbatches: int = 1  # pipeline microbatches (>=stage count when stage>1)

    def validate(self, n_devices: int) -> Dict[str, int]:
        sizes = self.mesh_config.resolve(n_devices)
        if sizes[AXIS_SEQ] > 1 and not self.ring_attention:
            raise ValueError(
                "seq axis >1 requires ring_attention=True (dense attention "
                "cannot shard the sequence dimension)")
        if sizes[AXIS_STAGE] > 1 and self.microbatches % sizes[AXIS_STAGE] != 0:
            raise ValueError(
                f"microbatches ({self.microbatches}) must be a multiple of "
                f"pipeline stages ({sizes[AXIS_STAGE]})")
        return sizes


def describe_mesh(mesh: Mesh) -> str:
    parts = [f"{a}={s}" for a, s in mesh.shape.items() if s > 1]
    return "mesh(" + (", ".join(parts) or "single-device") + ")"
