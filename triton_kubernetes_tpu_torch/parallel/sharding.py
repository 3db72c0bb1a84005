"""Logical-axis -> mesh-axis rules and each rank's block of a leaf -- the
port of ``triton_kubernetes_tpu/parallel/sharding.py``.

Models annotate every parameter with *logical* axis names ("embed",
"heads", "mlp", ...); the rules table maps them onto mesh axes.
:func:`logical_to_spec` returns a tuple with one entry per dim (a mesh
axis, a tuple of them, or None), the entries of the reference's
``PartitionSpec``. Where the reference places an array with
``NamedSharding``, the port gives every rank its own block:
:func:`local_slices` is the slice of each dim that a rank's mesh
coordinates select (a dim over two axes splits first-axis-major, as a
``PartitionSpec`` entry ``("data", "fsdp")`` does), the same block as
``NamedSharding(mesh, spec).devices_indices_map(shape)[device]`` gives
for the device at that rank's mesh position.

One case has no ``NamedSharding`` at all: a dim that its mesh axes do not
divide (``kv_heads`` 2 over ``tensor`` 4). JAX refuses to place it; the
port keeps such a dim whole on every rank (replicated), which is what the
reference's ring attention does with head and batch dims its axes do not
divide, and the sharded step reads only the part it needs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from .mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_SEQ,
    AXIS_STAGE,
    AXIS_TENSOR,
    Mesh,
)

MeshAxes = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxes, ...]

# The default layout (the reference's, verbatim):
# - batch splits over (data, fsdp): FSDP shards both params and batch.
# - params' embed dim shards over fsdp  -> all-gathered per layer in the
#   forward pass, classic FSDP/ZeRO-3.
# - heads/mlp/vocab shard over tensor   -> Megatron-style TP.
# - activations' sequence dim shards over seq -> ring attention.
# - MoE expert dim shards over expert.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": (AXIS_DATA, AXIS_FSDP),
    "sequence": AXIS_SEQ,
    "embed": AXIS_FSDP,
    "heads": AXIS_TENSOR,
    "kv_heads": AXIS_TENSOR,
    "head_dim": None,
    "mlp": AXIS_TENSOR,
    "vocab": AXIS_TENSOR,
    "expert": AXIS_EXPERT,
    # The layer dim shards over the pipeline-stage axis: each stage holds
    # its contiguous L/S chunk (a no-op on stage=1 meshes).
    "layers": AXIS_STAGE,
    "stage": AXIS_STAGE,
    "norm": None,
}


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Optional[Dict[str, MeshAxes]] = None,
    mesh: Optional[Mesh] = None,
) -> Spec:
    """Translate ("embed", "mlp") -> ("fsdp", "tensor").

    Mesh axes already used by an earlier dim are dropped (a mesh axis may
    appear at most once in a spec); axes absent from ``mesh`` are also
    dropped so the same rules work on sub-meshes. Trailing Nones are
    trimmed, as the reference trims them."""
    rules = DEFAULT_RULES if rules is None else rules
    available = set(mesh.axis_names) if mesh is not None else None
    used: set = set()
    entries = []
    for ax in logical_axes:
        if ax is None:
            entries.append(None)
            continue
        if ax not in rules:
            raise KeyError(f"no sharding rule for logical axis {ax!r}")
        mapped = rules[ax]
        if mapped is None:
            entries.append(None)
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        keep = tuple(
            a for a in axes
            if a not in used and (available is None or a in available))
        used.update(keep)
        if not keep:
            entries.append(None)
        elif len(keep) == 1:
            entries.append(keep[0])
        else:
            entries.append(keep)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_axes(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dim_split(mesh: Mesh, entry: MeshAxes, size: int) -> Tuple[str, ...]:
    """The axes a dim of ``size`` is split over: the entry's axes of size
    above 1, or none when their product does not divide ``size`` (the dim
    is then kept whole, see the module docstring)."""
    axes = mesh.live_axes(spec_axes(entry))
    # live_axes orders by the mesh; a spec entry keeps its own order.
    axes = tuple(a for a in spec_axes(entry) if a in axes)
    if not axes or size % mesh.axes_size(axes):
        return ()
    return axes


def local_slices(shape: Sequence[int], spec: Spec, mesh: Mesh,
                 rank: Optional[int] = None) -> Tuple[slice, ...]:
    """The slice of every dim of a ``shape`` leaf that ``rank`` (default
    this process's) holds under ``spec``."""
    out = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = dim_split(mesh, entry, size)
        if not axes:
            out.append(slice(0, size))
            continue
        n = mesh.axes_size(axes)
        i = mesh.axes_index(axes, rank)
        out.append(slice(i * size // n, (i + 1) * size // n))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh: Mesh
                ) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in local_slices(shape, spec, mesh))


def sharded_axes(shape: Sequence[int], spec: Spec, mesh: Mesh
                 ) -> Tuple[str, ...]:
    """Every mesh axis a leaf of ``shape`` is split over under ``spec``."""
    out: Tuple[str, ...] = ()
    for d, size in enumerate(shape):
        out += dim_split(mesh, spec[d] if d < len(spec) else None, size)
    return out


def logical_sharding(
    mesh: Mesh,
    logical_axes: Sequence[Optional[str]],
    rules: Optional[Dict[str, MeshAxes]] = None,
) -> Tuple[Mesh, Spec]:
    """(mesh, spec): what the reference's ``NamedSharding`` carries."""
    return mesh, logical_to_spec(logical_axes, rules, mesh=mesh)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


def _tree_map(fn, tree: Any, *rest: Any, is_leaf=None) -> Any:
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    return fn(tree, *rest)


def spec_tree_from_logical(
    logical_tree: Any,
    rules: Optional[Dict[str, MeshAxes]] = None,
    mesh: Optional[Mesh] = None,
) -> Any:
    """Map a tree (nested dicts) of logical-axis tuples to specs."""
    return _tree_map(lambda axes: logical_to_spec(axes, rules, mesh=mesh),
                     logical_tree, is_leaf=_is_axes)


def shard_pytree(
    tree: Any,
    logical_tree: Any,
    mesh: Mesh,
    rules: Optional[Dict[str, MeshAxes]] = None,
    rank: Optional[int] = None,
) -> Any:
    """Each leaf's block that ``rank`` (default this process's) holds:
    numpy or torch leaves, sliced (a view) by :func:`local_slices`."""
    specs = spec_tree_from_logical(logical_tree, rules, mesh=mesh)

    def block(x, spec):
        if not hasattr(x, "shape"):
            x = np.asarray(x)
        return x[local_slices(tuple(x.shape), spec, mesh, rank)]

    return _tree_map(block, tree, specs,
                     is_leaf=lambda x: not isinstance(x, dict))
