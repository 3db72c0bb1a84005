"""Where a model's leaves live, as its forward and its step read them -- a
module of the port only. The reference writes its model once and lets
GSPMD partition it; the port writes once too (``models/llama.py``'s
block, forward and loss) and calls a model's placement at the few points
where GSPMD would insert a collective.

:class:`Placement` is the one-device model's: every leaf whole on this
device and every hook the identity. A model built over a mesh
(``models.llama`` with ``mesh=``) carries a :class:`MeshPlacement`, whose
hooks run the rank's blocks with the collectives of ``collectives.py``
between. Per axis:

* ``data`` and ``fsdp`` split the batch rows, ``seq`` the tokens of a row
  (ring attention across it): each rank's loss is the mean over its tokens
  and the step takes ``1 / (data * fsdp * seq)`` of it, so the sum over
  ranks is the mean over the global batch (shards are equal);
* ``fsdp`` also splits every leaf's ``embed`` dim: gathered at use
  (:func:`.collectives.all_gather`), reduce-scattered back;
* ``tensor`` is Megatron: q/k/v and w1/w3 split their output heads or
  columns (``copy_to`` before), wo and w2 their input (``reduce_from``
  after); the embedding splits the vocabulary (masked lookup, then
  ``reduce_from``); the head's vocabulary split is gathered
  (``gather_replicated``) and the loss computed whole on every rank of the
  group; an MoE layer gathers its expert weights' ``mlp`` split the same
  way. A dim its axes do not divide stays whole (``sharding.py``): heads
  computed whole on every rank go through ``select`` to the heads this
  rank's ``wo`` block holds;
* ``expert`` splits the expert weights' leading dim; tokens are
  replicated along it. An MoE layer routes the global batch's tokens
  (seats gathered over ``data``, ``fsdp`` and ``seq``) and runs this
  rank's experts between a ``copy_to`` and a ``reduce_from`` over
  ``expert`` (:class:`MeshRouting`), so every other gradient is whole on
  every expert rank, as under ``tensor``;
* ``stage``: each rank holds a contiguous group of layers
  (``train/pipeline.py``).

After the backward, :meth:`MeshPlacement.sync_grads` sums every gradient
over the partitioned axes its leaf is replicated along (``data`` and
``seq`` always, ``fsdp`` unless the leaf is split over it, ``stage``
unless it is a layer's; never ``tensor`` or ``expert``); :meth:`MeshPlacement.global_norm` sums each
leaf's squares once, on the ranks at coordinate 0 of every axis the leaf
is replicated along. On a mesh of one rank every collective is skipped and
each hook computes what :class:`Placement`'s does, operation for
operation.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence, Tuple

import torch

from ..ops.moe import LOCAL as LOCAL_ROUTING
from ..ops.moe import Routing, _positions
from .collectives import (all_gather, all_reduce_sum, copy_to,
                          gather_replicated, psum, reduce_from, select)
from .mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_FSDP, AXIS_SEQ, AXIS_STAGE,
                   AXIS_TENSOR, MESH_AXES, Mesh)
from .sharding import dim_split, sharded_axes

TENSOR = (AXIS_TENSOR,)
EXPERT = (AXIS_EXPERT,)
# The axes that split the batch's tokens, and those of its rows.
BATCH = (AXIS_DATA, AXIS_FSDP, AXIS_SEQ)
ROWS = (AXIS_DATA, AXIS_FSDP)


class Placement:
    """The one-device model's placement: every hook the identity."""

    mesh = None

    def weight(self, p: Any, whole: bool = False) -> Any:
        """The leaf as a product reads it, before the cast to the
        activation dtype (``whole``: with every block, for a product that
        no axis splits)."""
        return p

    def feed(self, h: torch.Tensor, ws: Sequence[Any]
             ) -> List[torch.Tensor]:
        """The input of each product of ``h`` with one of ``ws``."""
        return [h] * len(ws)

    def reduce(self, y: torch.Tensor, w: Any) -> torch.Tensor:
        """The product ``y`` of an input with ``w``, summed over the axis
        that splits ``w``'s contraction."""
        return y

    def heads(self, attn: torch.Tensor, wo: Any) -> torch.Tensor:
        """The attention output's heads that ``wo`` holds."""
        return attn

    def lookup(self, table: torch.Tensor, tokens: torch.Tensor,
               leaf: Any) -> torch.Tensor:
        """The rows of ``tokens`` in the embedding ``table`` (``leaf`` as
        :meth:`weight` read it)."""
        return table[tokens.long()]

    def routing(self, experts: Any) -> Routing:
        """The hooks of an MoE layer whose expert leaf is ``experts``
        (``ops.moe.Routing``): here the identity's, the layer holds every
        token of the batch and every expert."""
        return LOCAL_ROUTING

    def sync_grads(self, params: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients the update takes."""
        return [p.grad for p in params]

    def global_norm(self, params: List[torch.Tensor],
                    grads: List[torch.Tensor]) -> torch.Tensor:
        """The gradients' global norm."""
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))


LOCAL = Placement()


class MeshPlacement(Placement):
    """A rank's blocks of a model built over ``mesh``: ``leaves`` are its
    (local name, parameter) pairs, ``layout`` maps a local name to
    ``(global name, full shape, spec)``."""

    def __init__(self, mesh: Mesh, layout: Dict[str, Tuple[str, Any, Any]],
                 leaves: Iterable[Tuple[str, torch.Tensor]]):
        self.mesh = mesh
        self.info = {id(p): layout[name] for name, p in leaves}

    # -- leaves ----------------------------------------------------------
    def _split(self, p: torch.Tensor, dim: int) -> Tuple[str, ...]:
        _, shape, spec = self.info[id(p)]
        return dim_split(self.mesh, spec[dim] if dim < len(spec) else None,
                         shape[dim])

    def _tp(self, p: torch.Tensor, dim: int) -> bool:
        return AXIS_TENSOR in self._split(p, dim)

    def weight(self, p: torch.Tensor, whole: bool = False) -> torch.Tensor:
        """The fsdp split gathered (the f32 master, so the reduce-scatter
        back sums in f32); with ``whole`` the tensor split too."""
        out = p
        for d in range(p.dim()):
            if AXIS_FSDP in self._split(p, d):
                out = all_gather(out, self.mesh, (AXIS_FSDP,), d)
        if whole:
            for d in range(p.dim()):
                if self._tp(p, d):
                    out = gather_replicated(out, self.mesh, TENSOR, d)
        return out

    def feed(self, h, ws):
        split = [self._tp(w, 1) for w in ws]
        h_tp = copy_to(h, self.mesh, TENSOR) if any(split) else h
        return [h_tp if s else h for s in split]

    def reduce(self, y, w):
        return reduce_from(y, self.mesh, TENSOR) if self._tp(w, 0) else y

    def heads(self, attn, wo):
        n = wo.shape[0]
        if not self._tp(wo, 0) or attn.shape[2] == n:
            return attn
        return select(attn, self.mesh, TENSOR, 2,
                      self.mesh.coordinate()[AXIS_TENSOR] * n, n)

    def lookup(self, table, tokens, leaf):
        if not self._tp(leaf, 0):
            return table[tokens.long()]
        rows = table.shape[0]
        ids = tokens.long() - self.mesh.coordinate()[AXIS_TENSOR] * rows
        keep = (ids >= 0) & (ids < rows)
        x = table[ids.clamp(0, rows - 1)] * keep[..., None].to(table.dtype)
        return reduce_from(x, self.mesh, TENSOR)

    def routing(self, experts):
        split = AXIS_EXPERT in self._split(experts, 0)
        if not split and not self.mesh.live_axes(BATCH):
            return LOCAL_ROUTING
        return MeshRouting(self.mesh, split)

    # -- after the backward ----------------------------------------------
    def _axes(self, p: torch.Tensor) -> Tuple[Tuple[str, ...],
                                               Tuple[str, ...]]:
        """(axes the leaf is split over, axes it is replicated along)."""
        glob, shape, spec = self.info[id(p)]
        split = sharded_axes(shape, spec, self.mesh)
        if glob.startswith("layers."):
            split += (AXIS_STAGE,)
        return split, tuple(a for a in MESH_AXES if a not in split)

    def sync_grads(self, params):
        """Every leaf's gradient summed, in place, over the partitioned
        axes it is replicated along (a missing gradient -- the embedding
        off the first stage, the head off the last -- counts as zeros)."""
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            split, _ = self._axes(p)
            axes = [AXIS_DATA, AXIS_SEQ]
            if AXIS_FSDP not in split:
                axes.append(AXIS_FSDP)
            if AXIS_STAGE not in split:
                axes.append(AXIS_STAGE)
            grads.append(all_reduce_sum(p.grad, self.mesh, axes))
        return grads

    def global_norm(self, params, grads):
        """The whole gradient's global norm, each leaf counted once."""
        if self.mesh.size == 1:
            return super().global_norm(params, grads)
        coord = self.mesh.coordinate()
        owned = []
        for p, g in zip(params, grads):
            sq = torch.sum(torch.square(g.float()))
            _, replicated = self._axes(p)
            own = all(coord[a] == 0 for a in replicated)
            owned.append(sq if own else torch.zeros_like(sq))
        vec = all_reduce_sum(torch.stack(owned), self.mesh, MESH_AXES)
        return torch.sqrt(sum(vec.unbind()))


class MeshRouting(Routing):
    """An MoE layer's hooks on ``mesh`` (``ops.moe.Routing``). Tokens are
    split over ``data``, ``fsdp`` (rows) and ``seq``, and replicated over
    ``expert``, as the reference's ``batch_spec`` places them. The seating
    gathers every rank's expert ids, K integers a token, over the batch
    axes and seats the global [B, S, K] in its row-major order, as the
    reference's one program does; the aux loss's means are :func:`psum` s
    over the same axes. With ``split`` (the expert leaves' leading dim
    split over ``expert``) each rank runs its own experts: the gates and
    the expert inputs enter through :func:`copy_to` and the output leaves
    through :func:`reduce_from`, Megatron's pair over ``expert``, so the
    router, everything before the layer and the aux loss get the whole
    gradient on every expert rank and nothing is summed over ``expert``
    after the backward.

    Under GPipe (``stage`` > 1) the layer sees one microbatch at a tick.
    The batch placer (``parallel.multihost.make_batch_placer``) gives each
    rank its share of every global microbatch -- rank r of the R = data x
    fsdp row shards holds rows [m B/M + r B/(M R), m B/M + (r+1) B/(M R))
    of microbatch m -- so the gathered ids, in rank-block order, are the
    reference's microbatch m row for row, and the seats, drops and means
    are that microbatch's, as in the reference's stage buffer sharded
    ``P(stage, (data, fsdp), seq)``."""

    def __init__(self, mesh: Mesh, split: bool):
        self.mesh = mesh
        self.batch = mesh.live_axes(BATCH)
        self.split = split

    def tokens(self, t):
        return t * self.mesh.axes_size(self.batch)

    def mean(self, v):
        if not self.batch:
            return super().mean(v)
        return psum(v.sum(dim=0), self.mesh, self.batch) / self.tokens(
            v.shape[0])

    def positions(self, top_i):
        if not self.batch:
            return super().positions(top_i)
        b, s, k = top_i.shape
        mesh = self.mesh
        rows = mesh.live_axes(ROWS)
        n_rows, n_seq = mesh.axes_size(rows), mesh.shape[AXIS_SEQ]
        # Blocks in group order (rows major, then seq) -> the global
        # [B, S, K], rows of rank blocks, each row's seq parts in order.
        ids = all_gather(top_i.contiguous(), mesh, self.batch, 0)
        ids = ids.reshape(n_rows, n_seq, b, s, k).permute(0, 2, 1, 3, 4)
        pos = _positions(ids.reshape(-1, k))
        dev = top_i.device
        row = mesh.axes_index(rows) * b + torch.arange(b, device=dev)
        tok = mesh.coordinate()[AXIS_SEQ] * s + torch.arange(s, device=dev)
        return pos[(row[:, None] * (n_seq * s) + tok[None, :]).reshape(-1)]

    def experts(self, e, held):
        return self.mesh.coordinate()[AXIS_EXPERT] * held if self.split \
            else 0

    def enter(self, x):
        return copy_to(x, self.mesh, EXPERT) if self.split else x

    def combine(self, y):
        return reduce_from(y, self.mesh, EXPERT) if self.split else y
