"""The collectives of the sharded step, with their adjoints -- a module of
the port only: the reference lets XLA insert these (GSPMD's all-gathers,
reduce-scatters and psums, ``lax.ppermute``'s transpose), so it has no
counterpart.

Each function takes a :class:`.mesh.Mesh` and the mesh axes it runs over.
Over a group of one rank (every named axis of size 1) each returns its
input untouched and issues no collective, so a mesh of one computes
exactly what the single-device step computes.

Two conventions meet here, and each function says which it serves:

* **partitioned** (``data``, ``fsdp``, ``seq``, ``stage``): ranks hold
  different rows or tokens, the global loss is the sum of the ranks'
  shares, and the adjoint of a linear collective is its transpose
  (:func:`ppermute` -> the inverse permutation, :func:`all_gather` ->
  reduce-scatter, :func:`psum` -> psum);
* **replicated** (``tensor`` and ``expert``, Megatron): every rank of the
  group computes
  the same loss once, so a replicated activation's gradient is the full
  gradient on every rank. :func:`copy_to` (identity; all-reduce back) and
  :func:`reduce_from` (all-reduce; identity back) are Megatron's f and g;
  :func:`gather_replicated` (all-gather; the rank's slice back) and
  :func:`select` (a slice; zero-padded all-reduce back) move between
  replicated and sharded activations.

The kernels take local tensors through ``ctypes`` (``ops/_kernels.py``),
so everything here works on the rank's local shards, never on
``DTensor`` s.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                      dtype=xs.dtype, device=xs.device)
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, group, n: int,
                    dim: int) -> torch.Tensor:
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((xs.shape[0] // n,) + tuple(xs.shape[1:]),
                      dtype=xs.dtype, device=xs.device)
    dist.reduce_scatter_tensor(out, xs, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.n, ctx.dim), None, None, \
            None


def all_gather(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
               dim: int) -> torch.Tensor:
    """Partitioned: the blocks of ``axes`` concatenated along ``dim``
    (FSDP's gather of a parameter); backward reduce-scatters (sums) the
    gradient back to the blocks."""
    group = mesh.group(axes)
    if group is None:
        return x
    return _AllGather.apply(x, group, mesh.axes_size(mesh.live_axes(axes)),
                            dim)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim, index):
        ctx.dim, ctx.index, ctx.size = dim, index, x.shape[dim]
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size),
                None, None, None, None)


def gather_replicated(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
                      dim: int) -> torch.Tensor:
    """Replicated: the blocks of ``axes`` concatenated along ``dim``, a
    value every rank then uses alike; backward keeps this rank's slice of
    the (replicated) gradient."""
    group = mesh.group(axes)
    if group is None:
        return x
    live = mesh.live_axes(axes)
    return _GatherReplicated.apply(x, group, mesh.axes_size(live), dim,
                                   mesh.axes_index(live))


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy_to(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]
            ) -> torch.Tensor:
    """Megatron's f: identity forward, all-reduce backward. Put before a
    product whose weight is sharded over ``axes`` along its output."""
    group = mesh.group(axes)
    return x if group is None else _CopyTo.apply(x, group)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]
                ) -> torch.Tensor:
    """Megatron's g: all-reduce (sum) forward, identity backward. Put
    after a product whose weight is sharded over ``axes`` along its
    contraction."""
    group = mesh.group(axes)
    return x if group is None else _ReduceFrom.apply(x, group)


class _Select(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, start, length):
        ctx.group, ctx.dim, ctx.start, ctx.full = group, dim, start, \
            x.shape[dim]
        return x.narrow(dim, start, length).contiguous()

    @staticmethod
    def backward(ctx, g):
        shape = list(g.shape)
        shape[ctx.dim] = ctx.full
        full = g.new_zeros(shape)
        full.narrow(ctx.dim, ctx.start, g.shape[ctx.dim]).copy_(g)
        return _all_reduce(full, ctx.group), None, None, None, None


def select(x: torch.Tensor, mesh: Mesh, axes: Sequence[str], dim: int,
           start: int, length: int) -> torch.Tensor:
    """Replicated: this rank's part ``[start, start + length)`` of a
    replicated ``x`` along ``dim``; backward zero-pads each rank's
    gradient and sums it over ``axes``, which is the full gradient on
    every rank (ranks that select the same part add up)."""
    group = mesh.group(axes)
    if group is None:
        return x.narrow(dim, start, length)
    return _Select.apply(x, group, dim, start, length)


def _peer_ranks(mesh: Mesh, axis: str, perm: Sequence[Tuple[int, int]]
                ) -> Tuple[Optional[int], Optional[int]]:
    """(global rank to send to, global rank to receive from) under
    ``perm``, pairs of indices along ``axis``."""
    ranks = mesh.group_ranks([axis])
    me = mesh.coordinate()[axis]
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    return (ranks[dst[0]] if dst else None, ranks[src[0]] if src else None)


def _through_host(x: torch.Tensor, group) -> bool:
    """Whether a point-to-point transfer of ``x`` over ``group`` goes
    through host memory: gloo's collectives take CUDA tensors, but its
    send and receive read the tensor's pointer as host memory (a CUDA
    tensor aborts the process, ``writev ... Bad address``), so over gloo a
    CUDA tensor is copied to the host, sent, and the received one copied
    back. Chosen by the backend, never by catching an error; the compute
    stays on the card."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _permute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    group = mesh.group([axis])
    send_to, recv_from = _peer_ranks(mesh, axis, perm)
    x = x.contiguous()
    if _through_host(x, group):
        return _permute_tensor(x.cpu(), group, send_to, recv_from).to(
            x.device)
    return _permute_tensor(x, group, send_to, recv_from)


def _permute_tensor(x: torch.Tensor, group, send_to: Optional[int],
                    recv_from: Optional[int]) -> torch.Tensor:
    out = torch.zeros_like(x)
    ops: List[dist.P2POp] = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, x, send_to, group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, out, recv_from, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.inverse = [(d, s) for s, d in perm]
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.mesh, ctx.axis, ctx.inverse), None, None, \
            None


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: index ``s`` along ``axis`` sends ``x`` to ``d``
    for each ``(s, d)`` in ``perm``; an index that receives nothing gets
    zeros. Backward applies the inverse permutation (JAX's transpose).
    Integer tensors (positions) go through without a gradient."""
    if mesh.shape[axis] == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    if not x.requires_grad:
        return _permute(x, mesh, axis, perm)
    return _PPermute.apply(x, mesh, axis, list(perm))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]) -> torch.Tensor:
    """Partitioned: ``lax.psum`` -- the sum over ``axes`` of each rank's
    part, on every rank; backward sums the cotangent over ``axes`` too,
    since every rank's share of the loss reads the total (an MoE layer's
    routed fractions and mean probabilities over the global batch)."""
    group = mesh.group(axes)
    return x if group is None else _PSum.apply(x, group)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]
                   ) -> torch.Tensor:
    """Sum over ``axes`` in place (no gradient): gradients and metrics."""
    group = mesh.group(axes)
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def mean_over(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]
              ) -> torch.Tensor:
    """The mean over ``axes`` of a value (no gradient): the loss of a
    batch split over the batch axes."""
    group = mesh.group(axes)
    if group is None:
        return x
    out = _all_reduce(x.detach(), group)
    return out / mesh.axes_size(mesh.live_axes(axes))


def broadcast_from(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
                   index: int) -> torch.Tensor:
    """The value of the rank at ``index`` of ``axes`` on every rank of
    the group (no gradient)."""
    group = mesh.group(axes)
    if group is None:
        return x
    src = mesh.group_ranks(mesh.live_axes(axes))[index]
    out = x.detach().contiguous().clone()
    dist.broadcast(out, src=src, group=group)
    return out
