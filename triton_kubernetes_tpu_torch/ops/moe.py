"""Mixture-of-Experts layer (Mixtral-style top-k routing, GShard seating)
-- the port of ``triton_kubernetes_tpu/ops/moe.py``.

Expert weights are expert-indexed tensors, ``router [D, E]``, ``w1``/``w3``
``[E, D, F]`` and ``w2 [E, F, D]``. Routing (:func:`_route`) is the
reference's: f32 router logits, softmax, top-k, the gates renormalized,
and the load-balancing loss ``E * sum(frac_routed * mean_prob)``. Each
expert holds ``capacity`` slots; every token's first choice is seated
before any token's second choice, ties to the lower token id, and an
assignment past capacity is dropped (the token's residual carries it).

:func:`moe_layer` is the plain version that training, the CPU and the
contiguous ``generate`` run, with the reference's two dispatches: "dense"
(one-hot ``[T, E, C]`` einsums in f32) and "sort" (a stable sort of the
choice-major assignments by expert); "auto" takes sort once the dense
dispatch tensors pass 64 MiB. Gradients flow through the gates and the
aux loss. It has one body, which asks a :class:`Routing` where its tokens
and experts sit: the one-device :class:`Routing` (every hook the identity)
holds the whole batch and every expert; on a mesh the rank's rows and
tokens are part of the global batch and its experts part of all of them,
and the layer computes what the reference computes on the global batch --
capacity, seats, drops and the aux loss's means over every token, then the
rank's experts on the slots they kept, the partial outputs summed over the
expert ranks (``parallel/placement.MeshRouting``). :func:`top_k_router`
and :func:`sort_router` are the reference's two routers, kept with its
names and outputs.

:func:`moe_layer_rows` is the layer of the paged serving steps
(``row_invariant=True`` in ``models/llama.py``): the same routing and
seating, with the router product and each expert's products through the
row-invariant ``ops.decode_gemm`` (one launch for w3/w1 and one for w2 an
expert), and the combine done in choice order, so that with dropless
capacity a token's output bits do not depend on how many rows the step
holds. The JAX package computes these products with plain einsums; there
is no TPU kernel to port here.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .decode_gemm import decode_gemm_group

Params = Dict[str, torch.Tensor]


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, ties to the lower
    index (``lax.top_k``'s rule; ``torch.topk`` on CUDA does not promise
    it): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _gates(logits: torch.Tensor, num_selected: int,
           routing: Optional["Routing"] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routing from f32 router logits [T, E]: (top_p [T, K] renormalized
    gates, top_i [T, K] expert ids, aux loss). The aux loss's two means
    are ``routing``'s (:meth:`Routing.mean`; default this batch's)."""
    e = logits.shape[1]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, num_selected)
    # The K gates summed in choice order: elementwise adds, the same for
    # a row whatever the row count.
    total = top_p[:, 0]
    for j in range(1, num_selected):
        total = total + top_p[:, j]
    top_p = top_p / total[:, None]
    # Load-balancing aux loss (Switch/Mixtral): E * <frac routed> . <mean p>
    first = F.one_hot(top_i[:, 0], e).float()
    routing = routing or LOCAL
    frac_routed, mean_p = routing.mean(first), routing.mean(probs)
    aux = e * torch.sum(frac_routed * mean_p)
    return top_p, top_i, aux


def _route(x: torch.Tensor, router_w: torch.Tensor, num_selected: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared routing head of both dispatches: (top_p [T, K], top_i
    [T, K], aux) for x [T, D] and router_w [D, E]."""
    return _gates(x.float() @ router_w.float(), num_selected)


def _capacity(capacity_factor: float, num_selected: int, t: int,
              e: int) -> int:
    """Slots an expert holds, in Python floats as the reference computes
    them."""
    return max(1, int(capacity_factor * num_selected * t / e))


def top_k_router(x: torch.Tensor, router_w: torch.Tensor,
                 num_selected: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dispatch [T, E, C] f32 0/1, combine [T, E, C] f32, aux). Slots
    are seated by priority: every token's first choice before any token's
    second choice (GShard)."""
    t = x.shape[0]
    e = router_w.shape[1]
    top_p, top_i, aux = _route(x, router_w, num_selected)
    slots = torch.arange(capacity, device=x.device)
    dispatch = x.new_zeros((t, e, capacity), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros(e, dtype=torch.long, device=x.device)
    for j in range(num_selected):
        mask_j = F.one_hot(top_i[:, j], e)  # [T, E]
        pos = torch.cumsum(mask_j, dim=0) - 1 + counts[None, :]
        counts = counts + mask_j.sum(dim=0)
        slot_idx = (pos * mask_j).sum(dim=-1)  # [T]
        # A slot index at or past capacity matches no slot: the token is
        # dropped (the reference's one_hot of an out-of-range index).
        slot = (slot_idx[:, None] == slots[None, :]).float()  # [T, C]
        d_j = mask_j.float()[:, :, None] * slot[:, None, :]
        dispatch = dispatch + d_j
        combine = combine + d_j * top_p[:, j][:, None, None]
    return dispatch, combine, aux


def _seat(top_p: torch.Tensor, top_i: torch.Tensor, capacity: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor, torch.Tensor]:
    """Sort-based seating of routed assignments: (token_idx, slot, gate,
    keep, order), each [T*K] in the sorted order, where ``order`` maps a
    sorted position to its choice-major index ``j*T + t``."""
    t, k = top_i.shape
    # Choice-major flattening (index j*T + t): a stable sort by expert
    # seats every first choice before any second choice, and ties within a
    # choice by token id -- top_k_router's priority order.
    flat_e = top_i.t().reshape(-1)
    flat_p = top_p.t().reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    idx = torch.arange(t * k, device=top_i.device)
    pos = idx - torch.searchsorted(sorted_e, sorted_e, side="left")
    keep = pos < capacity
    slot = sorted_e * capacity + torch.clamp(pos, max=capacity - 1)
    return order % t, slot, flat_p[order], keep, order


def sort_router(x: torch.Tensor, router_w: torch.Tensor, num_selected: int,
                capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """The seating of :func:`top_k_router` (same priority, same drops)
    without the [T, E, C] one-hots. Returns (token_idx [T*K], slot [T*K],
    gate [T*K], keep [T*K], aux): assignment i sends token
    ``token_idx[i]`` to flat expert slot ``slot[i]`` (expert * C +
    position) with combine weight ``gate[i]``; ``keep`` is False for
    assignments past capacity."""
    top_p, top_i, aux = _route(x, router_w, num_selected)
    token_idx, slot, gate, keep, _ = _seat(top_p, top_i, capacity)
    return token_idx, slot, gate, keep, aux


def _auto_dispatch_mode(t: int, e: int, capacity: int) -> str:
    """Two f32 [T, E, C] tensors past 64 MiB: sort dispatch."""
    return "sort" if 2 * 4 * t * e * capacity > 64 * 2 ** 20 else "dense"


def dispatch_mode_of(dispatch_mode: str, t: int, e: int, num_selected: int,
                     capacity_factor: float) -> str:
    """The dispatch :func:`moe_layer` runs for ``t`` tokens over ``e``
    experts: ``dispatch_mode`` with "auto" resolved."""
    if dispatch_mode != "auto":
        return dispatch_mode
    return _auto_dispatch_mode(
        t, e, _capacity(capacity_factor, num_selected, t, e))


def _expert_mlp(expert_in: torch.Tensor, params: Params,
                out_dtype: torch.dtype) -> torch.Tensor:
    """[E, C, D] -> [E, C, D], SwiGLU per expert."""
    h = torch.bmm(expert_in, params["w1"])
    g = torch.bmm(expert_in, params["w3"])
    h = F.silu(g.float()).to(out_dtype) * h
    return torch.bmm(h, params["w2"])


def _dispatch_sorted(x2: torch.Tensor, token_idx: torch.Tensor,
                     slot: torch.Tensor, keep: torch.Tensor, e: int,
                     capacity: int) -> torch.Tensor:
    """The expert buffers [E, C, D]: each kept assignment's token row in
    its slot, zeros in empty slots. Dropped assignments are written to a
    trash row past the last slot, which is sliced off (the reference's
    scatter with ``mode="drop"``); kept slots are unique."""
    safe = torch.where(keep, slot, torch.full_like(slot, e * capacity))
    buf = x2.new_zeros((e * capacity + 1, x2.shape[1]))
    buf = buf.index_copy(0, safe, x2[token_idx])
    return buf[:-1].reshape(e, capacity, x2.shape[1])


def _positions(top_i: torch.Tensor) -> torch.Tensor:
    """Each assignment's position within its expert [T, K], in the seating
    order of :func:`_seat` (choice-major, ties to the lower token id)."""
    t, k = top_i.shape
    flat_e = top_i.t().reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    idx = torch.arange(t * k, device=top_i.device)
    pos = torch.empty_like(idx)
    pos[order] = idx - torch.searchsorted(sorted_e, sorted_e, side="left")
    return pos.reshape(k, t).t()


class Routing:
    """Where an MoE layer's tokens and experts sit, as :func:`moe_layer`
    asks. This class is the one-device layer's: it holds every token of
    the batch and every expert, and each hook is the identity. The
    reference computes the layer on the global [B, S] batch with every
    expert, and GSPMD keeps that meaning on any mesh; a rank of the port
    holds some of the rows and tokens (``data``, ``fsdp``, ``seq``) and,
    with the ``expert`` axis, some of the experts (``w1``/``w3``/``w2``
    lead with the ``held`` experts from :meth:`experts` on), and every
    rank of the ``expert`` axis holds the same tokens. A mesh's subclass
    (``parallel/placement.MeshRouting``) answers for the global batch: how
    many tokens it has (the capacity and the "auto" dispatch are the
    global ones), the means of the aux loss over them, and each of the
    rank's assignments' seat in the global priority order; the layer then
    runs its own experts on the assignments they kept, and the partial
    outputs are summed over the expert ranks."""

    def tokens(self, t: int) -> int:
        """The global batch's token count, of ``t`` local ones."""
        return t

    def mean(self, v: torch.Tensor) -> torch.Tensor:
        """The mean of ``v`` [T, E] over the global batch's tokens, with
        its gradient back to every rank's rows."""
        return v.mean(dim=0)

    def positions(self, top_i: torch.Tensor) -> torch.Tensor:
        """Each assignment of ``top_i`` [B, S, K] (this rank's tokens):
        its position within its expert in the global batch's seating
        (:func:`_positions` of the global [B * S, K]), as [B * S, K]."""
        b, s, k = top_i.shape
        return _positions(top_i.reshape(b * s, k))

    def experts(self, e: int, held: int) -> int:
        """The first of the ``held`` experts (of ``e``) this rank holds."""
        return 0

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A value every expert rank holds alike, as the experts read it:
        itself, its gradient summed over the expert ranks."""
        return x

    def combine(self, y: torch.Tensor) -> torch.Tensor:
        """The layer's f32 output from this rank's partial one: summed
        over the expert ranks (the same on each)."""
        return y


LOCAL = Routing()


def moe_layer(x: torch.Tensor, params: Params, num_selected: int = 2,
              capacity_factor: float = 1.25, dispatch_mode: str = "auto",
              routing: Routing = LOCAL
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SwiGLU experts on x [B, S, D] (``params``: router [D, E], w1/w3
    [E', D, F], w2 [E', F, D] in x's dtype): returns (y [B, S, D], aux
    scalar). ``dispatch_mode``: "dense", "sort" or "auto" (sort past 64 MiB
    of dense dispatch tensors). ``routing`` (:class:`Routing`; a mesh's
    from its placement): x is its part of the global batch and the E'
    expert weights its experts; the layer computes the global batch's
    routing (seats, drops, aux loss) and its part of the output."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    held = params["w1"].shape[0]
    t = b * s
    x2 = x.reshape(t, d)
    top_p, top_i, aux = _gates(x2.float() @ params["router"].float(),
                               num_selected, routing)
    t_all = routing.tokens(t)
    capacity = _capacity(capacity_factor, num_selected, t_all, e)
    mode = dispatch_mode_of(dispatch_mode, t_all, e, num_selected,
                            capacity_factor)
    if mode not in ("dense", "sort"):
        raise ValueError(
            f"dispatch_mode must be auto|dense|sort, got {dispatch_mode!r}")
    local = top_i - routing.experts(e, held)
    keep = ((routing.positions(top_i.reshape(b, s, num_selected))
             < capacity) & (local >= 0) & (local < held))
    # The kept assignments of the held experts in their slots, in the
    # global seating's order: an expert keeps at most min(capacity, t) of
    # them (a token picks an expert once). Everything else sorts last.
    slots = min(capacity, t)
    flat = torch.where(keep, local, torch.full_like(local, held)).t(
        ).reshape(-1)
    order = torch.sort(flat, stable=True).indices
    sorted_k = flat[order]
    pos = (torch.arange(t * num_selected, device=x.device)
           - torch.searchsorted(sorted_k, sorted_k, side="left"))
    kept = sorted_k < held
    slot = torch.where(kept, sorted_k * slots + pos, torch.zeros_like(pos))
    token_idx = order % t
    gate = routing.enter(top_p).t().reshape(-1)[order] * kept
    x_in = routing.enter(x2)
    if mode == "sort":
        expert_in = _dispatch_sorted(x_in, token_idx, slot, kept, held,
                                     slots)
        expert_out = _expert_mlp(expert_in, params, x.dtype)
        contrib = expert_out.reshape(held * slots, d)[slot].float()
        # index_add of duplicate indices is unordered on CUDA; a token
        # has K = 2 contributions added to 0, and 0 + a + b == 0 + b + a
        # exactly. (Not so for K > 2.)
        y2 = torch.zeros((t, d), dtype=torch.float32,
                         device=x.device).index_add(
            0, token_idx, contrib * gate[:, None])
    else:
        zeros = torch.zeros((t, held * slots), dtype=torch.float32,
                            device=x.device)
        dispatch = zeros.index_put((token_idx, slot), kept.float(),
                                   accumulate=True)
        combine = zeros.index_put((token_idx, slot), gate, accumulate=True)
        expert_in = torch.einsum("tec,td->ecd",
                                 dispatch.view(t, held, slots),
                                 x_in.float())
        expert_out = _expert_mlp(expert_in.to(x.dtype), params, x.dtype)
        y2 = torch.einsum("tec,ecd->td", combine.view(t, held, slots),
                          expert_out.float())
    return routing.combine(y2).reshape(b, s, d).to(x.dtype), aux


# The decode GEMM takes widths in multiples of 8: a router with fewer
# experts (or a count off the multiple) gets zero columns at use.
_ROUTER_COLUMNS = 8


def router_logits_rows(x2: torch.Tensor, router_w: torch.Tensor
                       ) -> torch.Tensor:
    """f32 router logits [T, E] of x2 [T, D], ``x2.float() @ router_w``
    through the row-invariant f32 ``decode_gemm`` (router_w f32 [D, E]);
    a width off a multiple of 8 is padded with zero columns, sliced off
    here."""
    e = router_w.shape[1]
    w = router_w.float()
    pad = -e % _ROUTER_COLUMNS
    if pad:
        w = F.pad(w, (0, pad))
    logits = decode_gemm_group(x2.float().contiguous(), [w.contiguous()],
                               torch.float32)[0]
    return logits[:, :e] if pad else logits


def moe_layer_rows(x: torch.Tensor, params: Params, num_selected: int = 2,
                   capacity_factor: float = 1.25
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_layer` for the paged serving steps, with each token's
    output bits independent of the row count where no token is dropped
    (``capacity_factor >= E / K``, which ``generate`` requires): returns
    (y [B, S, D], aux).

    The router logits come from :func:`router_logits_rows` (f32 operands;
    ``params["router"]`` is kept in f32 by the model). Seating is
    :func:`sort_router`'s. Each expert's ``[C, D]`` slot rows go through
    two ``decode_gemm_group`` launches -- w3 and w1, which share the input,
    then w2 -- so a row's bits do not depend on how many slots are filled
    or which slot it sits in; empty slots are zero rows. The SwiGLU is the
    dense MLP's (``silu`` in f32, cast, times up), and a token's K
    contributions are added in choice order in f32, each ``gate * keep``
    times its expert row."""
    b, s, d = x.shape
    router = params["router"]
    e = router.shape[1]
    t = b * s
    capacity = _capacity(capacity_factor, num_selected, t, e)
    x2 = x.reshape(t, d)
    top_p, top_i, aux = _gates(router_logits_rows(x2, router), num_selected)
    token_idx, slot, _, keep, order = _seat(top_p, top_i, capacity)
    expert_in = _dispatch_sorted(x2, token_idx, slot, keep, e, capacity)
    outs = []
    for i in range(e):
        gate, up = decode_gemm_group(expert_in[i],
                                     [params["w3"][i], params["w1"][i]])
        act = F.silu(gate.float()).to(x.dtype) * up
        outs.append(decode_gemm_group(act, [params["w2"][i]])[0])
    rows = torch.cat(outs)  # [E * C, D]
    # Back from the sorted order to choice-major [K, T].
    slot_kt = torch.empty_like(slot)
    slot_kt[order] = slot
    keep_kt = torch.empty_like(keep)
    keep_kt[order] = keep
    slot_kt = slot_kt.reshape(num_selected, t)
    keep_kt = keep_kt.reshape(num_selected, t)
    y2 = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(num_selected):
        y2 = y2 + rows[slot_kt[j]].float() * (top_p[:, j]
                                              * keep_kt[j])[:, None]
    return y2.reshape(b, s, d).to(x.dtype), aux
