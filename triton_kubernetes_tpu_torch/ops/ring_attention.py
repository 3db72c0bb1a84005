"""Ring attention: exact causal attention over a sequence-sharded mesh
axis -- the port of ``triton_kubernetes_tpu/ops/ring_attention.py``.

Each rank on the ``seq`` axis holds a contiguous sequence shard of Q, K and
V. K and V blocks -- and their positions -- rotate around the ring with
:func:`..parallel.collectives.ppermute` (``dist.batch_isend_irecv``) while
every rank merges its queries' attention over each visiting block with the
online softmax, in f32. After ``n`` blocks every query shard has seen every
key shard once: the same math as dense causal attention, with memory
O(S/n) a rank. Autograd runs through the loop and through ``ppermute``'s
backward (the inverse permutation), as JAX transposes ``lax.ppermute``.

The reference runs this as plain XLA (no Pallas kernel), and the port keeps
it in PyTorch. Its loop rotates after each of the first ``n - 1`` blocks:
the reference's last rotation returns the blocks to where they started and
is discarded, so it moves no result. Scores are the f32 products of the
input-dtype operands, as the flash kernels compute them: the reference's
einsum of bf16 operands rounds its scores to bf16 before the f32 cast,
the port's does not (f32 inputs: the same numbers).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.collectives import ppermute
from ..parallel.mesh import Mesh
from .attention import NEG_INF


def _block_flash(q: torch.Tensor,  # [B, Sq, Hq, D]
                 k: torch.Tensor,  # [B, Sk, Hkv, D]
                 v: torch.Tensor,
                 q_pos: torch.Tensor,  # [Sq]
                 k_pos: torch.Tensor,  # [Sk]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One KV block's contribution: (block_max, block_sumexp, block_out).

    block_max/sumexp: [B, Hkv, G, Sq] f32; block_out: [B, Sq, Hkv, G, D]
    f32 (unnormalized, scaled by exp(logits - block_max))."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = logits * (d ** -0.5)
    mask = q_pos[None, None, None, :, None] >= k_pos[None, None, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)  # [B, Hkv, G, Sq]
    p = torch.exp(logits - m[..., None])
    # Zero fully-masked rows (m == NEG_INF would give exp(0)=1 per entry).
    p = torch.where(mask, p, torch.zeros_like(p))
    s = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return m, s, o


def ring_attention_inner(q: torch.Tensor,  # [B, S_loc, Hq, D] local shard
                         k: torch.Tensor,  # [B, S_loc, Hkv, D]
                         v: torch.Tensor,
                         mesh: Mesh,
                         axis_name: str = "seq",
                         positions: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """The ring over ``axis_name`` of ``mesh`` on this rank's shards.

    With ``positions`` ([S_loc] local token positions) the q and k
    positions come from it and the k positions rotate with their blocks:
    no rank index is read, which is what lets the ring nest under the
    pipeline. Without it the shard's positions are derived from the rank's
    index along the axis (top-level callers)."""
    n = mesh.shape[axis_name]
    b, s_loc, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if positions is None:
        idx = mesh.coordinate()[axis_name]
        q_pos = idx * s_loc + torch.arange(s_loc, device=q.device)
    else:
        q_pos = positions.to(q.device).long()

    m = torch.full((b, hkv, g, s_loc), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, s_loc), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, s_loc, hkv, g, d), dtype=torch.float32,
                    device=q.device)
    perm = [(j, (j + 1) % n) for j in range(n)]
    k_blk, v_blk, k_pos = k, v, q_pos
    for step in range(n):
        bm, bs, bo = _block_flash(q, k_blk, v_blk, q_pos, k_pos)
        new_m = torch.maximum(m, bm)
        alpha = torch.exp(m - new_m)
        beta = torch.exp(bm - new_m)
        l = l * alpha + bs * beta
        # [B, Sq, Hkv, G, 1] scaling of the f32 accumulator
        o = (o * alpha.movedim(3, 1)[..., None]
             + bo * beta.movedim(3, 1)[..., None])
        m = new_m
        if step + 1 < n:
            # Positions ride the ring with their blocks, so no rank ever
            # needs to know which block it holds.
            k_blk = ppermute(k_blk, mesh, axis_name, perm)
            v_blk = ppermute(v_blk, mesh, axis_name, perm)
            k_pos = ppermute(k_pos, mesh, axis_name, perm)
    out = o / l.movedim(3, 1)[..., None]
    return out.reshape(b, s_loc, hq, d).to(q.dtype)


def make_ring_attention(mesh: Mesh, seq_axis: str = "seq"):
    """Returns ``attention(q, k, v, positions=None) -> out`` over this
    rank's shards, the sequence split over ``seq_axis``. The reference
    also names the batch and head axes, for its shard_map specs; in the
    port every rank already holds just its rows and heads, and attention
    is independent across them, so the ring takes no such argument.
    ``positions`` are [B_loc, S_loc] standard ranges, the first row every
    row's (the reference's positions operand)."""

    def attn(q, k, v, positions=None):
        return ring_attention_inner(
            q, k, v, mesh, seq_axis,
            positions=None if positions is None else positions[0])

    return attn
