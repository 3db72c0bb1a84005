"""Causal attention streamed over key blocks in plain PyTorch -- the port of
``triton_kubernetes_tpu/ops/blockwise_attention.py``.

The algorithm of the flash kernels (online-softmax forward, a backward
recomputed from the row logsumexp) as a loop over ``block_k``-sized key
blocks, so the [Sq, Sk] logits never exist whole: peak temporary memory is
O(Sq * block_k). It is one ``torch.autograd.Function`` that saves only
``(q, k, v, out, lse)`` -- autograd through the loop would keep every
block's probabilities, the O(S^2) buffer this exists to avoid -- and whose
backward is one recomputing pass: per block ``p = exp(logits - lse)``,
``dq`` accumulated, ``dk``/``dv`` emitted.

The reference writes it in XLA with no Pallas kernel; the port keeps it in
PyTorch (no hand-written kernel replaces a function that has no TPU
kernel). Positions follow the model contract ([B, S] integers, every row
the same, as the reference assumes; or [S], or None for 0..S-1). Keys are
padded to a multiple of the block with position ``INT32_MAX``, which the
causal mask (q >= k) always excludes; the mask is the reference's additive
[Sq, bk] term. Scores are the f32 products of the input-dtype operands,
as the flash kernels compute them: the reference's einsum of bf16
operands rounds its scores to bf16 before the f32 cast, the port's does
not (f32 inputs: the same numbers).
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import NEG_INF

DEFAULT_BLOCK_K = 1024
INT32_MAX = 2 ** 31 - 1


def _norm_positions(positions: Optional[torch.Tensor], s: int,
                    device: torch.device) -> torch.Tensor:
    if positions is None:
        return torch.arange(s, dtype=torch.int64, device=device)
    pos = torch.as_tensor(positions, device=device)
    if pos.dim() == 2:  # [B, S] broadcast contract: every row identical
        pos = pos[0]
    return pos.long()


def _kv_blocks(k, v, k_pos, block_k: int):
    """Pad Sk to a block multiple; leading-block stacks [nb, B, bk, H, D]
    and positions [nb, bk]. Padded keys sit at INT32_MAX."""
    b, sk, hkv, d = k.shape
    pad = (-sk) % block_k
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.cat([k_pos, torch.full((pad,), INT32_MAX,
                                             dtype=k_pos.dtype,
                                             device=k_pos.device)])
    nb = (sk + pad) // block_k
    kb = k.reshape(b, nb, block_k, hkv, d).transpose(0, 1)
    vb = v.reshape(b, nb, block_k, hkv, d).transpose(0, 1)
    return kb, vb, k_pos.reshape(nb, block_k)


def _block_logits(q5, k_blk, q_pos, k_pos, scale):
    """Masked f32 logits [B, Hkv, G, Sq, bk] of one key block (shared by
    the forward and the backward's recompute)."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(),
                          k_blk.float()) * scale
    adder = torch.where(q_pos[:, None] >= k_pos[None, :],
                        torch.zeros((), device=q5.device),
                        torch.full((), NEG_INF, device=q5.device))
    return logits + adder[None, None, None]


def _setup(q, k, positions, block_k):
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    q_pos = _norm_positions(positions, sq, q.device)
    k_pos = (_norm_positions(positions, sk, q.device)
             if positions is not None
             else torch.arange(sk, dtype=torch.int64, device=q.device))
    return (b, sq, hq, d, hkv, hq // hkv, d ** -0.5, q_pos, k_pos,
            min(block_k, sk))


def _forward(q, k, v, positions, block_k):
    b, sq, hq, d, hkv, g, scale, q_pos, k_pos, bk = _setup(
        q, k, positions, block_k)
    q5 = q.reshape(b, sq, hkv, g, d)
    kb, vb, kpb = _kv_blocks(k, v, k_pos, bk)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32, device=q.device)
    for k_blk, v_blk, kp in zip(kb, vb, kpb):
        logits = _block_logits(q5, k_blk, q_pos, kp, scale)
        bm = logits.amax(dim=-1)  # [B, Hkv, G, Sq]
        # A row fully masked in this block has bm = NEG_INF and p = 1s,
        # but its beta = exp(NEG_INF - new_m) zeroes the contribution
        # (block 0 always holds the self-key, so new_m is finite).
        p = torch.exp(logits - bm[..., None])
        bs = p.sum(dim=-1)
        bo = torch.einsum("bhgqk,bkhd->bqhgd", p, v_blk.float())
        new_m = torch.maximum(m, bm)
        alpha = torch.exp(m - new_m)
        beta = torch.exp(bm - new_m)
        l = l * alpha + bs * beta
        o = (o * alpha.movedim(3, 1)[..., None]
             + bo * beta.movedim(3, 1)[..., None])
        m = new_m
    out = (o / l.movedim(3, 1)[..., None]).reshape(b, sq, hq, d).to(q.dtype)
    return out, m + torch.log(l)


def _backward(q, k, v, positions, out, lse, dout, block_k):
    b, sq, hq, d, hkv, g, scale, q_pos, k_pos, bk = _setup(
        q, k, positions, block_k)
    sk = k.shape[1]
    q5 = q.reshape(b, sq, hkv, g, d)
    do5 = dout.float().reshape(b, sq, hkv, g, d)
    # D_i = <dout_i, out_i>: the softmax-jacobian diagonal term.
    dsum = torch.einsum("bqhgd,bqhgd->bhgq", do5,
                        out.float().reshape(b, sq, hkv, g, d))
    kb, vb, kpb = _kv_blocks(k, v, k_pos, bk)
    dq = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for k_blk, v_blk, kp in zip(kb, vb, kpb):
        logits = _block_logits(q5, k_blk, q_pos, kp, scale)
        p = torch.exp(logits - lse[..., None])
        dvs.append(torch.einsum("bhgqk,bqhgd->bkhd", p, do5))
        dp = torch.einsum("bqhgd,bkhd->bhgqk", do5, v_blk.float())
        ds = p * (dp - dsum[..., None]) * scale
        dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, k_blk.float())
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, q5.float()))
    dk = torch.cat(dks, dim=1)[:, :sk]
    dv = torch.cat(dvs, dim=1)[:, :sk]
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Blockwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, positions, block_k):
        out, lse = _forward(q, k, v, positions, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.positions, ctx.block_k = positions, block_k
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, ctx.positions, out, lse, dout,
                               ctx.block_k)
        return dq, dk, dv, None, None


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        positions: Optional[torch.Tensor] = None,
                        block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """[B, S, Hq, D] causal attention, GQA via Hq % Hkv == 0."""
    if positions is not None:
        positions = positions.detach()
    return _Blockwise.apply(q, k, v, positions, block_k)
