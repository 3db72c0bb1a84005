"""Dense causal attention with grouped-query (GQA) support -- the port of
``triton_kubernetes_tpu/ops/attention.py``.

Head ``h`` of the queries reads KV head ``h // group`` (``h = kv_head *
group + g``). Positions are explicit, and a key is kept when its position
is at most the query's. Masked logits are ``NEG_INF``, large but finite, so
they contribute exactly zero (``exp(NEG_INF - m)`` underflows to 0.0) and a
fully masked row stays NaN-free.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

NEG_INF = -1e30


def auto_attention(platform: Optional[str] = None) -> Optional[Callable]:
    """Best full-sequence causal attention for the platform (default: the
    card when one is present, else the CPU).

    On CUDA returns the ported flash kernels (``ops/flash_attention.py``)
    as an attention fn ``(q, k, v, positions) -> out`` -- the dense path
    materializes [Sq, Sk] f32 logits, which dominates the step at training
    lengths. Elsewhere returns None, i.e. the model's dense default, as
    the reference returns its Pallas kernel only on the TPU. Only valid
    for standard positions (0..S-1)."""
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform in ("cuda", "gpu"):
        from .flash_attention import flash_attention

        return lambda q, k, v, positions: flash_attention(q, k, v)
    return None


def causal_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    q_positions: Optional[torch.Tensor] = None,  # [B, Sq] int
    k_positions: Optional[torch.Tensor] = None,  # [B, Sk] int
) -> torch.Tensor:
    """Returns [B, Sq, Hq, D]. Token i attends to keys with pos <= pos_i."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    if q_positions is None:
        q_positions = torch.arange(sq, device=q.device).expand(b, sq)
    if k_positions is None:
        k_positions = torch.arange(sk, device=q.device).expand(b, sk)
    qg = q.reshape(b, sq, hkv, group, d)
    scale = d ** -0.5
    # [B, Hkv, G, Sq, Sk]: products in the input dtype, accumulated in f32.
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    mask = (q_positions[:, None, None, :, None]
            >= k_positions[:, None, None, None, :])
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, d)
