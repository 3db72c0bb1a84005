"""Blockwise causal flash attention, forward and backward -- the port of
``triton_kubernetes_tpu/ops/flash_attention.py``.

:func:`flash_attention` takes ``[B, S, H, D]`` q/k/v (GQA: ``Hq`` a
multiple of ``Hkv``, query head ``h`` reads KV head ``h // group``) at the
standard positions ``0 .. S-1`` and returns ``[B, S, Hq, D]``. It is one
``torch.autograd.Function``:

* on CUDA tensors the forward launches ``csrc/flash_fwd.cu`` (out and the
  row logsumexp ``lse``) and saves ``(q, k, v, out, lse)``; the backward
  computes ``D = rowsum(dO * O)`` in PyTorch, as the reference does outside
  its kernels, and launches ``csrc/flash_bwd_dq.cu`` and
  ``csrc/flash_bwd_dkv.cu``. A build or launch failure raises: a CUDA
  tensor never falls back to the plain versions;
* on CPU tensors it runs the plain versions :func:`_flash_forward_plain`
  and :func:`_flash_backward_plain`, which the CPU tests hold against the
  JAX package and ``chip_smoke.py`` holds the kernels against.

``flash_attention.launches`` counts kernel launches by kernel name;
:func:`reset_launch_counts` zeroes it. :func:`flash_attention_plain` runs
the plain versions on any device (comparisons only, never the main path).

Rounding points, shared by the kernels and the plain versions (and by the
reference's Pallas kernels): scores in f32 from the input-dtype operands,
then times ``D ** -0.5``; an f32 online softmax over tiles of keys; ``p``
rounded to V's dtype before ``P @ V``; ``out = acc / l``, ``lse = m +
log l``. Backward: ``p = exp(s - lse)`` recomputed in f32; ``dp = dO @
V^T`` in f32; ``ds = p * (dp - D) * scale`` rounded to the input dtype
before ``ds @ K`` and ``ds^T @ Q``; ``p`` rounded before ``p^T @ dO``; dK
and dV summed over the query heads of a group in f32. The forward's ``p``
depends on the running max at each key tile, so the plain forward takes
the tile width: the JAX block rule :func:`_pick_block` on the CPU path (so
the CPU tests match the JAX kernel's tiles), :func:`kernel_block_k` when
compared with the CUDA kernel. Each of the three kernels has two
designs, tensor cores (bf16 at D 64 or 128; the forward's key tiles of
128) and CUDA cores (key tiles of 64), chosen by
``_kernels.flash_variant``; only the forward's tile enters the rounding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from .attention import NEG_INF

# The reference's defaults (its block sweep was taken on a TPU and does not
# carry over; these only fix the plain version's tile on the CPU path).
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024
# Keys per tile in csrc/flash_fwd.cu, by design: the plain version's
# block_k when it is compared with the kernel.
KERNEL_BLOCK_K = {name: variant.block_k
                  for name, variant in _kernels.FLASH_VARIANTS.items()}

_KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def kernel_block_k(dtype: torch.dtype, head_dim: int) -> int:
    """Key-tile width of the forward kernel that runs for this dtype and
    head width."""
    return KERNEL_BLOCK_K[_kernels.flash_variant(dtype, head_dim)]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pick_block(default: int, s: int) -> int:
    """Largest 128-multiple <= default that divides the 128-padded
    sequence (the reference's rule, ``flash_attention.py:53``)."""
    sp = _round_up(s, 128)
    if sp <= default:
        return sp
    for b in range(default - default % 128, 127, -128):
        if sp % b == 0:
            return b
    return 128


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Scaled, causally masked f32 scores [B, Hkv, G, S, Sk] of
    [B, S, Hq, D] queries against [B, Sk, Hkv, D] keys."""
    b, s, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    qg = q.reshape(b, s, hkv, hq // hkv, d).float()
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    causal = (torch.arange(sk, device=q.device)[None, :]
              <= torch.arange(s, device=q.device)[:, None])
    return torch.where(causal, sc, torch.full((), NEG_INF, device=q.device))


def _flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's arithmetic, vectorised over key tiles of ``block_k``:
    the running max is written in closed form (``cummax`` over the tiles'
    maxima), tile ``t``'s ``p`` is taken against it and rounded to V's
    dtype there, then rescaled by ``exp(m_t - m_last)`` -- what the online
    recurrence's chain of corrections multiplies it by. Returns out
    [B, S, Hq, D] in q's dtype and lse [B, Hq, S] in f32."""
    b, s, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    sc = _scores(q, k)  # [B, Hkv, G, S, Sk]
    pad = (-sk) % block_k
    if pad:
        sc = torch.nn.functional.pad(sc, (0, pad), value=NEG_INF)
    t = (sk + pad) // block_k
    sc = sc.reshape(b, hkv, group, s, t, block_k)
    m_run = torch.cummax(sc.amax(dim=-1), dim=-1).values  # [B,Hkv,G,S,T]
    p = torch.exp(sc - m_run[..., None])
    w = torch.exp(m_run - m_run[..., -1:])
    l = (p.sum(dim=-1) * w).sum(dim=-1)  # [B, Hkv, G, S]
    p = (p.to(v.dtype).float() * w[..., None]).reshape(b, hkv, group, s, -1)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p[..., :sk], v.float())
    out = torch.where(l[..., None] > 0, acc / l[..., None],
                      torch.zeros((), device=q.device))
    lse = torch.where(l > 0, m_run[..., -1] + torch.log(l),
                      torch.full((), float("inf"), device=q.device))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)
    return out, lse.reshape(b, hq, s)


def _flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          do: torch.Tensor, lse: torch.Tensor,
                          dvec: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV exactly per element as the kernels compute them (only
    the f32 summation order differs). ``lse`` and ``dvec = rowsum(dO *
    O)`` are [B, Hq, S] f32."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    dt = q.dtype
    scale = d ** -0.5
    lse_g = lse.reshape(b, hkv, group, s)[..., None]
    dvec_g = dvec.reshape(b, hkv, group, s)[..., None]
    p = torch.exp(_scores(q, k) - lse_g)  # [B, Hkv, G, S, Sk]
    dog = do.reshape(b, s, hkv, group, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog.float(), v.float())
    ds = (p * (dp - dvec_g) * scale).to(dt).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                      q.reshape(b, s, hkv, group, d).float())
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(dt).float(), dog.float())
    return (dq.reshape(b, s, hq, d).to(dt), dk.to(k.dtype), dv.to(v.dtype))


def _row_dot(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, [B, Hq, S] (the reference computes it
    outside its kernels, ``flash_attention.py:286``)."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _strided_ok(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernels can read it through its strides (unit
    last stride), else a contiguous copy."""
    return x if x.stride(-1) == 1 else x.contiguous()


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, block_k: int, plain: bool):
        if plain:
            out, lse = _flash_forward_plain(q, k, v, block_k)
        else:
            q, k, v = _strided_ok(q), _strided_ok(k), _strided_ok(v)
            out, lse = _kernels.flash_fwd(q, k, v)
            flash_attention.launches["flash_fwd"] += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        dvec = _row_dot(g, out)
        if ctx.plain:
            dq, dk, dv = _flash_backward_plain(q, k, v, g, lse, dvec)
        else:
            dq = _kernels.flash_bwd_dq(q, k, v, g, lse, dvec)
            flash_attention.launches["flash_bwd_dq"] += 1
            dk, dv = _kernels.flash_bwd_dkv(q, k, v, g, lse, dvec)
            flash_attention.launches["flash_bwd_dkv"] += 1
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Causal GQA attention, [B, S, H, D] in and out, standard positions.

    CUDA tensors go through the three hand-written kernels (whose tiles
    are fixed by the kernels); CPU tensors through the plain versions with
    the reference's tile rule. ``block_q`` is accepted for the reference's
    signature: no rounding depends on it."""
    del block_q
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"query heads {q.shape[2]} not a multiple of kv "
                         f"heads {k.shape[2]}")
    bk = _pick_block(block_k or DEFAULT_BLOCK_K, k.shape[1])
    return _FlashAttention.apply(q, k, v, bk, not q.is_cuda)


flash_attention.launches = dict.fromkeys(_KERNEL_NAMES, 0)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                          ) -> torch.Tensor:
    """The plain versions behind the same autograd Function, on any
    device, at the key tile of the kernel that would run for q. For
    comparisons with the kernels (``chip_smoke.py``); the model never
    calls it."""
    return _FlashAttention.apply(
        q, k, v, kernel_block_k(q.dtype, q.shape[-1]), True)


def reset_launch_counts() -> None:
    """Zero the three kernels' launch counters."""
    for name in _KERNEL_NAMES:
        flash_attention.launches[name] = 0
