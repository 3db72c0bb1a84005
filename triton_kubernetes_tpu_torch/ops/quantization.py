"""KV-page quantization -- the port of the KV half of
``triton_kubernetes_tpu/ops/quantization.py``.

Quantized pools store K/V pages as int8 or float8_e4m3fn with one f32 scale
per (page, KV head). Scales are **anchored**: a page's scale is a function
of its slot-0 token only (:func:`token_kv_scale`), so a page filled by one
whole-page prefill write (:func:`quantize_kv_pages`) and the same page
filled token by token by decode writes (:func:`quantize_with_scale` against
the stored scale) hold the same bytes for the same token values.

Symmetric quantization (no zero point): ``q = clip(round(x / scale))``
for int8, ``cast(clip(x / scale))`` for fp8. The clip comes before the fp8
cast because float8_e4m3fn has no infinity and overflows to NaN. int8
rounds half to even, as ``torch.round`` and ``jnp.round`` both do, so these
functions give the JAX package's bytes exactly.

The weight half (per-channel weight quantization, quantized matmuls) comes
with the W8A8 slice of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Symmetric int8 range: +-127, never -128.
INT8_MAX = 127.0
# float8_e4m3fn's largest finite value; the quantizer clips to it before
# the cast, which would otherwise give NaN.
FP8_MAX = 448.0
# Anchored scales quantize later tokens against the first token's
# amplitude; 2x headroom halves the clamp probability for one bit.
KV_SCALE_HEADROOM = 2.0
# Floor on every scale: an all-zero anchor must not give a 0 scale.
MIN_SCALE = 1e-8

FP8_DTYPE = torch.float8_e4m3fn
KV_QUANT_DTYPES = {"int8": torch.int8, "fp8": FP8_DTYPE}


def qmax_for(dtype: torch.dtype) -> float:
    """Largest representable quantized magnitude of a storage dtype."""
    if dtype == torch.int8:
        return INT8_MAX
    if dtype == FP8_DTYPE:
        return FP8_MAX
    raise ValueError(f"no quantized range for dtype {dtype}")


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor,
                        dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Symmetric quantization against a broadcastable f32 ``scale``:
    int8 ``clip(round(x / scale), -127, 127)``; fp8 ``clip(x / scale,
    -448, 448)`` cast (the cast rounds to nearest)."""
    qmax = qmax_for(dtype)
    q = x.float() / scale
    if dtype == torch.int8:
        q = torch.round(q)
    return torch.clamp(q, -qmax, qmax).to(dtype)


def token_kv_scale(kv: torch.Tensor,
                   dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Anchor scale of one token's K or V: [..., Hkv, D] -> f32 [..., Hkv],
    ``max(amax over D * HEADROOM / qmax, MIN_SCALE)``."""
    amax = kv.float().abs().amax(dim=-1)
    return torch.clamp(amax * KV_SCALE_HEADROOM / qmax_for(dtype),
                       min=MIN_SCALE)


def quantize_kv_pages(pages: torch.Tensor, dtype: torch.dtype = torch.int8,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-page anchored quantization: exact [..., Hkv, bs, D] pages ->
    (quantized pages in ``dtype``, f32 scales [..., Hkv]), each page's
    scale taken from its slot 0."""
    scale = token_kv_scale(pages[..., :, 0, :], dtype)
    return quantize_with_scale(pages, scale[..., None, None], dtype), scale


def kv_quant_error(q: torch.Tensor, scale: torch.Tensor,
                   exact: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar mean relative dequantization error, mean |q * scale - exact|
    / mean |exact|, over the elements ``mask`` selects (all when None) --
    the source of the ``tk8s_serve_quant_error`` gauge."""
    exact = exact.float()
    err = (q.float() * scale - exact).abs()
    if mask is None:
        return err.mean() / (exact.abs().mean() + 1e-12)
    mask = mask.float()
    return (err * mask).sum() / ((exact.abs() * mask).sum() + 1e-12)
