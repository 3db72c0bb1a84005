"""Weight and KV-page quantization -- the port of
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

The weight half: :func:`quantize_channelwise` stores a weight per output
channel (exact amax, no headroom), and :func:`quantized_einsum` contracts
with it in low precision, W8A8 -- the activation quantized per token
(amax over its contraction axes), an int8 x int8 product summed in int32
or an fp8 x fp8 product summed in f32, and both scales folded in an f32
epilogue, ``(acc * x_scale) * w_scale``. CPU tensors run the plain
versions, the reference's steps. On CUDA tensors :func:`quantize_rows` launches the
hand-written ``csrc/quantize_rows.cu`` (kernel A, the per-token
quantizer, bitwise its plain version :func:`quantize_rows_plain`) and the
product the W8A8 entries of ``csrc/decode_gemm.cu``
(``ops.decode_gemm.w8a8_gemm_group``); there is no fallback to the plain
versions and no library product. Kernel A also runs inside the kernel
that produces a product's input, which then hands the product
:class:`QuantizedRows` rather than bf16 rows: the norms
(``ops.norms.rms_norm_quant_rows``, ``add_rms_norm_quant_rows``) and
:func:`swiglu_quantize_rows`, w2's input in one pass; each is bitwise its
producer followed by :func:`quantize_rows_plain`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from . import _kernels
from .decode_gemm import w8a8_gemm_group

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


class Fp8UnavailableError(RuntimeError):
    """This torch build has no ``float8_e4m3fn``: a typed failure for
    ``kv_dtype``/``weight_dtype`` "fp8", never a fallback to another
    dtype."""


def fp8_supported() -> bool:
    """Whether this torch has ``float8_e4m3fn``."""
    return hasattr(torch, "float8_e4m3fn")


def fp8_dtype() -> torch.dtype:
    """``float8_e4m3fn``, or :class:`Fp8UnavailableError`."""
    if not fp8_supported():
        raise Fp8UnavailableError(
            "this torch build has no float8_e4m3fn dtype; kv_dtype/"
            "weight_dtype fp8 need it (int8 and bf16 remain available)")
    return torch.float8_e4m3fn


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


# --------------------------------------------------------------------------
# Weights: per-channel storage and quantized arithmetic (matmul_dtype).


def _scale_of(amax: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """max(amax / qmax, MIN_SCALE), the division IEEE's: on CUDA tensors
    torch divides by a Python number as a multiply by its reciprocal,
    which can round differently, so qmax is a tensor on amax's device."""
    qmax = torch.tensor(qmax_for(dtype), device=amax.device)
    return torch.clamp(amax / qmax, min=MIN_SCALE)


def quantize_channelwise(x: torch.Tensor,
                         axis: Union[int, Tuple[int, ...]],
                         dtype: torch.dtype = torch.int8,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric quantization: scale = max(amax over ``axis`` /
    qmax, MIN_SCALE). Returns (values in ``dtype``, f32 scale with ``axis``
    kept as size-1 dims)."""
    amax = x.float().abs().amax(dim=axis, keepdim=True)
    scale = _scale_of(amax, dtype)
    return quantize_with_scale(x, scale, dtype), scale


def quantize_int8(x: torch.Tensor, axis: Union[int, Tuple[int, ...]],
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_channelwise` to int8."""
    return quantize_channelwise(x, axis, torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """``q * scale`` in f32, cast to ``dtype``."""
    return (q.float() * scale).to(dtype)


def resolve_matmul_dtype(mode: str, weight_quant: str,
                         platform: Optional[str] = None) -> str:
    """A ``matmul_dtype`` knob as an arithmetic path: ``"f32"`` (dequantize,
    then the full-precision product) or ``"int8"``/``"fp8"`` (W8A8).
    ``"auto"`` picks quantized arithmetic only on ``platform == "tpu"``
    over quantized storage, as the reference does; the port runs on "gpu"
    or "cpu" (the default: "gpu" where a card is visible), so ``auto`` is
    the dequantize path here. Explicit int8/fp8 need matching storage."""
    if platform is None:
        platform = "gpu" if torch.cuda.is_available() else "cpu"
    if mode == "f32":
        return "f32"
    if mode in ("int8", "fp8"):
        if weight_quant != mode:
            raise ValueError(
                f"matmul_dtype {mode!r} needs weights stored in the same "
                f"dtype (weight_quant is {weight_quant!r}); quantize the "
                f"weights first (weight_dtype {mode!r})")
        if mode == "fp8":
            fp8_dtype()
        return mode
    if mode == "auto":
        if platform == "tpu" and weight_quant in ("int8", "fp8"):
            return weight_quant
        return "f32"
    raise ValueError(f"unknown matmul_dtype {mode!r}; "
                     f"know ('auto', 'f32', 'int8', 'fp8')")


def _parse_weight_spec(spec: str):
    """Split ``"x,w->out"`` into (x letters, w letters, contraction letters,
    x batch letters, w output letters); raises for anything but a weight
    matmul (out = x's batch letters, then w's output letters)."""
    lhs, out = spec.replace(" ", "").split("->")
    x_sub, w_sub = lhs.split(",")
    contract = tuple(c for c in x_sub if c in w_sub)
    if not contract:
        raise ValueError(f"spec {spec!r} has no contraction")
    x_batch = tuple(c for c in x_sub if c not in contract)
    w_out = tuple(c for c in w_sub if c not in contract)
    if out != "".join(x_batch) + "".join(w_out):
        raise ValueError(
            f"spec {spec!r} is not a weight matmul (want out = x-batch "
            f"letters then w-output letters)")
    if len(set(x_sub)) != len(x_sub) or len(set(w_sub)) != len(w_sub):
        raise ValueError(f"spec {spec!r} repeats a letter within an operand")
    return x_sub, w_sub, contract, x_batch, w_out


def quantize_rows_plain(x: torch.Tensor, dtype: torch.dtype
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token quantization of x [M, K]: (xq [M, K] in ``dtype``, x_scale
    [M] f32), each row's scale max(amax / qmax, MIN_SCALE) -- the
    activation half of :func:`quantized_einsum`, and the plain version of
    ``csrc/quantize_rows.cu``."""
    xf = x.float()
    scale = _scale_of(xf.abs().amax(dim=-1, keepdim=True), dtype)
    return quantize_with_scale(xf, scale, dtype), scale[..., 0]


class QuantizedRows(NamedTuple):
    """Rows quantized per token for a W8A8 product: xq [M, K] (int8 or
    float8_e4m3fn) and x_scale [M] f32, of rows whose leading shape was
    ``lead`` (M its product)."""
    xq: torch.Tensor
    x_scale: torch.Tensor
    lead: Tuple[int, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.xq.dtype

    def positions(self, lo: int, hi: int) -> "QuantizedRows":
        """The rows at positions lo .. hi - 1 of the second leading dim
        (``rows[:, lo:hi]`` of rows [B, S, K]): bitwise the quantization of
        those rows alone, since each row is quantized by itself."""
        b, s = self.lead
        k = self.xq.shape[-1]
        return QuantizedRows(
            self.xq.view(b, s, k)[:, lo:hi].reshape(-1, k),
            self.x_scale.view(b, s)[:, lo:hi].reshape(-1), (b, hi - lo))


def quantize_rows(x: torch.Tensor, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_rows_plain` of x [M, K] (bf16 or f32) to int8 or
    fp8: one launch of ``csrc/quantize_rows.cu`` on CUDA tensors, bitwise
    the plain version, which CPU tensors run."""
    if not x.is_cuda:
        return quantize_rows_plain(x, dtype)
    xq, scale = _kernels.quantize_rows(x, dtype)
    quantize_rows.launches += 1
    return xq, scale


quantize_rows.launches = 0


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """w2's input, as the reference forms it: ``silu(gate)`` in f32,
    rounded to the activation dtype, times up."""
    return torch.nn.functional.silu(gate.float()).to(gate.dtype) * up


def swiglu_quantize_rows_plain(gate: torch.Tensor, up: torch.Tensor,
                               dtype: torch.dtype) -> QuantizedRows:
    """:func:`swiglu` of gate and up [..., F], then
    :func:`quantize_rows_plain` of its rows: the plain version of the fused
    SwiGLU entry of ``csrc/quantize_rows.cu``."""
    p = swiglu(gate, up)
    xq, x_scale = quantize_rows_plain(p.reshape(-1, p.shape[-1]), dtype)
    return QuantizedRows(xq, x_scale, tuple(p.shape[:-1]))


def swiglu_quantize_rows(gate: torch.Tensor, up: torch.Tensor,
                         dtype: torch.dtype) -> QuantizedRows:
    """w2's quantized input from gate and up [..., F] (the w3 and w1
    products, bf16 or f32): one launch of the fused SwiGLU entry on CUDA
    tensors (contiguous: it raises rather than copy), bitwise
    :func:`swiglu_quantize_rows_plain`, which CPU tensors run."""
    if not gate.is_cuda:
        return swiglu_quantize_rows_plain(gate, up, dtype)
    f = gate.shape[-1]
    xq, x_scale = _kernels.swiglu_quant(gate.view(-1, f), up.view(-1, f),
                                        dtype)
    swiglu_quantize_rows.launches += 1
    return QuantizedRows(xq, x_scale, tuple(gate.shape[:-1]))


swiglu_quantize_rows.launches = 0


def reset_launch_counts() -> None:
    """Zero the quantizers' launch counters."""
    quantize_rows.launches = 0
    swiglu_quantize_rows.launches = 0


def w8a8_rows(x: Union[torch.Tensor, QuantizedRows],
              qs: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
              out_dtype: torch.dtype) -> list:
    """W8A8 products of x with up to three weights of one dtype, each
    stored K-contiguous (q [N, K], scale [N] f32): x's rows [M, K]
    quantized once -- bf16 or f32 rows by :func:`quantize_rows`;
    :class:`QuantizedRows` as they come -- then ``(acc * x_scale[m]) *
    scale[n]`` in ``out_dtype`` for each weight, in one
    ``w8a8_gemm_group`` call."""
    if isinstance(x, QuantizedRows):
        if x.dtype != qs[0].dtype:
            raise ValueError(f"w8a8_rows: rows quantized to {x.dtype} for "
                             f"weights of {qs[0].dtype}")
        xq, x_scale = x.xq, x.x_scale
    else:
        xq, x_scale = quantize_rows(x, qs[0].dtype)
    return w8a8_gemm_group(xq, x_scale, qs, scales, out_dtype)


def quantized_einsum(spec: str, x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``einsum(spec, x, q * scale)`` without the dequantization: x
    quantized per token to ``q.dtype`` over its contraction axes, an int8
    product summed in int32 (fp8: f32), then ``(acc * x_scale) * w_scale``
    in f32, cast to ``out_dtype`` (default x's). ``q``/``scale`` are a
    :func:`quantize_channelwise` pair (scale size 1 along the contraction
    axes); the spec contracts x's trailing axes with q's leading ones, in
    order. The product is :func:`w8a8_rows` on x as rows and q stored
    K-contiguous (a transposed copy of q each call; the model keeps its
    weights stored so, see ``models.llama.QuantizedWeight``)."""
    x_sub, w_sub, contract, x_batch, w_out = _parse_weight_spec(spec)
    for a in (w_sub.index(c) for c in contract):
        if scale.shape[a] != 1:
            raise ValueError(
                f"scale shape {tuple(scale.shape)} is not per-output-channel "
                f"for spec {spec!r} (contraction axis {a} must be size 1)")
    nc = len(contract)
    if (x_sub[len(x_sub) - nc:] != "".join(contract)
            or w_sub[:nc] != "".join(contract)):
        raise ValueError(
            f"spec {spec!r}: quantized_einsum takes x's trailing axes "
            f"contracted with the weight's leading ones, in order")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    k = q.shape[:nc].numel()
    y = w8a8_rows(x.reshape(-1, k).contiguous(),
                  [q.reshape(k, -1).t().contiguous()],
                  [scale.float().reshape(-1).contiguous()], out_dtype)[0]
    return y.reshape(*x.shape[:len(x_batch)], *q.shape[nc:])
