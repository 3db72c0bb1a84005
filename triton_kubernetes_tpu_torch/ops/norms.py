"""RMSNorm in f32 whatever the input dtype, cast back on the way out --
the port of ``triton_kubernetes_tpu/ops/norms.py`` -- and the residual add
fused with the norm that follows it.

:func:`rms_norm` is the plain version, used by training and the one-shot
prefill. The serving decode, verify and prefill-window steps call
:func:`rms_norm_rows` (the first layer's attention norm) and
:func:`add_rms_norm_rows` (every later layer boundary: ``h = x + delta``
and the norm of h), which on CUDA tensors launch the hand-written
``csrc/rms_norm.cu``: torch's reduction splits a row's sum by the number
of rows in the call, so a verify step's ``B * S`` rows would round
differently from a decode step's ``B``, where the reference pins them
bitwise equal. The kernel takes each row's sum in one fixed order, and one
launch does a layer boundary's add and norm. On CPU tensors both run their
plain versions (:func:`rms_norm`, :func:`add_rms_norm`); a CUDA tensor
never falls back to them. ``rms_norm_rows.launches`` and
``add_rms_norm_rows.launches`` count kernel launches.

Where the norm's output feeds W8A8 products only, the steps call
:func:`rms_norm_quant_rows` and :func:`add_rms_norm_quant_rows` instead:
the same kernel with kernel A, the per-token quantizer, as its epilogue
(``rms_norm_quant_kernel``), which hands the product
``ops.quantization.QuantizedRows`` and never writes the norm's output --
bitwise the entries above followed by ``quantize_rows_plain``. Their plain
versions (:func:`rms_norm_quant_plain`, :func:`add_rms_norm_quant_plain`)
are the plain norms followed by ``quantize_rows_plain``; they count
launches as ``.launches`` too.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels
from .quantization import QuantizedRows, quantize_rows_plain


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def add_rms_norm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, y): the residual sum h = x + delta and :func:`rms_norm` of h."""
    h = x + delta
    return h, rms_norm(h, scale, eps)


def rms_norm_rows(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """:func:`rms_norm` over the last dim, each row's bits independent of
    how many rows the call holds: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if not x.is_cuda:
        return rms_norm(x, scale, eps)
    if x.numel() == 0:
        return torch.empty_like(x)
    y = _kernels.rms_norm(x.reshape(-1, x.shape[-1]).contiguous(), scale,
                          eps)
    rms_norm_rows.launches += 1
    return y.reshape(x.shape)


rms_norm_rows.launches = 0


def add_rms_norm_rows(x: torch.Tensor, delta: torch.Tensor,
                      scale: torch.Tensor, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`add_rms_norm` over the last dim, each row's bits independent
    of how many rows the call holds: one kernel launch on CUDA tensors
    (which must be contiguous: it raises rather than copy), the plain
    version on CPU tensors. h is bitwise ``x + delta`` either way."""
    if not x.is_cuda:
        return add_rms_norm(x, delta, scale, eps)
    if x.numel() == 0:
        return torch.empty_like(x), torch.empty_like(x)
    d = x.shape[-1]
    h, y = _kernels.add_rms_norm(x.view(-1, d), delta.view(-1, d), scale,
                                 eps)
    add_rms_norm_rows.launches += 1
    return h.view(x.shape), y.view(x.shape)


add_rms_norm_rows.launches = 0


def _quantized(y: torch.Tensor, dtype: torch.dtype) -> QuantizedRows:
    xq, x_scale = quantize_rows_plain(y.reshape(-1, y.shape[-1]), dtype)
    return QuantizedRows(xq, x_scale, tuple(y.shape[:-1]))


def rms_norm_quant_plain(x: torch.Tensor, scale: torch.Tensor, eps: float,
                         dtype: torch.dtype) -> QuantizedRows:
    """:func:`rms_norm` of x, its rows quantized to ``dtype`` by
    ``quantize_rows_plain``."""
    return _quantized(rms_norm(x, scale, eps), dtype)


def add_rms_norm_quant_plain(x: torch.Tensor, delta: torch.Tensor,
                             scale: torch.Tensor, eps: float,
                             dtype: torch.dtype
                             ) -> Tuple[torch.Tensor, QuantizedRows]:
    """(h, the norm of h quantized): :func:`add_rms_norm`, its y's rows
    quantized to ``dtype`` by ``quantize_rows_plain``."""
    h, y = add_rms_norm(x, delta, scale, eps)
    return h, _quantized(y, dtype)


def rms_norm_quant_rows(x: torch.Tensor, scale: torch.Tensor, eps: float,
                        dtype: torch.dtype) -> QuantizedRows:
    """:func:`rms_norm_rows` quantized per row to ``dtype`` (int8 or
    float8_e4m3fn) for a W8A8 product: one kernel launch on CUDA tensors,
    bitwise ``quantize_rows_plain`` of :func:`rms_norm_rows`; the plain
    version on CPU tensors."""
    if not x.is_cuda:
        return rms_norm_quant_plain(x, scale, eps, dtype)
    _, xq, x_scale = _kernels.add_rms_norm_quant(
        x.reshape(-1, x.shape[-1]).contiguous(), None, scale, eps, dtype)
    rms_norm_quant_rows.launches += 1
    return QuantizedRows(xq, x_scale, tuple(x.shape[:-1]))


rms_norm_quant_rows.launches = 0


def add_rms_norm_quant_rows(x: torch.Tensor, delta: torch.Tensor,
                            scale: torch.Tensor, eps: float,
                            dtype: torch.dtype
                            ) -> Tuple[torch.Tensor, QuantizedRows]:
    """:func:`add_rms_norm_rows` with the norm's output quantized per row
    to ``dtype`` for a W8A8 product, and not formed as a tensor: (h, the
    quantized rows), one kernel launch on CUDA tensors (contiguous: it
    raises rather than copy), bitwise h and ``quantize_rows_plain`` of y of
    :func:`add_rms_norm_rows`; the plain version on CPU tensors."""
    if not x.is_cuda:
        return add_rms_norm_quant_plain(x, delta, scale, eps, dtype)
    d = x.shape[-1]
    h, xq, x_scale = _kernels.add_rms_norm_quant(
        x.view(-1, d), delta.view(-1, d), scale, eps, dtype)
    add_rms_norm_quant_rows.launches += 1
    return h.view(x.shape), QuantizedRows(xq, x_scale, tuple(x.shape[:-1]))


add_rms_norm_quant_rows.launches = 0


def reset_launch_counts() -> None:
    """Zero the norms' kernel launch counters."""
    rms_norm_rows.launches = 0
    add_rms_norm_rows.launches = 0
    rms_norm_quant_rows.launches = 0
    add_rms_norm_quant_rows.launches = 0
