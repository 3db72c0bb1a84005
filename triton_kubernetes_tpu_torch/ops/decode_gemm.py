"""Row-invariant weight products of the serving decode and verify steps.

The reference pins that a speculative verify row is bitwise the decode row
at the same length (``triton_kubernetes_tpu/models/paged.py``, the
``paged_verify_step`` docstring; ``tests/test_speculation.py``). A verify
step multiplies ``B * S`` rows by each weight where a decode step
multiplies ``B``, and a library GEMM picks its kernel -- tiles, and how it
splits each sum -- by the row count, so on the card the two round
differently. :func:`decode_gemm_group` gives every output row the same
bits whatever the row count, for up to three products of one input in one
launch (the decode step's wq/wk/wv, and w3/w1); :func:`decode_gemm` is
the group of one:

* on CUDA tensors it launches the hand-written ``csrc/decode_gemm.cu``
  (bf16 operands on the tensor cores with bf16 or f32 out, or f32
  operands on the CUDA cores; K split into ranges chosen by the group's
  shape alone, ``_kernels.gemm_splits``, whose f32 partial sums are added
  in one fixed order; every weight element read from HBM once a launch of
  up to 64 rows; a larger M -- a prefill window's -- on a wgmma kernel
  with the same chains of k steps, so its rows are bitwise those of
  launches of up to 64). It has no TPU counterpart: the JAX package computes
  these products with plain XLA matmuls. A build or launch failure
  raises; a CUDA tensor never falls back to the plain version;
* on CPU tensors it runs :func:`decode_gemm_group_plain`, the products in
  turn as the model computes each everywhere else
  (``models/llama.weight_einsum`` and ``unembed``), which the CPU tests
  hold against the JAX package.

W8A8 (quantized weights with ``matmul_dtype`` int8 or fp8):
:func:`w8a8_gemm_group` takes up to three products of one quantized input
(``ops.quantization.quantize_rows``) with weights stored K-contiguous,
``[N, K]`` int8 or fp8 with f32 per-column scales, through the W8A8
entries of the same source, with the same tiles and K split; an int8
row is bitwise its plain version (:func:`w8a8_gemm_group_plain`) for
any M, and an fp8 row (every M on the wgmma kernel, its operands
converted to f16) the same whatever M is.

``decode_gemm_group.launches`` and ``w8a8_gemm_group.launches`` count
kernel launches, and their ``wgmma_launches`` those that ran the wgmma
kernel (``_kernels.gemm_wgmma``); :func:`reset_launch_counts` zeroes
them. The paged
decode and verify steps and the prefill windows call these (so that a
page's bytes do not depend on the window's width); the one-shot prefill
and training keep ``torch.einsum``, except W8A8 products, which take the
kernels wherever they run on the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from . import _kernels


class _F32Product(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=float32)``, which has no derivative of
    its own, with the f32 cotangent products of the fused CE head
    (``ops/fused_ce.py``): dx = g w^T and dw = x^T g in f32, each cast to
    its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return ((g @ w.float().t()).to(x.dtype),
                (x.float().t() @ g).to(w.dtype))


def decode_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, K] @ w [K, N] in ``out_dtype``, as the model computes it off
    the decode path: the product of the activation-dtype operands in their
    dtype, or, for f32 out (the lm head), accumulated and kept in f32 --
    differentiable, so the head trains through it (the pipeline's logits)."""
    if out_dtype == x.dtype:
        return torch.mm(x, w)
    if out_dtype != torch.float32:
        raise ValueError(f"decode_gemm: out_dtype {out_dtype} must be x's "
                         f"dtype {x.dtype} or float32")
    if x.is_cuda:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _F32Product.apply(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def decode_gemm_group_plain(x: torch.Tensor, ws: Sequence[torch.Tensor],
                            out_dtype: torch.dtype) -> List[torch.Tensor]:
    """x @ w for each w of ``ws`` in turn, each :func:`decode_gemm_plain`."""
    return [decode_gemm_plain(x, w, out_dtype) for w in ws]


def decode_gemm_group(x: torch.Tensor, ws: Sequence[torch.Tensor],
                      out_dtype: Optional[torch.dtype] = None
                      ) -> List[torch.Tensor]:
    """[x [M, K] @ w [K, N_w] for w in ws] -> [M, N_w] each, in
    ``out_dtype`` (default x's dtype), at most
    ``_kernels.MAX_GEMM_PROBLEMS`` weights, each row's bits independent of
    M: one kernel launch on CUDA tensors (none for M 0), the plain version
    on CPU tensors."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if not x.is_cuda:
        return decode_gemm_group_plain(x, ws, out_dtype)
    ys = [torch.empty((x.shape[0], w.shape[1]), dtype=out_dtype,
                      device=x.device) for w in ws]
    if x.shape[0]:
        _kernels.decode_gemm(x, ws, ys)
        decode_gemm_group.launches += 1
        if _kernels.gemm_wgmma(x.dtype, x.shape[0]):
            decode_gemm_group.wgmma_launches += 1
    return ys


decode_gemm_group.launches = 0
decode_gemm_group.wgmma_launches = 0


def decode_gemm(x: torch.Tensor, w: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [M, K] @ w [K, N] -> [M, N]: :func:`decode_gemm_group` of one."""
    return decode_gemm_group(x, [w], out_dtype)[0]




def w8a8_gemm_plain(xq: torch.Tensor, x_scale: torch.Tensor,
                    wq: torch.Tensor, w_scale: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """(xq [M, K] wq [N, K]^T * x_scale[m]) * w_scale[n] in ``out_dtype``:
    an int8 product summed exactly (in f64, then int32, as the reference's
    int32 sum), an fp8 one in f32; the f32 epilogue in the reference's
    order, rounded once."""
    if xq.dtype == torch.int8:
        acc = (xq.double() @ wq.double().t()).to(torch.int32)
    else:
        acc = xq.float() @ wq.float().t()
    return ((acc.float() * x_scale[:, None]) * w_scale[None, :]
            ).to(out_dtype)


def w8a8_gemm_group_plain(xq: torch.Tensor, x_scale: torch.Tensor,
                          wqs: Sequence[torch.Tensor],
                          w_scales: Sequence[torch.Tensor],
                          out_dtype: torch.dtype) -> List[torch.Tensor]:
    """:func:`w8a8_gemm_plain` of each weight in turn."""
    return [w8a8_gemm_plain(xq, x_scale, w, s, out_dtype)
            for w, s in zip(wqs, w_scales)]


def w8a8_gemm_group(xq: torch.Tensor, x_scale: torch.Tensor,
                    wqs: Sequence[torch.Tensor],
                    w_scales: Sequence[torch.Tensor],
                    out_dtype: torch.dtype) -> List[torch.Tensor]:
    """[(xq [M, K] w [N_w, K]^T * x_scale) * s for w, s] -> [M, N_w] each
    in ``out_dtype``, at most ``_kernels.MAX_GEMM_PROBLEMS`` weights: one
    kernel launch on CUDA tensors (none for M 0), the plain version on CPU
    tensors."""
    if not xq.is_cuda:
        return w8a8_gemm_group_plain(xq, x_scale, wqs, w_scales, out_dtype)
    ys = [torch.empty((xq.shape[0], w.shape[0]), dtype=out_dtype,
                      device=xq.device) for w in wqs]
    if xq.shape[0]:
        _kernels.decode_gemm_w8a8(xq, x_scale, wqs, w_scales, ys)
        w8a8_gemm_group.launches += 1
        if _kernels.gemm_wgmma(xq.dtype, xq.shape[0]):
            w8a8_gemm_group.wgmma_launches += 1
    return ys


w8a8_gemm_group.launches = 0
w8a8_gemm_group.wgmma_launches = 0


def reset_launch_counts() -> None:
    """Zero the launch counters."""
    decode_gemm_group.launches = 0
    decode_gemm_group.wgmma_launches = 0
    w8a8_gemm_group.launches = 0
    w8a8_gemm_group.wgmma_launches = 0
