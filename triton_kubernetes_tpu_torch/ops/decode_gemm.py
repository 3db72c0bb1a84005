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
  up to 64 rows). It has no TPU counterpart: the JAX package computes
  these products with plain XLA matmuls. A build or launch failure
  raises; a CUDA tensor never falls back to the plain version;
* on CPU tensors it runs :func:`decode_gemm_group_plain`, the products in
  turn as the model computes each everywhere else
  (``models/llama.weight_einsum`` and ``unembed``), which the CPU tests
  hold against the JAX package.

``decode_gemm_group.launches`` counts kernel launches;
:func:`reset_launch_counts` zeroes it. Only the paged decode and verify
steps call these: prefill and training keep their ``torch.einsum``
products.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from . import _kernels


def decode_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, K] @ w [K, N] in ``out_dtype``, as the model computes it off
    the decode path: the product of the activation-dtype operands in their
    dtype, or, for f32 out (the lm head), accumulated and kept in f32."""
    if out_dtype == x.dtype:
        return torch.mm(x, w)
    if out_dtype != torch.float32:
        raise ValueError(f"decode_gemm: out_dtype {out_dtype} must be x's "
                         f"dtype {x.dtype} or float32")
    if x.is_cuda:
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
    M: one kernel launch per 64 rows on CUDA tensors, the plain version on
    CPU tensors."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if not x.is_cuda:
        return decode_gemm_group_plain(x, ws, out_dtype)
    m, rows = x.shape[0], _kernels.MAX_GEMM_ROWS
    ys = [torch.empty((m, w.shape[1]), dtype=out_dtype, device=x.device)
          for w in ws]
    for r0 in range(0, m, rows):
        _kernels.decode_gemm(x[r0:r0 + rows], ws,
                             [y[r0:r0 + rows] for y in ys])
        decode_gemm_group.launches += 1
    return ys


decode_gemm_group.launches = 0


def decode_gemm(x: torch.Tensor, w: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [M, K] @ w [K, N] -> [M, N]: :func:`decode_gemm_group` of one."""
    return decode_gemm_group(x, [w], out_dtype)[0]


def reset_launch_counts() -> None:
    """Zero the kernel's launch counter."""
    decode_gemm_group.launches = 0
