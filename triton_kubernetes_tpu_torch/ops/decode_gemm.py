"""Row-invariant weight products of the serving decode and verify steps.

The reference pins that a speculative verify row is bitwise the decode row
at the same length (``triton_kubernetes_tpu/models/paged.py``, the
``paged_verify_step`` docstring; ``tests/test_speculation.py``). A verify
step multiplies ``B * S`` rows by each weight where a decode step
multiplies ``B``, and a library GEMM picks its kernel -- tiles, and how it
splits each sum -- by the row count, so on the card the two round
differently. :func:`decode_gemm` gives every output row the same bits
whatever the row count:

* on CUDA tensors it launches the hand-written ``csrc/decode_gemm.cu``
  (bf16 operands on the tensor cores with bf16 or f32 out, or f32
  operands on the CUDA cores; f32 sums in one fixed order; every weight
  element read from HBM once a launch of up to 64 rows). It has no
  TPU counterpart: the JAX package computes these products with plain XLA
  matmuls. A build or launch failure raises; a CUDA tensor never falls
  back to the plain version;
* on CPU tensors it runs :func:`decode_gemm_plain`, the product the model
  computes everywhere else (``models/llama.weight_einsum`` and
  ``unembed``), which the CPU tests hold against the JAX package.

``decode_gemm.launches`` counts kernel launches; :func:`reset_launch_counts`
zeroes it. Only the paged decode and verify steps call it: prefill and
training keep their ``torch.einsum`` products.
"""

from __future__ import annotations

from typing import Optional

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


def decode_gemm(x: torch.Tensor, w: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [M, K] @ w [K, N] -> [M, N] in ``out_dtype`` (default x's dtype),
    each row's bits independent of M: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if not x.is_cuda:
        return decode_gemm_plain(x, w, out_dtype)
    m, rows = x.shape[0], _kernels.MAX_GEMM_ROWS
    y = torch.empty((m, w.shape[1]), dtype=out_dtype, device=x.device)
    for r0 in range(0, m, rows):
        _kernels.decode_gemm(x[r0:r0 + rows], w, y[r0:r0 + rows])
        decode_gemm.launches += 1
    return y


decode_gemm.launches = 0


def reset_launch_counts() -> None:
    """Zero the kernel's launch counter."""
    decode_gemm.launches = 0
