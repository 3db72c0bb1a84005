"""RMSNorm in f32 whatever the input dtype, cast back on the way out --
the port of ``triton_kubernetes_tpu/ops/norms.py``.

:func:`rms_norm` is the plain version, used everywhere but the serving
decode and verify steps. Those call :func:`rms_norm_rows`, which on CUDA
tensors launches the hand-written ``csrc/rms_norm.cu``: torch's reduction
splits a row's sum by the number of rows in the call, so a verify step's
``B * S`` rows would round differently from a decode step's ``B``, where
the reference pins them bitwise equal. The kernel takes each row's sum in
one fixed order. On CPU tensors :func:`rms_norm_rows` runs
:func:`rms_norm`; a CUDA tensor never falls back to it.
``rms_norm_rows.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _kernels


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


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


def reset_launch_counts() -> None:
    """Zero the kernel's launch counter."""
    rms_norm_rows.launches = 0
