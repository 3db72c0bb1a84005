"""Rotary position embeddings (RoPE), Llama-3 split-half convention --
the port of ``triton_kubernetes_tpu/ops/rotary.py``. Positions are
explicit, so every sequence of a ragged batch rotates at its own offset."""

from __future__ import annotations

from typing import Tuple

import torch


def rotary_tables(head_dim: int, max_positions: int,
                  theta: float = 500_000.0,
                  device: torch.device | str = "cuda",
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) f32 tables of shape [max_positions, head_dim // 2], on
    ``device`` (the card unless the caller asks for the CPU, as every entry
    of the port)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = 1.0 / torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=device), exponent)
    angles = (torch.arange(max_positions, dtype=torch.float32,
                           device=device)[:, None] * freqs[None, :])
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor,  # [B, S, H, D]
                 cos: torch.Tensor,  # [max_pos, D // 2]
                 sin: torch.Tensor,
                 positions: torch.Tensor,  # [B, S] int
                 ) -> torch.Tensor:
    """Rotate the pairs (x[..., :D/2], x[..., D/2:]) in f32, cast back."""
    c = cos[positions][:, :, None, :]  # [B, S, 1, D//2]
    s = sin[positions][:, :, None, :]
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
