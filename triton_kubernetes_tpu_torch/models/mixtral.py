"""The Mixtral MoE family -- the port of
``triton_kubernetes_tpu/models/mixtral.py``.

Architecturally the Llama decoder with the dense SwiGLU swapped for the
top-2-routed expert layer (``ops/moe.py``), so the implementation *is*
``models.llama`` with an MoE config (``num_experts > 0``), re-exported here
so the family has a stable import path.
"""

from __future__ import annotations

from .config import ModelConfig, get_config
from .llama import (
    Llama, forward, forward_hidden, from_numpy_params, init_params,
    remat_block, resolve_attention, to_numpy_params)

__all__ = ["Llama", "forward", "forward_hidden", "from_numpy_params",
           "init_params", "remat_block", "resolve_attention",
           "to_numpy_params", "config_8x7b", "ModelConfig"]


def config_8x7b(**overrides) -> ModelConfig:
    return get_config("mixtral-8x7b", **overrides)
