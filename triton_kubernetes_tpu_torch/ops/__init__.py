"""Ops of the port: plain PyTorch versions, and the wrappers of the
hand-written CUDA kernels in ``csrc/`` (``paged_attention.py``,
``flash_attention.py``, ``decode_gemm.py``, ``norms.py``); the MoE layer
(``moe.py``) exported as the JAX package exports it."""

from .moe import moe_layer, sort_router, top_k_router

__all__ = ["moe_layer", "sort_router", "top_k_router"]
