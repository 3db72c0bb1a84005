"""Ops of the port: plain PyTorch versions, and the wrappers of the
hand-written CUDA kernels in ``csrc/`` (``paged_attention.py``,
``flash_attention.py``, ``decode_gemm.py``, ``norms.py``)."""
