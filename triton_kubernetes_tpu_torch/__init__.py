"""PyTorch/CUDA port of the triton_kubernetes_tpu workload stack.

The JAX package (``triton_kubernetes_tpu``) is the reference; this package
mirrors its module paths and public names so each module's counterpart is
easy to find. It imports ``torch``, ``numpy`` and the standard library only
-- never ``jax`` and nothing of the JAX package, which is why it keeps its
own copies of the few jax-free pieces it needs (``constants.py``,
``utils/metrics.py``, ``serve/blocks.py``).

Slice 1 is the paged serving path: ``serve.ServeEngine`` running chunked
prefill with the prefix cache and batched ragged decode, over two
hand-written Hopper kernels in ``csrc/`` (``ops/paged_attention.py`` holds
their wrappers and plain versions). Slice 2 is training on one card:
``python -m triton_kubernetes_tpu_torch.train`` (``train/``), over the
flash-attention forward and backward kernels (``ops/flash_attention.py``)
and the fused cross-entropy head. Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
