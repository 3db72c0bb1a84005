"""The Llama-3 dense family and the Mixtral MoE family in PyTorch: config
registry, model, contiguous prefill and sampling, and the paged
prefill/decode/verify/rewind the serving engine runs (the port of
``triton_kubernetes_tpu/models``)."""

from .config import CONFIGS, ModelConfig, get_config
from .generate import (
    KVCache,
    decode_step,
    generate,
    init_cache,
    prefill,
    sample_token,
)
from .llama import (
    Llama,
    QuantizedWeight,
    from_numpy_params,
    init_params,
    quantize_weights,
    to_numpy_params,
)
from .paged import (
    PagedKVCache,
    VerifyUndo,
    init_paged_cache,
    paged_decode_step,
    paged_prefill,
    paged_prefill_chunk,
    paged_rewind,
    paged_verify_step,
)
from . import mixtral

__all__ = [
    "CONFIGS",
    "ModelConfig",
    "get_config",
    "Llama",
    "QuantizedWeight",
    "init_params",
    "from_numpy_params",
    "to_numpy_params",
    "quantize_weights",
    "mixtral",
    "KVCache",
    "init_cache",
    "prefill",
    "decode_step",
    "generate",
    "sample_token",
    "PagedKVCache",
    "init_paged_cache",
    "paged_prefill",
    "paged_prefill_chunk",
    "paged_decode_step",
    "VerifyUndo",
    "paged_verify_step",
    "paged_rewind",
]
