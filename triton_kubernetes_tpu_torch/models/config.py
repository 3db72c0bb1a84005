"""Model configuration registry -- the port's copy of
``triton_kubernetes_tpu/models/config.py``.

The same fields, validation and six registered configs, as data. The one
difference: ``activation_dtype`` and ``weight_dtype`` return ``torch``
dtypes.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict

import torch

_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ("bfloat16", "float32", ...)."""
    if name not in _TORCH_DTYPES:
        raise ValueError(
            f"dtype must be one of {sorted(_TORCH_DTYPES)}, got {name!r}")
    return _TORCH_DTYPES[name]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    embed_dim: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    mlp_dim: int
    max_seq_len: int
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    # MoE (num_experts == 0 -> dense SwiGLU MLP)
    num_experts: int = 0
    num_selected: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    moe_dispatch: str = "auto"
    # Numerics / compile shape
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"  # master weights (training)
    remat: bool = True
    remat_policy: str = "full"
    # "auto" picks the hand-written kernels for CUDA tensors and the plain
    # versions for CPU tensors; "dense" forces the plain versions.
    attention: str = "auto"
    weight_quant: str = "none"
    matmul_dtype: str = "auto"

    def __post_init__(self):
        if self.remat_policy not in ("none", "full", "dots"):
            raise ValueError(
                f"remat_policy must be 'none', 'full', or 'dots', got "
                f"{self.remat_policy!r}")
        if self.attention not in ("auto", "dense", "flash",
                                  "flash-interpret"):
            raise ValueError(
                f"attention must be 'auto', 'dense', 'flash', or "
                f"'flash-interpret', got {self.attention!r}")
        if self.moe_dispatch not in ("auto", "dense", "sort"):
            raise ValueError(
                f"moe_dispatch must be 'auto', 'dense', or 'sort', got "
                f"{self.moe_dispatch!r}")
        if self.weight_quant not in ("none", "int8", "fp8"):
            raise ValueError(
                f"weight_quant must be 'none', 'int8', or 'fp8', got "
                f"{self.weight_quant!r}")
        if self.matmul_dtype not in ("auto", "f32", "int8", "fp8"):
            raise ValueError(
                f"matmul_dtype must be 'auto', 'f32', 'int8', or 'fp8', "
                f"got {self.matmul_dtype!r}")
        if self.matmul_dtype in ("int8", "fp8") \
                and self.weight_quant != self.matmul_dtype:
            raise ValueError(
                f"matmul_dtype {self.matmul_dtype!r} needs weights stored "
                f"in the same dtype (weight_quant is {self.weight_quant!r})")
    scan_layers: bool = True
    fused_ce: bool = False
    ce_chunk: int = 8192

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def num_params(self) -> int:
        """Total parameter count (all experts counted)."""
        d, v = self.embed_dim, self.vocab_size
        attn = d * self.head_dim * (
            self.num_heads * 2 + self.num_kv_heads * 2)
        if self.is_moe:
            mlp = self.num_experts * 3 * d * self.mlp_dim + d * self.num_experts
        else:
            mlp = 3 * d * self.mlp_dim
        norms = 2 * d
        per_layer = attn + mlp + norms
        return v * d * 2 + self.num_layers * per_layer + d

    def active_params(self) -> int:
        """Params touched per token (MoE: only selected experts)."""
        if not self.is_moe:
            return self.num_params()
        d = self.embed_dim
        inactive = (self.num_experts - self.num_selected) * 3 * d * self.mlp_dim
        return self.num_params() - self.num_layers * inactive


CONFIGS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


LLAMA3_8B = _register(ModelConfig(
    name="llama3-8b", vocab_size=128_256, embed_dim=4096, num_layers=32,
    num_heads=32, num_kv_heads=8, head_dim=128, mlp_dim=14_336,
    max_seq_len=8192))

LLAMA3_70B = _register(ModelConfig(
    name="llama3-70b", vocab_size=128_256, embed_dim=8192, num_layers=80,
    num_heads=64, num_kv_heads=8, head_dim=128, mlp_dim=28_672,
    max_seq_len=8192))

MIXTRAL_8X7B = _register(ModelConfig(
    name="mixtral-8x7b", vocab_size=32_000, embed_dim=4096, num_layers=32,
    num_heads=32, num_kv_heads=8, head_dim=128, mlp_dim=14_336,
    max_seq_len=32_768, rope_theta=1_000_000.0,
    num_experts=8, num_selected=2))

LLAMA3_BENCH = _register(ModelConfig(
    name="llama3-bench", vocab_size=32_768, embed_dim=1024, num_layers=24,
    num_heads=8, num_kv_heads=4, head_dim=128, mlp_dim=4096,
    max_seq_len=2048, remat_policy="dots", fused_ce=True,
    attention="flash"))

LLAMA_TEST = _register(ModelConfig(
    name="llama-test", vocab_size=256, embed_dim=64, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=16, mlp_dim=128,
    max_seq_len=128, dtype="float32", remat=False))

MIXTRAL_TEST = _register(ModelConfig(
    name="mixtral-test", vocab_size=256, embed_dim=64, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=16, mlp_dim=128,
    max_seq_len=128, num_experts=4, num_selected=2,
    dtype="float32", remat=False))


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown model {name!r}; know {sorted(CONFIGS)}")
    cfg = CONFIGS[name]
    return replace(cfg, **overrides) if overrides else cfg
