"""Llama-3-family decoder as a PyTorch ``nn.Module`` -- the port of
``triton_kubernetes_tpu/models/llama.py`` for the serving path.

Weights keep the JAX package's layouts (``wq [D, H, Dh]``, ``wo [H, Dh,
D]``, ``w1 [D, F]``, ...), so a JAX parameter tree maps onto the module one
to one (:func:`from_numpy_params`). They are stored in the activation dtype:
the JAX package keeps f32 master weights and casts them at every use, which
gives the same matmul operand at twice the memory.

The block math is split as in the reference -- :func:`_qkv`, attention (the
caller's), :func:`project_out`, :func:`_mlp`, and :func:`unembed` -- so the
paged prefill and decode paths (``models/paged.py``) reuse it. MoE layers
and quantized weight leaves are later slices of the port and raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.norms import rms_norm
from ..ops.rotary import apply_rotary, rotary_tables
from .config import ModelConfig

_MOE_LATER = ("MoE layers are not ported yet: they come with the MoE slice "
              "of the port (ROADMAP.md)")
_QUANT_LATER = ("quantized weights are not ported yet: they come with the "
                "quantized-pool and W8A8 slice of the port (ROADMAP.md)")


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere;
    asking for it on a machine without a card raises instead of quietly
    running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the port's plain versions on the CPU")
    return dev


def _buffer(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class LlamaBlock(nn.Module):
    """One decoder layer's weights, in the JAX package's layouts."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, dh, f = config.embed_dim, config.head_dim, config.mlp_dim
        h, hkv = config.num_heads, config.num_kv_heads
        self.attn_norm = _buffer((d,), dtype, device)
        self.wq = _buffer((d, h, dh), dtype, device)
        self.wk = _buffer((d, hkv, dh), dtype, device)
        self.wv = _buffer((d, hkv, dh), dtype, device)
        self.wo = _buffer((h, dh, d), dtype, device)
        self.mlp_norm = _buffer((d,), dtype, device)
        self.w1 = _buffer((d, f), dtype, device)
        self.w3 = _buffer((d, f), dtype, device)
        self.w2 = _buffer((f, d), dtype, device)


class Llama(nn.Module):
    """Embedding, ``num_layers`` :class:`LlamaBlock` s, final norm and lm
    head. Build one with :func:`init_params` or :func:`from_numpy_params`."""

    def __init__(self, config: ModelConfig, device: torch.device | str):
        super().__init__()
        if config.is_moe:
            raise NotImplementedError(_MOE_LATER)
        if config.weight_quant != "none":
            raise NotImplementedError(_QUANT_LATER)
        dev = torch.device(device)
        dtype = config.activation_dtype
        d, v = config.embed_dim, config.vocab_size
        self.config = config
        self.embed = _buffer((v, d), dtype, dev)
        self.layers = nn.ModuleList(
            LlamaBlock(config, dtype, dev) for _ in range(config.num_layers))
        self.final_norm = _buffer((d,), dtype, dev)
        self.lm_head = _buffer((d, v), dtype, dev)
        self._rotary: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def rotary(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin) tables for every position, built once per model."""
        if self._rotary is None:
            c = self.config
            self._rotary = rotary_tables(c.head_dim, c.max_seq_len,
                                         c.rope_theta, device=self.device)
        return self._rotary


def init_params(config: ModelConfig, seed: int = 0,
                device: torch.device | str = "cuda") -> Llama:
    """Normal(0.02) init, residual-out projections scaled by 1/sqrt(2L),
    norms at one -- the reference's init rule, drawn from a ``torch``
    generator on ``device`` (so the values differ from the JAX init)."""
    dev = resolve_device(device)
    model = Llama(config, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    std = 0.02
    out_std = 0.02 / (2 * config.num_layers) ** 0.5

    def fill(p: nn.Parameter, s: float) -> None:
        p.copy_(torch.randn(p.shape, generator=gen, device=dev,
                            dtype=torch.float32) * s)

    with torch.no_grad():
        fill(model.embed, std)
        for layer in model.layers:
            layer.attn_norm.fill_(1.0)
            layer.mlp_norm.fill_(1.0)
            for name in ("wq", "wk", "wv", "w1", "w3"):
                fill(getattr(layer, name), std)
            fill(layer.wo, out_std)
            fill(layer.w2, out_std)
        model.final_norm.fill_(1.0)
        fill(model.lm_head, std)
    return model


def from_numpy_params(params: Dict[str, Any], config: ModelConfig,
                      device: torch.device | str = "cuda") -> Llama:
    """The port's model from a JAX parameter tree given as numpy arrays
    (``{"embed", "layers": {name: [L, ...]}, "final_norm", "lm_head"}``,
    the stacked layout of the reference's ``init_params``). Leaves are cast
    to the activation dtype."""
    dev = resolve_device(device)
    model = Llama(config, dev)

    def put(p: nn.Parameter, arr: Any) -> None:
        if isinstance(arr, dict):
            raise NotImplementedError(_QUANT_LATER)
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(
                f"leaf shape {a.shape} != expected {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))

    with torch.no_grad():
        put(model.embed, params["embed"])
        put(model.final_norm, params["final_norm"])
        put(model.lm_head, params["lm_head"])
        stacked = params["layers"]
        for i, layer in enumerate(model.layers):
            for name, p in layer.named_parameters():
                put(p, np.asarray(stacked[name])[i])
    return model


def weight_einsum(spec: str, x: torch.Tensor, w: torch.Tensor,
                  config: ModelConfig) -> torch.Tensor:
    """One weight matmul on the reference's f32 path (``matmul_dtype``
    "auto"/"f32" over unquantized leaves): the product of the
    activation-dtype operands, in the activation dtype."""
    if config.weight_quant != "none":
        raise NotImplementedError(_QUANT_LATER)
    return torch.einsum(spec, x, w)


def _qkv(x: torch.Tensor, layer: LlamaBlock, config: ModelConfig,
         cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor):
    """Projected + rotary-encoded q/k/v for a block input ([B, S, D])."""
    h = rms_norm(x, layer.attn_norm, config.norm_eps)
    q = weight_einsum("bsd,dhk->bshk", h, layer.wq, config)
    k = weight_einsum("bsd,dhk->bshk", h, layer.wk, config)
    v = weight_einsum("bsd,dhk->bshk", h, layer.wv, config)
    q = apply_rotary(q, cos, sin, positions)
    k = apply_rotary(k, cos, sin, positions)
    return q, k, v


def _mlp(x: torch.Tensor, layer: LlamaBlock, config: ModelConfig
         ) -> torch.Tensor:
    """Post-attention half of the block: norm + dense SwiGLU. Returns the
    residual delta."""
    if config.is_moe:
        raise NotImplementedError(_MOE_LATER)
    h = rms_norm(x, layer.mlp_norm, config.norm_eps)
    gate = torch.nn.functional.silu(
        weight_einsum("bsd,df->bsf", h, layer.w3, config).float()
    ).to(x.dtype)
    up = weight_einsum("bsd,df->bsf", h, layer.w1, config)
    return weight_einsum("bsf,fd->bsd", gate * up, layer.w2, config)


def project_out(x: torch.Tensor, attn: torch.Tensor, layer: LlamaBlock,
                config: ModelConfig) -> torch.Tensor:
    """Attention output projection + residual add."""
    return x + weight_einsum("bshk,hkd->bsd", attn, layer.wo, config)


def final_norm_hidden(x: torch.Tensor, model: Llama) -> torch.Tensor:
    """The hidden states the vocab head consumes (final rms_norm)."""
    return rms_norm(x, model.final_norm, model.config.norm_eps)


def unembed(x: torch.Tensor, model: Llama) -> torch.Tensor:
    """Final norm + lm head: [B, S, D] -> f32 logits [B, S, V], the
    product accumulated in f32 and kept in f32 (the reference's
    ``preferred_element_type``), never rounded to the activation dtype."""
    h = final_norm_hidden(x, model)
    b, s, d = h.shape
    h2 = h.reshape(b * s, d)
    w = model.lm_head
    if h2.dtype == torch.float32:
        out = h2 @ w
    elif h2.is_cuda:
        out = torch.mm(h2, w, out_dtype=torch.float32)
    else:
        out = h2.float() @ w.float()
    return out.reshape(b, s, -1)
