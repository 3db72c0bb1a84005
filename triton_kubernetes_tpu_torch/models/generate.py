"""Contiguous-cache generation -- the port of
``triton_kubernetes_tpu/models/generate.py``.

:func:`prefill` runs a prompt through the stack with dense causal
attention and fills a contiguous ``[L, B, max_len, Hkv, Dh]`` cache in
place; the whole-prompt paged prefill (``models/paged.py``) builds on it.
:func:`decode_step` adds one token a sequence, and :func:`generate` is
prefill then ``max_new_tokens - 1`` decode steps: the plain loop the
reference pins paged decode against (its greedy tokens are the paged
engine's). Both run the model's plain ops (no kernel of their own; a
quantized model's W8A8 products take their kernels on the card).
:func:`sample_token` is greedy at temperature 0, else temperature with
top-k then top-p filtering, drawn with an explicit ``torch.Generator``
(Gumbel-max, the rule ``jax.random.categorical`` uses; the random bits
differ from JAX's).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..ops.attention import causal_attention
from . import llama
from .config import ModelConfig


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, max_len, Hkv, Dh] activation dtype
    v: torch.Tensor  # [L, B, max_len, Hkv, Dh]
    length: int  # tokens written so far


def init_cache(config: ModelConfig, batch: int, max_len: int,
               device: torch.device | str = "cuda") -> KVCache:
    dev = llama.resolve_device(device)
    shape = (config.num_layers, batch, max_len,
             config.num_kv_heads, config.head_dim)
    dt = config.activation_dtype
    return KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                   v=torch.zeros(shape, dtype=dt, device=dev), length=0)


def prefill(model: llama.Llama,
            tokens: torch.Tensor,  # [B, P] prompt
            config: ModelConfig,
            cache: KVCache,
            last_logits_only: bool = False,
            last_position: Optional[torch.Tensor] = None,  # [B]
            ) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt through the stack, writing ``cache[:, :, :P]`` in
    place. Returns (logits f32, cache) -- [B, P, V], or [B, 1, V] at the
    last position (``last_logits_only``) or at each row's own
    ``last_position``."""
    b, p = tokens.shape
    positions = torch.arange(p, device=tokens.device).expand(b, p)
    cos, sin = model.rotary()
    x = model.embed[tokens]
    for i, layer in enumerate(model.layers):
        q, k, v = llama._qkv(x, layer, config, cos, sin, positions)
        attn = causal_attention(q, k, v, positions, positions)
        x = llama.project_out(x, attn, layer, config)
        x = x + llama._mlp(x, layer, config)[0]
        cache.k[i, :, :p] = k
        cache.v[i, :, :p] = v
    if last_position is not None:
        idx = last_position.long().reshape(-1, 1, 1).expand(-1, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)  # [B, 1, D]
    elif last_logits_only:
        x = x[:, -1:, :]
    return llama.unembed(x, model, config=config), cache._replace(length=p)


def decode_step(model: llama.Llama,
                token: torch.Tensor,  # [B] the latest token
                config: ModelConfig,
                cache: KVCache,
                ) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step: writes the token's K/V at position
    ``cache.length`` in place and returns (logits [B, V] f32, cache one
    longer). Slots past the position mask themselves out (their key
    positions are later than the query's)."""
    b = token.shape[0]
    pos, max_len = cache.length, cache.k.shape[2]
    if pos >= max_len:
        raise ValueError(f"the cache is full ({max_len} positions)")
    positions = torch.full((b, 1), pos, device=token.device)
    k_positions = torch.arange(max_len, device=token.device).expand(
        b, max_len)
    cos, sin = model.rotary()
    x = model.embed[token[:, None]]  # [B, 1, D]
    for i, layer in enumerate(model.layers):
        q, k, v = llama._qkv(x, layer, config, cos, sin, positions)
        cache.k[i, :, pos:pos + 1] = k
        cache.v[i, :, pos:pos + 1] = v
        attn = causal_attention(q, cache.k[i], cache.v[i], positions,
                                k_positions)
        x = llama.project_out(x, attn, layer, config)
        x = x + llama._mlp(x, layer, config)[0]
    logits = llama.unembed(x, model, config=config)[:, 0, :]
    return logits, cache._replace(length=pos + 1)


def generate(model: llama.Llama,
             prompt: torch.Tensor,  # [B, P]
             config: ModelConfig,
             max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0,
             top_k: int = 0,
             top_p: float = 1.0,
             eos_id: Optional[int] = None,
             ) -> Dict[str, torch.Tensor]:
    """Prefill, then ``max_new_tokens - 1`` decode steps; returns
    ``{"tokens": [B, N], "done": [B]}``. Always runs every step: once a
    sequence emits ``eos_id`` its later tokens repeat eos (the done mask
    sticks). Sampling draws from ``generator`` (greedy needs none). An MoE
    config must route dropless (``capacity_factor >= num_experts /
    num_selected``), else it raises: capacity drops depend on how many
    tokens a step holds, so cached decode would leave the forward."""
    b, p = prompt.shape
    max_len = p + max_new_tokens
    if max_len > config.max_seq_len:
        raise ValueError(
            f"prompt ({p}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq_len ({config.max_seq_len})")
    if config.is_moe and (config.capacity_factor
                          < config.num_experts / config.num_selected):
        raise ValueError(
            "MoE generation needs dropless routing (capacity-based token "
            f"dropping is sequence-length-dependent, so cached decode would "
            f"diverge from the training forward): set capacity_factor >= "
            f"num_experts/num_selected = "
            f"{config.num_experts / config.num_selected}, got "
            f"{config.capacity_factor}")

    def sample(logits, done):
        tok = sample_token(logits, generator, temperature, top_k, top_p)
        if eos_id is not None:
            tok = torch.where(done, torch.full_like(tok, eos_id), tok)
            done = done | (tok == eos_id)
        return tok, done

    cache = init_cache(config, b, max_len, device=prompt.device)
    logits, cache = prefill(model, prompt, config, cache,
                            last_logits_only=True)
    tok, done = sample(logits[:, -1, :],
                       torch.zeros(b, dtype=torch.bool, device=prompt.device))
    tokens = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(model, tok, config, cache)
        tok, done = sample(logits, done)
        tokens.append(tok)
    return {"tokens": torch.stack(tokens, dim=1), "done": done}


def sample_token(logits: torch.Tensor,  # [B, V] f32
                 generator: Optional[torch.Generator],
                 temperature: float = 1.0,
                 top_k: int = 0,
                 top_p: float = 1.0) -> torch.Tensor:
    """Greedy when temperature == 0 (no generator needed); else
    temperature with optional top-k and/or top-p filtering -- top-k cuts
    first, then top-p trims the survivors' mass. Returns [B] int64."""
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        # Nucleus: keep the smallest probability-sorted prefix whose mass
        # reaches top_p; `cum - p < top_p` always keeps the top token.
        sorted_logits, order = torch.sort(logits, dim=-1, descending=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        masked = torch.where((cum - probs) < top_p, sorted_logits, neg_inf)
        logits = torch.empty_like(logits).scatter_(-1, order, masked)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel, dim=-1)
