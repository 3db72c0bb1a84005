"""Paged-KV-cache prefill and decode for the serving engine -- the port of
``triton_kubernetes_tpu/models/paged.py`` (unquantized pools).

:class:`PagedKVCache` is a static pool of fixed-size pages,
``[L, num_blocks, Hkv, block_size, Dh]`` (head-major); per-sequence block
tables live with the scheduler (``serve/``). Page 0 is the shared trash
page (``ops.paged_attention.TRASH_PAGE``).

**The pool is updated in place.** Every entry point here writes its K/V
into ``cache.k``/``cache.v`` with ``index_copy_``/``index_put_`` and
returns only the logits; the JAX package donates the pool to ``jit`` and
rebinds the result instead. Layer ``l``'s pages are the contiguous view
``cache.k[l]``, which is what the attention kernels are handed.

Per-token math is the block split of ``models/llama.py`` with explicit
positions, so masked slots (future tokens, pad garbage, trash pages)
contribute exactly zero. The attention implementation follows
``ops.paged_attention.resolve_paged_impl``: the hand-written kernels for
CUDA tensors, the plain versions for CPU tensors, or the plain versions
everywhere with ``attention_impl="dense"`` (or ``config.attention ==
"dense"``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..constants import KV_DTYPES
from ..ops.paged_attention import (
    paged_prefill_attention,
    ragged_paged_attention,
    scatter_chunk,
    scatter_token,
)
from . import llama
from .config import ModelConfig
from .generate import init_cache, prefill

_QUANT_POOL_LATER = ("quantized KV pools (int8/fp8) are not ported yet: they "
                     "come with the quantized-pool slice of the port "
                     "(ROADMAP.md)")


@dataclass
class PagedKVCache:
    """The static page pool; block tables live with the scheduler."""

    k: torch.Tensor  # [L, num_blocks, Hkv, block_size, Dh]
    v: torch.Tensor  # [L, num_blocks, Hkv, block_size, Dh]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the K/V page arrays."""
        return (self.k.numel() * self.k.element_size()
                + self.v.numel() * self.v.element_size())

    @property
    def scale_bytes(self) -> int:
        return 0


def init_paged_cache(config: ModelConfig, num_blocks: int, block_size: int,
                     kv_dtype: str = "auto",
                     device: torch.device | str = "cuda") -> PagedKVCache:
    if num_blocks < 2:
        raise ValueError(
            f"num_blocks must be >= 2 (page 0 is the reserved trash page), "
            f"got {num_blocks}")
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    if kv_dtype in ("int8", "fp8"):
        raise NotImplementedError(_QUANT_POOL_LATER)
    dev = llama.resolve_device(device)
    dtype = torch.bfloat16 if kv_dtype == "bf16" else config.activation_dtype
    shape = (config.num_layers, num_blocks, config.num_kv_heads,
             block_size, config.head_dim)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                        v=torch.zeros(shape, dtype=dtype, device=dev))


def paged_prefill(model: llama.Llama,
                  tokens: torch.Tensor,  # [1, P] right-padded prompt
                  length: int,  # real prompt tokens (<= P)
                  config: ModelConfig,
                  cache: PagedKVCache,
                  block_table: torch.Tensor,  # [P // block_size]
                  ) -> torch.Tensor:
    """Run one right-padded prompt and land its K/V in pages (in place).
    Returns the f32 logits [V] at the last real token. Pad tokens sit at
    positions >= length, so causal masking keeps them out of every real
    position; their K/V land above ``length`` as garbage later masked."""
    _, p = tokens.shape
    bs = cache.block_size
    if p % bs != 0:
        raise ValueError(
            f"padded prompt length {p} must be a multiple of the "
            f"block size {bs} (pad the trace width, not the pages)")
    t = p // bs
    if tuple(block_table.shape) != (t,):
        raise ValueError(
            f"block_table must cover the padded prompt: expected shape "
            f"({t},), got {tuple(block_table.shape)}")
    contiguous = init_cache(config, 1, p, device=tokens.device)
    last = torch.tensor([length - 1], device=tokens.device)
    logits, contiguous = prefill(model, tokens, config, contiguous,
                                 last_position=last)
    index = block_table.long()
    for i in range(config.num_layers):
        # [1, P, Hkv, Dh] -> [T, Hkv, bs, Dh]: tokens into pages, heads
        # ahead of slots.
        for src, pool in ((contiguous.k, cache.k), (contiguous.v, cache.v)):
            pages = src[i, 0].reshape(t, bs, *src.shape[3:]).permute(0, 2, 1, 3)
            pool[i].index_copy_(0, index, pages.to(pool.dtype))
    return logits[0, 0]


def paged_prefill_chunk(model: llama.Llama,
                        tokens: torch.Tensor,  # [1, C] one right-padded window
                        offset: int,  # tokens already in pages (C-aligned)
                        chunk_len: int,  # real tokens this window (1..C)
                        config: ModelConfig,
                        cache: PagedKVCache,
                        block_table: torch.Tensor,  # [T] the FULL table
                        attention_impl: Optional[str] = None,
                        ) -> torch.Tensor:
    """One window of an incremental prefill: run ``C`` prompt tokens at
    positions ``offset .. offset+C-1``, land their K/V in this window's
    pages (in place), and attend to everything written so far. Returns the
    f32 logits [V] at row ``chunk_len - 1`` (they matter on the final
    window). Contract: ``C % block_size == 0``, ``offset`` a multiple of
    ``C`` and ``T * block_size`` a multiple of ``C``."""
    _, c = tokens.shape
    bs = cache.block_size
    t = block_table.shape[0]
    if c % bs != 0:
        raise ValueError(
            f"chunk width {c} must be a multiple of the block size {bs}")
    if (t * bs) % c != 0:
        raise ValueError(
            f"table width {t * bs} tokens must be a multiple of the "
            f"chunk width {c} (pad the table, not the chunk)")
    impl = attention_impl if attention_impl is not None else config.attention
    positions = offset + torch.arange(c, device=tokens.device)[None]
    cos, sin = model.rotary()
    x = model.embed[tokens]  # [1, C, D]
    window = block_table[offset // bs: offset // bs + c // bs]
    for i, layer in enumerate(model.layers):
        q, k, v = llama._qkv(x, layer, config, cos, sin, positions)
        kp, vp = cache.k[i], cache.v[i]
        scatter_chunk(kp, vp, k, v, window)
        attn = paged_prefill_attention(q, kp, vp, block_table, offset,
                                       impl=impl)
        x = llama.project_out(x, attn, layer, config)
        x = x + llama._mlp(x, layer, config)
    h = x[:, chunk_len - 1: chunk_len]  # unembed only the last real row
    return llama.unembed(h, model)[0, 0]


def paged_decode_step(model: llama.Llama,
                      token: torch.Tensor,  # [B] each sequence's latest token
                      config: ModelConfig,
                      cache: PagedKVCache,
                      block_tables: torch.Tensor,  # [B, T] int32
                      lengths: torch.Tensor,  # [B] int32 tokens already written
                      attention_impl: Optional[str] = None,
                      ) -> torch.Tensor:
    """One ragged decode step: returns f32 logits [B, V]; the pool is
    written in place. Sequence ``b``'s token lands at position
    ``lengths[b]``; attention then covers positions ``0..lengths[b]``.
    Inactive batch slots ride along with an all-trash table and length 0:
    their writes hit only the trash page and their logits are garbage the
    scheduler discards."""
    impl = attention_impl if attention_impl is not None else config.attention
    positions = lengths.long()[:, None]  # [B, 1] ragged
    cos, sin = model.rotary()
    x = model.embed[token[:, None]]  # [B, 1, D]
    attn_lengths = lengths + 1
    for i, layer in enumerate(model.layers):
        q, k, v = llama._qkv(x, layer, config, cos, sin, positions)
        kp, vp = cache.k[i], cache.v[i]
        scatter_token(kp, vp, k, v, block_tables, lengths)
        attn = ragged_paged_attention(q, kp, vp, block_tables, attn_lengths,
                                      impl=impl)
        x = llama.project_out(x, attn, layer, config)
        x = x + llama._mlp(x, layer, config)
    return llama.unembed(x, model)[:, 0, :]
