"""Paged-KV-cache prefill, decode, speculative verify and rewind for the
serving engine -- the port of ``triton_kubernetes_tpu/models/paged.py``.

:class:`PagedKVCache` is a static pool of fixed-size pages,
``[L, num_blocks, Hkv, block_size, Dh]`` (head-major); per-sequence block
tables live with the scheduler (``serve/``). Page 0 is the shared trash
page (``ops.paged_attention.TRASH_PAGE``). Quantized pools (``kv_dtype``
"int8" or "fp8") hold 8-bit pages plus f32 scales ``[L, num_blocks, Hkv]``
anchored on each page's slot 0 (``ops/quantization.py``): writes quantize,
and the attention kernels dequantize as they read.

**The pool is updated in place.** Every entry point here writes its K/V
(and scales) into the cache's tensors with ``index_copy_``/``index_put_``
and returns only the logits; the JAX package donates the pool to ``jit``
and rebinds the result instead. Layer ``l``'s pages are the contiguous
view ``cache.k[l]``, which is what the attention kernels are handed.

Per-token math is the block split of ``models/llama.py`` with explicit
positions, so masked slots (future tokens, pad garbage, trash pages)
contribute exactly zero. The prefill-window, decode and verify steps carry
the residual x and its norm h across each layer boundary, the add and the
norm one ``ops.norms.add_rms_norm_rows`` (one kernel launch on the card),
and take every weight product through the row-invariant
``ops.decode_gemm`` (a window's rows in row tiles of 64), so that a row's bits,
and a full page's bytes, do not depend on how many rows the step holds;
the one-shot :func:`paged_prefill` runs ``models/generate.prefill``, with
the plain norm and ``torch.einsum``. The attention implementation follows
``ops.paged_attention.resolve_paged_impl``: the hand-written kernels for
CUDA tensors, the plain versions for CPU tensors, or the plain versions
everywhere with ``attention_impl="dense"`` (or ``config.attention ==
"dense"``).

Speculative decoding (:func:`paged_verify_step`, :func:`paged_rewind`)
runs ``S = spec_k + 1`` tokens per sequence through the stack at once,
writing them token at a time as decode would, after copying the bytes of
every slot it will write (:class:`VerifyUndo`); the rewind restores the
slots of rejected tokens, so the pool holds what an engine that never
speculated would hold.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..constants import KV_DTYPES
from ..ops.norms import (
    add_rms_norm_quant_rows,
    add_rms_norm_rows,
    rms_norm_quant_rows,
    rms_norm_rows,
)
from ..ops.paged_attention import (
    TRASH_PAGE,
    byte_view,
    paged_prefill_attention,
    ragged_paged_attention,
    ragged_verify_attention,
    scatter_chunk,
    scatter_span,
    scatter_token,
    table_slots,
)
from ..ops.quantization import (
    KV_QUANT_DTYPES,
    QuantizedRows,
    kv_quant_error,
    quantize_kv_pages,
)
from . import llama
from .config import ModelConfig
from .generate import init_cache, prefill

# (k_err, v_err): mean relative dequantization error of what a quantized
# prefill wrote, over its real token slots (0-dim f32 tensors).
QuantError = Tuple[torch.Tensor, torch.Tensor]


@dataclass
class PagedKVCache:
    """The static page pool; block tables live with the scheduler.
    ``k_scale``/``v_scale`` exist exactly when the pool is quantized."""

    k: torch.Tensor  # [L, num_blocks, Hkv, block_size, Dh]
    v: torch.Tensor  # [L, num_blocks, Hkv, block_size, Dh]
    k_scale: Optional[torch.Tensor] = None  # [L, num_blocks, Hkv] f32
    v_scale: Optional[torch.Tensor] = None  # [L, num_blocks, Hkv] f32

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        """Whether pages hold 8-bit values with scales (keyed off the
        scales, not the page dtype, as the JAX package does)."""
        return self.k_scale is not None

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the K/V page arrays (scales excluded)."""
        return (self.k.numel() * self.k.element_size()
                + self.v.numel() * self.v.element_size())

    @property
    def scale_bytes(self) -> int:
        if self.k_scale is None:
            return 0
        return 4 * (self.k_scale.numel() + self.v_scale.numel())

    def layer(self, i: int):
        """Layer ``i``'s (k pages, v pages, k scales, v scales): views of
        the pool, the scales None when unquantized."""
        if self.k_scale is None:
            return self.k[i], self.v[i], None, None
        return self.k[i], self.v[i], self.k_scale[i], self.v_scale[i]


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
    dev = llama.resolve_device(device)
    shape = (config.num_layers, num_blocks, config.num_kv_heads,
             block_size, config.head_dim)
    if kv_dtype in KV_QUANT_DTYPES:
        sshape = shape[:3]
        dtype = KV_QUANT_DTYPES[kv_dtype]
        return PagedKVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=dev))
    dtype = torch.bfloat16 if kv_dtype == "bf16" else config.activation_dtype
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                        v=torch.zeros(shape, dtype=dtype, device=dev))


def _write_pages(pages: torch.Tensor, scale: Optional[torch.Tensor],
                 index: torch.Tensor, exact: torch.Tensor) -> None:
    """Write exact [n, Hkv, bs, Dh] pages into one layer's pool at
    ``index``, quantizing with anchored scales when ``scale`` is given."""
    if scale is None:
        pages.index_copy_(0, index, exact.to(pages.dtype))
        return
    q, s = quantize_kv_pages(exact, pages.dtype)
    byte_view(pages).index_copy_(0, index, byte_view(q))
    scale.index_copy_(0, index, s)


def _quant_errors(cache: PagedKVCache, index: torch.Tensor,
                  exact_k: torch.Tensor, exact_v: torch.Tensor,
                  length: int) -> QuantError:
    """kv_quant_error of the pages at ``index`` as the pool now holds them,
    every layer's at once, against the exact K and V ([L, n, Hkv, bs, Dh])
    over the first ``length`` token slots of those pages: a ratio of sums
    over all layers, as the JAX package computes it on its stacked layers.
    (Slots past ``length``, trash-page entries included, are masked out.)"""
    n, bs = index.shape[0], cache.block_size
    slot = torch.arange(n * bs, device=index.device).reshape(n, bs)
    mask = (slot < length)[None, :, None, :, None]
    return tuple(
        kv_quant_error(byte_view(pool)[:, index].view(pool.dtype),
                       scale[:, index][..., None, None], exact, mask)
        for pool, scale, exact in ((cache.k, cache.k_scale, exact_k),
                                   (cache.v, cache.v_scale, exact_v)))


# attend(layer index, q, k, v) -> attention output: writes the layer's
# K/V into the pool and attends over it.
AttendFn = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor],
                    torch.Tensor]


def _serve_layers(model: llama.Llama, x: torch.Tensor, config: ModelConfig,
                  positions: torch.Tensor, attend: AttendFn
                  ) -> Union[torch.Tensor, QuantizedRows]:
    """The decoder stack of the serving steps, from the embeddings x
    ([B, S, D]) to the final norm's output, which the head reads. A layer
    boundary's residual add and the norm after it are one
    ``add_rms_norm_rows`` (one kernel launch on the card): x and h = the
    norm of x are carried across it. Where the products that read h
    contract W8A8 (``llama.w8a8_dtype``), h crosses as the rows quantized
    by the same launch (``add_rms_norm_quant_rows``, and
    ``rms_norm_quant_rows`` for the first norm): ``QuantizedRows``. The
    weight products are row-invariant (``decode_gemm``, or W8A8's
    kernels), and so are the norms on CUDA tensors: a row's bits do not
    depend on how many rows the step holds. An MoE layer's MLP is
    ``ops.moe.moe_layer_rows`` (the router and each expert on
    ``decode_gemm``; its readers never contract W8A8, so h reaches it
    unquantized), row-invariant where routing is dropless."""
    cos, sin = model.rotary()
    eps = config.norm_eps
    layers = model.layers

    def boundary(x, delta, scale, readers):
        """x + delta (delta None: x) and its norm, quantized where its
        readers contract W8A8."""
        qdtype = llama.w8a8_dtype(readers, config, x)
        if delta is None:
            return x, (rms_norm_rows(x, scale, eps) if qdtype is None
                       else rms_norm_quant_rows(x, scale, eps, qdtype))
        if qdtype is None:
            return add_rms_norm_rows(x, delta, scale, eps)
        return add_rms_norm_quant_rows(x, delta, scale, eps, qdtype)

    def qkv(layer):
        return [layer.wq, layer.wk, layer.wv]

    x, h = boundary(x, None, layers[0].attn_norm, qkv(layers[0]))
    for i, layer in enumerate(layers):
        q, k, v = llama._qkv_normed(h, layer, config, cos, sin, positions,
                                    row_invariant=True)
        attn = attend(i, q, k, v)
        x, h = boundary(
            x, llama.out_projection(attn, layer, config, row_invariant=True),
            layer.mlp_norm, llama.mlp_readers(layer, config))
        after, readers = ((layers[i + 1].attn_norm, qkv(layers[i + 1]))
                          if i + 1 < len(layers)
                          else (model.final_norm, [model.lm_head]))
        x, h = boundary(
            x, llama._mlp_normed(h, layer, config, row_invariant=True)[0],
            after, readers)
    return h


def paged_prefill(model: llama.Llama,
                  tokens: torch.Tensor,  # [1, P] right-padded prompt
                  length: int,  # real prompt tokens (<= P)
                  config: ModelConfig,
                  cache: PagedKVCache,
                  block_table: torch.Tensor,  # [P // block_size]
                  with_quant_error: bool = False,
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, QuantError]]:
    """Run one right-padded prompt and land its K/V in pages (in place).
    Returns the f32 logits [V] at the last real token -- and, with
    ``with_quant_error`` on a quantized pool, the (k, v) dequantization
    errors over the prompt's real slots. Pad tokens sit at positions >=
    length, so causal masking keeps them out of every real position; their
    K/V land above ``length`` as garbage later masked. A quantized pool
    gets whole-page anchored quantization: the bytes token-at-a-time decode
    writes would give for the same token values."""
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
    if with_quant_error and not cache.quantized:
        raise ValueError("with_quant_error only applies to quantized pools")
    contiguous = init_cache(config, 1, p, device=tokens.device)
    last = torch.tensor([length - 1], device=tokens.device)
    logits, contiguous = prefill(model, tokens, config, contiguous,
                                 last_position=last)
    index = block_table.long()
    # [L, 1, P, Hkv, Dh] -> [L, T, Hkv, bs, Dh]: tokens into pages, heads
    # ahead of slots.
    ek, ev = (src[:, 0].reshape(src.shape[0], t, bs, *src.shape[3:])
              .permute(0, 1, 3, 2, 4) for src in (contiguous.k, contiguous.v))
    for i in range(config.num_layers):
        kp, vp, ks, vs = cache.layer(i)
        _write_pages(kp, ks, index, ek[i])
        _write_pages(vp, vs, index, ev[i])
    if not with_quant_error:
        return logits[0, 0]
    return logits[0, 0], _quant_errors(cache, index, ek, ev, length)


def paged_prefill_chunk(model: llama.Llama,
                        tokens: torch.Tensor,  # [1, C] one right-padded window
                        offset: int,  # tokens already in pages (C-aligned)
                        chunk_len: int,  # real tokens this window (1..C)
                        config: ModelConfig,
                        cache: PagedKVCache,
                        block_table: torch.Tensor,  # [T] the FULL table
                        with_quant_error: bool = False,
                        attention_impl: Optional[str] = None,
                        ) -> Union[torch.Tensor,
                                   Tuple[torch.Tensor, QuantError]]:
    """One window of an incremental prefill: run ``C`` prompt tokens at
    positions ``offset .. offset+C-1``, land their K/V in this window's
    pages (in place), and attend to everything written so far. Returns the
    f32 logits [V] at row ``chunk_len - 1`` (they matter on the final
    window) -- and, with ``with_quant_error`` on a quantized pool, the (k,
    v) dequantization errors over this window's real slots. Contract:
    ``C % block_size == 0``, ``offset`` a multiple of ``C`` and
    ``T * block_size`` a multiple of ``C``."""
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
    if with_quant_error and not cache.quantized:
        raise ValueError("with_quant_error only applies to quantized pools")
    impl = attention_impl if attention_impl is not None else config.attention
    # A window's pad rows past the model's last position (a chunk wider
    # than max_seq_len, whose table is padded to whole windows) rotate at
    # the last one: the reference's gather clamps such indices, and those
    # rows are masked out of every real one.
    positions = (offset + torch.arange(c, device=tokens.device)[None]
                 ).clamp_(max=config.max_seq_len - 1)
    w = c // bs
    window = block_table[offset // bs: offset // bs + w]
    exact = ([], [])

    def attend(i, q, k, v):
        kp, vp, ks, vs = cache.layer(i)
        scatter_chunk(kp, vp, k, v, window, ks, vs)
        if with_quant_error:
            exact[0].append(k)
            exact[1].append(v)
        return paged_prefill_attention(q, kp, vp, block_table, offset, ks,
                                       vs, impl=impl)

    # The window's weight products are row-invariant too (decode_gemm on
    # the card): a cuBLAS product picks its kernel by the row count, so a
    # page written by a 128-token window would differ from the same page
    # written by a 256-token one (fault F2).
    h = _serve_layers(model, model.embed[tokens], config, positions, attend)
    # The head reads only the last real row (quantized rows are quantized
    # each by itself: the slice is bitwise the row's own).
    last = (h.positions(chunk_len - 1, chunk_len)
            if isinstance(h, QuantizedRows)
            else h[:, chunk_len - 1: chunk_len])
    logits = llama.unembed_normed(last, model, config=config)[0, 0]
    if not with_quant_error:
        return logits
    # [L, 1, C, Hkv, Dh] -> [L, w, Hkv, bs, Dh], the window's pages.
    ek, ev = (torch.stack(ex)[:, 0].reshape(len(ex), w, bs, *ex[0].shape[2:])
              .permute(0, 1, 3, 2, 4) for ex in exact)
    return logits, _quant_errors(cache, window.long(), ek, ev, chunk_len)


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
    attn_lengths = lengths + 1

    def attend(i, q, k, v):
        kp, vp, ks, vs = cache.layer(i)
        scatter_token(kp, vp, k, v, block_tables, lengths, ks, vs)
        return ragged_paged_attention(q, kp, vp, block_tables, attn_lengths,
                                      ks, vs, impl=impl)

    h = _serve_layers(model, model.embed[token[:, None]], config, positions,
                      attend)  # [B, 1, D]
    return llama.unembed_normed(h, model, row_invariant=True,
                                config=config)[:, 0, :]


class VerifyUndo(NamedTuple):
    """Pre-write bytes of every pool slot a verify step writes -- what
    :func:`paged_rewind` puts back for rejected draft positions.
    ``k_scale``/``v_scale`` are the touched pages' pre-verify scales (an
    anchored scale moves only when a slot-0 write lands)."""

    k: torch.Tensor  # [L, B, S, Hkv, Dh] page dtype
    v: torch.Tensor  # [L, B, S, Hkv, Dh]
    k_scale: Optional[torch.Tensor] = None  # [L, B, S, Hkv] f32
    v_scale: Optional[torch.Tensor] = None  # [L, B, S, Hkv] f32


def _verify_slots(block_tables: torch.Tensor, lengths: torch.Tensor,
                  s: int, block_size: int,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page [B, S], slot [B, S]) that verify input ``j`` lands in:
    position ``lengths[b] + j`` through the same ``table_slots`` mapping
    every write uses, so the undo capture and the rewind target exactly
    the slots ``scatter_span`` writes."""
    pos = lengths.long()[:, None] + torch.arange(
        s, device=lengths.device)[None, :]
    return table_slots(block_tables, pos, block_size)


def paged_verify_step(model: llama.Llama,
                      tokens: torch.Tensor,  # [B, S] last sampled + drafts
                      config: ModelConfig,
                      cache: PagedKVCache,
                      block_tables: torch.Tensor,  # [B, T] int32
                      lengths: torch.Tensor,  # [B] int32 tokens already written
                      attention_impl: Optional[str] = None,
                      ) -> Tuple[torch.Tensor, VerifyUndo]:
    """One speculative verify step: ``S = spec_k + 1`` tokens per sequence
    through the stack in one widened pass. Returns (f32 logits [B, S, V],
    :class:`VerifyUndo`); the pool is written in place.

    Input ``j`` of sequence ``b`` is written at position ``lengths[b] + j``
    (input 0 is the latest sampled token, the rest are drafts) and its
    logits row is the next-token distribution given the inputs before it.
    Row for row this is :func:`paged_decode_step`'s math, bit for bit --
    the same token-at-a-time writes (``scatter_span``), per-row attention
    (``ragged_verify_attention``), and norms and weight products whose rows
    do not depend on the row count (``rms_norm_rows``,
    ``add_rms_norm_rows``, and ``decode_gemm``) --
    with the weight pass paid once for S positions.

    The undo is one gather of every layer's touched slots, taken before
    any layer writes: the pool is written in place, so it must be a copy.
    """
    impl = attention_impl if attention_impl is not None else config.attention
    s = tokens.shape[1]
    positions = lengths.long()[:, None] + torch.arange(
        s, device=tokens.device)[None, :]  # [B, S]
    page, slot = _verify_slots(block_tables, lengths, s, cache.block_size)
    # Advanced indices separated by a slice put their dims in front:
    # [B, S, L, Hkv, Dh] -> layer-major.
    undo = VerifyUndo(
        k=byte_view(cache.k)[:, page, :, slot].permute(2, 0, 1, 3, 4)
        .view(cache.k.dtype),
        v=byte_view(cache.v)[:, page, :, slot].permute(2, 0, 1, 3, 4)
        .view(cache.v.dtype),
        k_scale=cache.k_scale[:, page] if cache.quantized else None,
        v_scale=cache.v_scale[:, page] if cache.quantized else None)
    attn_lengths = lengths + 1

    def attend(i, q, k, v):
        kp, vp, ks, vs = cache.layer(i)
        scatter_span(kp, vp, k, v, block_tables, lengths, ks, vs)
        return ragged_verify_attention(q, kp, vp, block_tables, attn_lengths,
                                       ks, vs, impl=impl)

    h = _serve_layers(model, model.embed[tokens], config, positions,
                      attend)  # [B, S, D]
    return llama.unembed_normed(h, model, row_invariant=True,
                                config=config), undo


def paged_rewind(cache: PagedKVCache,
                 undo: VerifyUndo,
                 block_tables: torch.Tensor,  # [B, T] int32
                 lengths: torch.Tensor,  # [B] int32, the verify's operand
                 keep: torch.Tensor,  # [B] verify inputs to keep
                 ) -> None:
    """Roll rejected speculative writes back, in place: restore the
    pre-verify bytes of every slot whose input index ``j >= keep[b]``,
    pages and (quantized pools) scales alike.

    Kept slots must not be touched, so their lanes of the restoring
    scatter are steered to the trash page, as the JAX package does (no
    host sync, fixed shapes). Rewound slots only live in pages the sequence
    owns alone: generated tokens never land in prefix-cache pages. A page's
    scale is restored only where the rejected slot is the page's slot 0,
    the one write that moves an anchored scale."""
    s = undo.k.shape[2]
    page, slot = _verify_slots(block_tables, lengths, s, cache.block_size)
    rej = (torch.arange(s, device=keep.device)[None, :]
           >= keep.long()[:, None])  # [B, S]
    trash = torch.full_like(page, TRASH_PAGE)
    page_w = torch.where(rej, page, trash)
    for pool, saved in ((cache.k, undo.k), (cache.v, undo.v)):
        byte_view(pool)[:, page_w, :, slot] = byte_view(saved).permute(
            1, 2, 0, 3, 4)
    if not cache.quantized:
        return
    spage = torch.where(rej & (slot == 0), page, trash)
    cache.k_scale[:, spage] = undo.k_scale
    cache.v_scale[:, spage] = undo.v_scale
