"""Paged attention over a block-paged KV pool -- the port of
``triton_kubernetes_tpu/ops/paged_attention.py``.

The pool of one layer is ``[N, Hkv, bs, D]`` (head-major pages); a
sequence's block table maps its logical block ``j`` (tokens ``j*bs ..
(j+1)*bs - 1``) to a physical page. **Page 0 is the trash page**:
allocators never hand it out, unused table entries point at it, and
scatters of inactive batch slots land in it. Correctness never depends on
its contents.

Quantized pools hold int8 or float8_e4m3fn pages plus one f32 scale per
(page, KV head), ``[N, Hkv]`` per layer. Scales are anchored on a page's
slot-0 token (``ops/quantization.py``): a write into slot 0 sets the
page's scale, other slots quantize against the stored one.

This module holds

* the host-side helpers (:func:`blocks_for`, :func:`gather_pages`,
  :func:`table_slots`) and the page writes (:func:`scatter_token`,
  :func:`scatter_span`, :func:`scatter_chunk`). The writes update the pool
  and its scales **in place** (``index_put_``/``index_copy_``); the JAX
  package rebinds a donated pool instead;
* the three attention entry points, :func:`ragged_paged_attention` (one
  decode query per sequence), :func:`ragged_verify_attention` (``S``
  staggered queries per sequence, the speculative verify step) and
  :func:`paged_prefill_attention` (one prefill window). Each takes the
  layer's scales when the pool is quantized, and ``impl``: ``"cuda"``
  launches the hand-written Hopper kernel (``csrc/paged_decode.cu``,
  ``csrc/paged_verify.cu``, ``csrc/paged_prefill.cu``), ``"dense"`` runs
  the plain PyTorch version beside it, and ``None`` picks ``"cuda"`` for
  CUDA tensors and ``"dense"`` for CPU tensors. A CUDA tensor never falls
  back to the plain version: if the kernel cannot build or launch, the
  call raises. Each entry point counts its kernel launches in its
  ``launches`` attribute.

The plain versions follow the kernels' steps: scores in f32 from the
input-dtype operands (8-bit K converted exactly), times ``D ** -0.5``,
then times the page's K scale when quantized; an online softmax over one
page of keys at a time, in f32, whose running max restarts at every span
of ``_kernels.PAGED_SPAN_KEYS`` keys where the decode, verify and prefill
kernels run their tensor-core design (``_kernels.paged_span``); ``p`` rounded to
V's dtype before ``P @ V`` on unquantized pools, kept in f32 on quantized
ones, where each page's ``P @ V`` is multiplied by its V scale; ``acc /
l`` where ``l > 0``, else 0. Pages the kernels never visit (at or past
the sequence's length, or past the prefill window) contribute nothing,
so a length-0 decode slot returns 0 -- where the JAX dense reference
averages garbage instead, which its engine discards.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from .attention import NEG_INF
from .quantization import (
    FP8_DTYPE,
    quantize_kv_pages,
    quantize_with_scale,
    token_kv_scale,
)

# Physical page every allocator must reserve: the scatter/gather sink for
# padded block-table entries and inactive batch slots.
TRASH_PAGE = 0

PAGED_IMPLS = ("dense", "cuda")


def blocks_for(length: int, block_size: int) -> int:
    """Pages needed to hold ``length`` tokens (host-side helper)."""
    if length <= 0:
        return 0
    return -(-length // block_size)


def resolve_paged_impl(mode: Optional[str], device: torch.device) -> str:
    """``ModelConfig.attention`` (or an explicit impl) -> "dense"/"cuda".

    "dense" forces the plain version; "cuda" forces the kernel and needs a
    CUDA device; None and the config modes "auto"/"flash"/"flash-interpret"
    pick the kernel on a CUDA device and the plain version on the CPU.
    """
    if mode == "dense":
        return "dense"
    if mode == "cuda":
        if device.type != "cuda":
            raise ValueError(
                f"impl='cuda' launches a CUDA kernel; tensors are on {device}")
        return "cuda"
    if mode in (None, "auto", "flash", "flash-interpret"):
        return "cuda" if device.type == "cuda" else "dense"
    raise ValueError(f"impl must be one of {PAGED_IMPLS} or None, got {mode!r}")


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as its bytes (other dtypes as they are): PyTorch's
    index_copy_ and equality have no float8 version, and a byte copy is
    the same write."""
    return t.view(torch.uint8) if t.dtype == FP8_DTYPE else t


def _check_scales(k_scale, v_scale) -> None:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")


def gather_pages(pages: torch.Tensor,  # [N, Hkv, bs, D]
                 block_tables: torch.Tensor,  # [B, T] physical page ids
                 scale: Optional[torch.Tensor] = None,  # [N, Hkv] f32
                 dtype: Optional[torch.dtype] = None,
                 ) -> torch.Tensor:
    """K or V in logical token order: [B, T*bs, Hkv, D]. Entries past a
    sequence's written length gather garbage by design; callers mask by
    position. A quantized pool passes its ``scale`` and is dequantized
    after the gather (``q * scale`` in f32, then cast to ``dtype``, f32 by
    default)."""
    _, hkv, bs, d = pages.shape
    b, t = block_tables.shape
    index = block_tables.long()
    # fp8 pages move as bytes (see byte_view) and are viewed back at the end.
    out = byte_view(pages)[index]  # [B, T, Hkv, bs, D]
    if scale is not None:
        out = (out.view(pages.dtype).float() * scale[index][..., None, None]
               ).to(dtype or torch.float32)
    out = out.permute(0, 1, 3, 2, 4).reshape(b, t * bs, hkv, d)
    return out if scale is not None else out.view(pages.dtype)


def table_slots(block_tables: torch.Tensor,  # [B, T]
                positions: torch.Tensor,  # [B] or [B, S]
                block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(physical page, slot) of per-sequence token positions. Positions
    past the table's coverage resolve to the trash page (an index clamp
    would land them in the table's last real page)."""
    b, t = block_tables.shape
    positions = positions.long()
    blk = torch.div(positions, block_size, rounding_mode="floor")
    rows = torch.arange(b, device=positions.device).reshape(
        (b,) + (1,) * (positions.dim() - 1))
    page = block_tables.long()[rows, blk.clamp(max=t - 1)]
    page = torch.where(blk < t, page, torch.full_like(page, TRASH_PAGE))
    return page, positions % block_size


def scatter_token(k_pages: torch.Tensor,  # [N, Hkv, bs, D], written in place
                  v_pages: torch.Tensor,
                  k: torch.Tensor,  # [B, 1, Hkv, D]
                  v: torch.Tensor,
                  block_tables: torch.Tensor,  # [B, T]
                  positions: torch.Tensor,  # [B] slot each token lands in
                  k_scale: Optional[torch.Tensor] = None,  # [N, Hkv] f32
                  v_scale: Optional[torch.Tensor] = None,
                  ) -> None:
    """Write one token's K/V per sequence into its page, in place.

    Quantized pools follow the anchored-scale rule: a token landing in a
    page's slot 0 sets the page's scale from its own amplitude; any other
    slot quantizes against the stored scale. Inactive batch slots carry an
    all-trash table: their writes land in the trash page, colliding only
    with each other."""
    _check_scales(k_scale, v_scale)
    page, slot = table_slots(block_tables, positions, k_pages.shape[2])
    if k_scale is None:
        k_pages[page, :, slot] = k[:, 0].to(k_pages.dtype)
        v_pages[page, :, slot] = v[:, 0].to(v_pages.dtype)
        return
    first = (slot == 0)[:, None]  # [B, 1]: this token anchors its page
    for pages, scale, x in ((k_pages, k_scale, k), (v_pages, v_scale, v)):
        new = torch.where(first, token_kv_scale(x[:, 0], pages.dtype),
                          scale[page])
        byte_view(pages)[page, :, slot] = byte_view(
            quantize_with_scale(x[:, 0], new[:, :, None], pages.dtype))
        scale[page] = new


def scatter_span(k_pages: torch.Tensor, v_pages: torch.Tensor,
                 k: torch.Tensor,  # [B, S, Hkv, D]
                 v: torch.Tensor,
                 block_tables: torch.Tensor,  # [B, T]
                 start: torch.Tensor,  # [B] slot of each sequence's token 0
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 ) -> None:
    """Write S consecutive tokens per sequence (token j at ``start + j``)
    as S :func:`scatter_token` calls in position order, in place: the
    writes plain decode makes, so anchored scales come out as decode's."""
    for j in range(k.shape[1]):
        scatter_token(k_pages, v_pages, k[:, j:j + 1], v[:, j:j + 1],
                      block_tables, start + j, k_scale, v_scale)


def scatter_chunk(k_pages: torch.Tensor,  # [N, Hkv, bs, D], written in place
                  v_pages: torch.Tensor,
                  k: torch.Tensor,  # [1, C, Hkv, D] a page-aligned chunk
                  v: torch.Tensor,
                  window_table: torch.Tensor,  # [C // bs] physical pages
                  k_scale: Optional[torch.Tensor] = None,  # [N, Hkv] f32
                  v_scale: Optional[torch.Tensor] = None,
                  ) -> None:
    """Write one page-aligned chunk's K/V into its ``C // bs`` pages, in
    place; a quantized pool re-anchors every written page's scale on its
    slot 0 (:func:`~.quantization.quantize_kv_pages`). Chunk tokens past
    the real length (a right-padded final window) write pad garbage,
    masked out of every later attention."""
    _check_scales(k_scale, v_scale)
    _, hkv, bs, d = k_pages.shape
    w = window_table.shape[0]
    c = k.shape[1]
    if c != w * bs:
        raise ValueError(
            f"chunk of {c} tokens does not cover window_table's "
            f"{w} pages of {bs} slots")
    index = window_table.long()
    for pages, scale, x in ((k_pages, k_scale, k), (v_pages, v_scale, v)):
        # [1, C, Hkv, D] -> [w, Hkv, bs, D]: tokens into pages, heads
        # ahead of slots (the head-major page plane).
        xw = x[0].reshape(w, bs, hkv, d).permute(0, 2, 1, 3)
        if scale is None:
            pages.index_copy_(0, index, xw.to(pages.dtype))
            continue
        qx, sx = quantize_kv_pages(xw, pages.dtype)
        byte_view(pages).index_copy_(0, index, byte_view(qx))
        scale.index_copy_(0, index, sx)


def _gather_for_plain(k_pages, v_pages, block_tables, k_scale, v_scale):
    """The plain versions' operands: K/V pages in token order, as stored,
    and (quantized pools) the scales of their pages, [B, T, Hkv]."""
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    if k_scale is None:
        return k, v, None, None
    index = block_tables.long()
    return k, v, k_scale[index], v_scale[index]


def _paged_attention_plain(q: torch.Tensor,  # [B, Sq, Hq, D]
                           k: torch.Tensor,  # [B, T*bs, Hkv, D] gathered
                           v: torch.Tensor,
                           q_positions: torch.Tensor,  # [B, Sq]
                           kv_len: torch.Tensor,  # [B] keys the kernel walks
                           bs: int,
                           k_scale: Optional[torch.Tensor] = None,  # [B,T,Hkv]
                           v_scale: Optional[torch.Tensor] = None,
                           span: Optional[int] = None,
                           ) -> torch.Tensor:
    """The kernels' arithmetic, vectorised over pages: the online softmax
    over pages of ``bs`` keys is written in closed form -- page ``t``'s
    ``p`` is taken against the running max ``m_t`` (and, unquantized,
    rounded to V's dtype there), then rescaled by ``exp(m_t - M)``, ``M``
    the max over every page, which is what the kernels' chain of ``corr``
    factors (and the merge of spans) multiplies it by. With ``span`` keys
    (a multiple of ``bs``) the running max restarts at each span's first
    page, as each span of the tensor-core kernels starts from fresh state;
    None is one span. Quantized pools pass their pages' scales: K's
    multiplies each page's scores after ``D ** -0.5``, V's each page's
    ``P @ V``."""
    b, sq, hq, d = q.shape
    _, tk, hkv, _ = k.shape
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    group, t = hq // hkv, tk // bs
    quantized = k_scale is not None
    qg = q.reshape(b, sq, hkv, group, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    s = s.reshape(b, hkv, group, sq, t, bs)
    if quantized:
        s = s * k_scale.permute(0, 2, 1)[:, :, None, None, :, None]
    k_pos = torch.arange(tk, device=q.device).reshape(t, bs)
    mask = k_pos <= q_positions.long()[:, None, None, :, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    live = (torch.arange(t, device=q.device)[None, :] * bs
            < kv_len.long()[:, None])[:, None, None, None, :]  # [B,1,1,1,T]
    m_page = torch.where(live, s.amax(dim=-1),
                         torch.full((), NEG_INF, device=q.device))
    # Running max within each span: pages of a span side by side, the last
    # span padded with dead pages.
    pps = max(1, t if span is None else span // bs)
    n_span = -(-t // pps)
    m_run = torch.nn.functional.pad(m_page, (0, n_span * pps - t),
                                    value=NEG_INF)
    m_run = torch.cummax(m_run.unflatten(-1, (n_span, pps)), dim=-1).values
    m_run = m_run.flatten(-2)[..., :t]  # [B, Hkv, G, Sq, T]
    p = torch.exp(s - m_run[..., None])
    p = torch.where(live[..., None], p, torch.zeros((), device=q.device))
    w = torch.exp(m_run - m_page.amax(dim=-1, keepdim=True))
    l = (p.sum(dim=-1) * w).sum(dim=-1)  # [B, Hkv, G, Sq]
    if quantized:
        w = w * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    else:
        p = p.to(v.dtype).float()
    p = p * w[..., None]
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.reshape(b, hkv, group, sq, tk),
                       v.float())
    out = torch.where(l[..., None] > 0, acc / l[..., None],
                      torch.zeros((), device=q.device))
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def _decode_plain(q, k_pages, v_pages, block_tables, lengths, k_scale,
                  v_scale, span: Optional[int]) -> torch.Tensor:
    k, v, ks, vs = _gather_for_plain(k_pages, v_pages, block_tables,
                                     k_scale, v_scale)
    return _paged_attention_plain(q, k, v, (lengths - 1)[:, None], lengths,
                                  k_pages.shape[2], ks, vs, span)


def _verify_plain(q, k_pages, v_pages, block_tables, lengths, k_scale,
                  v_scale, span: Optional[int]) -> torch.Tensor:
    """The S rows as staggered batch rows of the decode plain version."""
    b, s, hq, d = q.shape
    lens = (lengths[:, None] + torch.arange(
        s, dtype=lengths.dtype, device=lengths.device)[None]).reshape(-1)
    out = _decode_plain(q.reshape(b * s, 1, hq, d), k_pages, v_pages,
                        block_tables.repeat_interleave(s, dim=0), lens,
                        k_scale, v_scale, span)
    return out.reshape(b, s, hq, d)



def ragged_paged_attention(
    q: torch.Tensor,  # [B, 1, Hq, D] this step's query per sequence
    k_pages: torch.Tensor,  # [N, Hkv, bs, D] one layer's pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, T] int32
    lengths: torch.Tensor,  # [B] int32 tokens written, this one included
    k_scale: Optional[torch.Tensor] = None,  # [N, Hkv] f32 (quantized)
    v_scale: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """One decode step of attention for a ragged batch: [B, 1, Hq, D].

    Sequence ``b``'s query sits at position ``lengths[b] - 1`` and attends
    every written slot of its own pages (the current token's K/V must
    already be scattered in). A sequence of length 0 gets 0."""
    _check_scales(k_scale, v_scale)
    impl = resolve_paged_impl(impl, q.device)
    if impl == "dense":
        return _decode_plain(q, k_pages, v_pages, block_tables, lengths,
                             k_scale, v_scale,
                             _kernels.paged_span(q.dtype, k_pages.dtype,
                                                 *k_pages.shape[2:]))
    out = _kernels.paged_decode(q, k_pages, v_pages, block_tables, lengths,
                                k_scale, v_scale)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def ragged_verify_attention(
    q: torch.Tensor,  # [B, S, Hq, D] S consecutive queries per sequence
    k_pages: torch.Tensor,  # [N, Hkv, bs, D] one layer's pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, T] int32
    lengths: torch.Tensor,  # [B] int32 tokens written, row 0's included
    k_scale: Optional[torch.Tensor] = None,  # [N, Hkv] f32 (quantized)
    v_scale: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """One speculative verify step of attention: [B, S, Hq, D].

    Row ``j`` of sequence ``b`` sits at position ``lengths[b] - 1 + j`` and
    attends every written slot up to its own (the draft tokens of rows
    ``< j`` included, :func:`scatter_span` runs first): exactly what
    :func:`ragged_paged_attention` at length ``lengths[b] + j`` computes,
    and the kernel gives that row bit for bit while reading each page once
    for all S rows. The plain version flattens the S rows into staggered
    batch rows of the decode plain version, as the JAX dense reference
    does."""
    _check_scales(k_scale, v_scale)
    impl = resolve_paged_impl(impl, q.device)
    if impl == "dense":
        return _verify_plain(q, k_pages, v_pages, block_tables, lengths,
                             k_scale, v_scale,
                             _kernels.paged_span(q.dtype, k_pages.dtype,
                                                 *k_pages.shape[2:]))
    out = _kernels.paged_verify(q, k_pages, v_pages, block_tables, lengths,
                                k_scale, v_scale)
    ragged_verify_attention.launches += 1
    return out


ragged_verify_attention.launches = 0


def paged_prefill_attention(
    q: torch.Tensor,  # [1, C, Hq, D] one window's rotary-applied queries
    k_pages: torch.Tensor,  # [N, Hkv, bs, D] one layer's pool
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [T] int32 the sequence's full table
    offset: int,  # absolute position of q's row 0
    k_scale: Optional[torch.Tensor] = None,  # [N, Hkv] f32 (quantized)
    v_scale: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Chunked-prefill attention straight out of the paged pool:
    [1, C, Hq, D] for C queries at positions ``offset .. offset + C - 1``,
    attending causally to every written slot of the sequence's pages (this
    window's K/V included: :func:`scatter_chunk` runs first)."""
    _check_scales(k_scale, v_scale)
    impl = resolve_paged_impl(impl, q.device)
    if impl == "dense":
        c = q.shape[1]
        kk, vv, ks, vs = _gather_for_plain(k_pages, v_pages, block_table[None],
                                           k_scale, v_scale)
        positions = offset + torch.arange(c, device=q.device)[None]
        kv_len = torch.full((1,), offset + c, device=q.device)
        return _paged_attention_plain(q, kk, vv, positions, kv_len,
                                      k_pages.shape[2], ks, vs,
                                      _kernels.paged_span(
                                          q.dtype, k_pages.dtype,
                                          *k_pages.shape[2:]))
    out = _kernels.paged_prefill(q, k_pages, v_pages, block_table, offset,
                                 k_scale, v_scale)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0


def reset_launch_counts() -> None:
    """Zero the three kernel entry points' launch counters."""
    ragged_paged_attention.launches = 0
    ragged_verify_attention.launches = 0
    paged_prefill_attention.launches = 0
