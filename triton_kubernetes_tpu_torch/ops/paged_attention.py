"""Paged attention over a block-paged KV pool -- the port of
``triton_kubernetes_tpu/ops/paged_attention.py``.

The pool of one layer is ``[N, Hkv, bs, D]`` (head-major pages); a
sequence's block table maps its logical block ``j`` (tokens ``j*bs ..
(j+1)*bs - 1``) to a physical page. **Page 0 is the trash page**:
allocators never hand it out, unused table entries point at it, and
scatters of inactive batch slots land in it. Correctness never depends on
its contents.

This module holds

* the host-side helpers (:func:`blocks_for`, :func:`gather_pages`,
  :func:`table_slots`) and the page writes (:func:`scatter_token`,
  :func:`scatter_span`, :func:`scatter_chunk`). The writes update the pool
  **in place** (``index_put_``/``index_copy_``); the JAX package rebinds a
  donated pool instead;
* the two attention entry points, :func:`ragged_paged_attention` (one
  decode query per sequence) and :func:`paged_prefill_attention` (one
  prefill window). Each takes ``impl``: ``"cuda"`` launches the
  hand-written Hopper kernel (``csrc/paged_decode.cu``,
  ``csrc/paged_prefill.cu``), ``"dense"`` runs the plain PyTorch version
  beside it, and ``None`` picks ``"cuda"`` for CUDA tensors and
  ``"dense"`` for CPU tensors. A CUDA tensor never falls back to the plain
  version: if the kernel cannot build or launch, the call raises. Each
  entry point counts its kernel launches in its ``launches`` attribute.

The plain versions follow the kernels' steps: scores in f32 from the
input-dtype operands, times ``D ** -0.5``; an online softmax over one page
of keys at a time, in f32; ``p`` rounded to V's dtype before ``P @ V``;
``acc / l`` where ``l > 0``, else 0. Pages the kernels never visit (at or
past the sequence's length, or past the prefill window) contribute
nothing, so a length-0 decode slot returns 0 -- where the JAX dense
reference averages garbage instead, which its engine discards.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from .attention import NEG_INF

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


def gather_pages(pages: torch.Tensor,  # [N, Hkv, bs, D]
                 block_tables: torch.Tensor,  # [B, T] physical page ids
                 ) -> torch.Tensor:
    """K or V in logical token order: [B, T*bs, Hkv, D]. Entries past a
    sequence's written length gather garbage by design; callers mask by
    position."""
    _, hkv, bs, d = pages.shape
    b, t = block_tables.shape
    out = pages[block_tables.long()]  # [B, T, Hkv, bs, D]
    return out.permute(0, 1, 3, 2, 4).reshape(b, t * bs, hkv, d)


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
                  ) -> None:
    """Write one token's K/V per sequence into its page, in place.

    Inactive batch slots carry an all-trash table: their writes land in
    the trash page, colliding only with each other."""
    page, slot = table_slots(block_tables, positions, k_pages.shape[2])
    k_pages[page, :, slot] = k[:, 0].to(k_pages.dtype)
    v_pages[page, :, slot] = v[:, 0].to(v_pages.dtype)


def scatter_span(k_pages: torch.Tensor, v_pages: torch.Tensor,
                 k: torch.Tensor,  # [B, S, Hkv, D]
                 v: torch.Tensor,
                 block_tables: torch.Tensor,  # [B, T]
                 start: torch.Tensor,  # [B] slot of each sequence's token 0
                 ) -> None:
    """Write S consecutive tokens per sequence (token j at ``start + j``)
    as S :func:`scatter_token` calls in position order, in place."""
    for j in range(k.shape[1]):
        scatter_token(k_pages, v_pages, k[:, j:j + 1], v[:, j:j + 1],
                      block_tables, start + j)


def scatter_chunk(k_pages: torch.Tensor,  # [N, Hkv, bs, D], written in place
                  v_pages: torch.Tensor,
                  k: torch.Tensor,  # [1, C, Hkv, D] a page-aligned chunk
                  v: torch.Tensor,
                  window_table: torch.Tensor,  # [C // bs] physical pages
                  ) -> None:
    """Write one page-aligned chunk's K/V into its ``C // bs`` pages, in
    place. Chunk tokens past the real length (a right-padded final
    window) write pad garbage, masked out of every later attention."""
    _, hkv, bs, d = k_pages.shape
    w = window_table.shape[0]
    c = k.shape[1]
    if c != w * bs:
        raise ValueError(
            f"chunk of {c} tokens does not cover window_table's "
            f"{w} pages of {bs} slots")
    index = window_table.long()
    # [1, C, Hkv, D] -> [w, Hkv, bs, D]: tokens into pages, heads ahead of
    # slots (the head-major page plane).
    kw = k[0].reshape(w, bs, hkv, d).permute(0, 2, 1, 3)
    vw = v[0].reshape(w, bs, hkv, d).permute(0, 2, 1, 3)
    k_pages.index_copy_(0, index, kw.to(k_pages.dtype))
    v_pages.index_copy_(0, index, vw.to(v_pages.dtype))


def _paged_attention_plain(q: torch.Tensor,  # [B, Sq, Hq, D]
                           k: torch.Tensor,  # [B, T*bs, Hkv, D] gathered
                           v: torch.Tensor,
                           q_positions: torch.Tensor,  # [B, Sq]
                           kv_len: torch.Tensor,  # [B] keys the kernel walks
                           bs: int) -> torch.Tensor:
    """The kernels' arithmetic, vectorised over pages: the online softmax
    over pages of ``bs`` keys is written in closed form -- page ``t``'s
    ``p`` is taken against the running max ``m_t`` (and rounded to V's
    dtype there), then rescaled by ``exp(m_t - m_last)``, which is what
    the kernels' chain of ``corr`` factors multiplies it by."""
    b, sq, hq, d = q.shape
    _, tk, hkv, _ = k.shape
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    group, t = hq // hkv, tk // bs
    qg = q.reshape(b, sq, hkv, group, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    k_pos = torch.arange(tk, device=q.device)
    mask = k_pos[None, None, None, None, :] <= q_positions.long()[
        :, None, None, :, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    s = s.reshape(b, hkv, group, sq, t, bs)
    live = (torch.arange(t, device=q.device)[None, :] * bs
            < kv_len.long()[:, None])[:, None, None, None, :]  # [B,1,1,1,T]
    m_page = torch.where(live, s.amax(dim=-1),
                         torch.full((), NEG_INF, device=q.device))
    m_run = torch.cummax(m_page, dim=-1).values  # [B, Hkv, G, Sq, T]
    p = torch.exp(s - m_run[..., None])
    p = torch.where(live[..., None], p, torch.zeros((), device=q.device))
    w = torch.exp(m_run - m_run[..., -1:])
    l = (p.sum(dim=-1) * w).sum(dim=-1)  # [B, Hkv, G, Sq]
    p = p.to(v.dtype).float() * w[..., None]
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.reshape(b, hkv, group, sq, tk),
                       v.float())
    out = torch.where(l[..., None] > 0, acc / l[..., None],
                      torch.zeros((), device=q.device))
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def ragged_paged_attention(
    q: torch.Tensor,  # [B, 1, Hq, D] this step's query per sequence
    k_pages: torch.Tensor,  # [N, Hkv, bs, D] one layer's pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, T] int32
    lengths: torch.Tensor,  # [B] int32 tokens written, this one included
    impl: Optional[str] = None,
) -> torch.Tensor:
    """One decode step of attention for a ragged batch: [B, 1, Hq, D].

    Sequence ``b``'s query sits at position ``lengths[b] - 1`` and attends
    every written slot of its own pages (the current token's K/V must
    already be scattered in). A sequence of length 0 gets 0."""
    impl = resolve_paged_impl(impl, q.device)
    if impl == "dense":
        bs = k_pages.shape[2]
        k = gather_pages(k_pages, block_tables)
        v = gather_pages(v_pages, block_tables)
        return _paged_attention_plain(q, k, v, (lengths - 1)[:, None],
                                      lengths, bs)
    out = _kernels.paged_decode(q, k_pages, v_pages, block_tables, lengths)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def paged_prefill_attention(
    q: torch.Tensor,  # [1, C, Hq, D] one window's rotary-applied queries
    k_pages: torch.Tensor,  # [N, Hkv, bs, D] one layer's pool
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [T] int32 the sequence's full table
    offset: int,  # absolute position of q's row 0
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Chunked-prefill attention straight out of the paged pool:
    [1, C, Hq, D] for C queries at positions ``offset .. offset + C - 1``,
    attending causally to every written slot of the sequence's pages (this
    window's K/V included: :func:`scatter_chunk` runs first)."""
    impl = resolve_paged_impl(impl, q.device)
    if impl == "dense":
        c = q.shape[1]
        bs = k_pages.shape[2]
        kk = gather_pages(k_pages, block_table[None])
        vv = gather_pages(v_pages, block_table[None])
        positions = offset + torch.arange(c, device=q.device)[None]
        kv_len = torch.full((1,), offset + c, device=q.device)
        return _paged_attention_plain(q, kk, vv, positions, kv_len, bs)
    out = _kernels.paged_prefill(q, k_pages, v_pages, block_table, offset)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0


def reset_launch_counts() -> None:
    """Zero both kernel entry points' launch counters."""
    ragged_paged_attention.launches = 0
    paged_prefill_attention.launches = 0
