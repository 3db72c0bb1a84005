"""The span plain version of the paged decode and verify kernels.

The decode and verify kernels' tensor-core design (``csrc/paged_common.cuh``
``paged_span_body``) cuts the key axis into spans of
``_kernels.PAGED_SPAN_KEYS`` keys fixed by position, runs the reference's
per-page online softmax over each span from fresh state and merges the
spans in order. Its plain version (``ops.paged_attention``,
``_paged_attention_plain(..., span)``) restarts the running max at every
span, which is what keeps the card's check at one bf16 ulp. Here, on the
CPU, the same seeded numpy inputs go through the JAX package's dense
reference and its Pallas kernels in interpret mode, and through the span
plain version at lengths that cross one to three span edges:

* in f32 the span plain version computes the same softmax as the
  reference, so they differ only in f32 summation order: atol/rtol 1e-5,
  as in ``tests/test_torch_paged_attention.py``;
* on 8-bit (int8/fp8) pages with f32 queries the same 1e-5 holds: p stays
  f32 in both, the scales are applied at the same points;
* with bf16 queries over bf16 pages both round p to bf16, but against
  different running maxima (the span's, the sequence's), so they are held
  one output ulp apart plus 1e-2 absolute -- the bound the card holds the
  kernels to against the plain version;
* a verify row is the decode row at its length bit for bit, also where a
  row's stagger straddles a span edge.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.ops import paged_attention as jpa
from triton_kubernetes_tpu_torch.ops import _kernels
from triton_kubernetes_tpu_torch.ops import paged_attention as tpa

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-2)
SPAN = _kernels.PAGED_SPAN_KEYS
BS = 16
T = 52  # 832 keys a table: spans end at 256, 512, 768
HQ, HKV = 4, 2
# Lengths on both sides of the first three span edges.
LENGTHS = [1, 255, 256, 257, 511, 513, 769, 832]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(seed, lengths, d, s=1, poison=1e4):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    pages = 1 + b * T
    kp = rng.standard_normal((pages, HKV, BS, d)).astype(np.float32)
    vp = rng.standard_normal((pages, HKV, BS, d)).astype(np.float32)
    kp[tpa.TRASH_PAGE] = vp[tpa.TRASH_PAGE] = poison
    phys = rng.permutation(np.arange(1, pages))
    tables = np.full((b, T), tpa.TRASH_PAGE, np.int32)
    for i, n in enumerate(lengths):
        used = tpa.blocks_for(int(n) + s - 1, BS)
        tables[i, :used] = phys[i * T: i * T + used]
    q = rng.standard_normal((b, s, HQ, d)).astype(np.float32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def test_the_table_picks_the_span_for_both_kernels():
    """The span of a call comes from the table that picks the kernels'
    design, by (q dtype, page dtype, bs, D) alone."""
    for pages in (torch.bfloat16, torch.int8, torch.float8_e4m3fn):
        for bs, d in ((16, 128), (32, 64), (16, 64), (32, 128)):
            assert _kernels.paged_variant(torch.bfloat16, pages, bs,
                                          d) == "tensor_core"
            assert _kernels.paged_span(torch.bfloat16, pages, bs, d) == SPAN
    for dtype, pages, bs, d in ((torch.float32, torch.float32, 16, 128),
                                (torch.float32, torch.int8, 16, 128),
                                (torch.bfloat16, torch.bfloat16, 8, 128),
                                (torch.bfloat16, torch.bfloat16, 16, 96),
                                (torch.bfloat16, torch.bfloat16, 16, 16)):
        assert _kernels.paged_variant(dtype, pages, bs, d) == "cuda_core"
        assert _kernels.paged_span(dtype, pages, bs, d) is None
    assert SPAN % 64 == 0  # whole ring stages of the kernel
    assert f"-DTK8S_PAGED_SPAN={SPAN}" in _kernels.NVCC_FLAGS


@pytest.mark.parametrize("jax_impl", ["dense", "pallas-interpret"])
def test_span_decode_plain_matches_jax_f32(jax_impl):
    q, kp, vp, tables, lens = _case(30, LENGTHS, 16)
    got = tpa._decode_plain(_t(q), _t(kp), _t(vp), _t(tables), _t(lens),
                            None, None, SPAN)
    want = jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), impl=jax_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("jax_impl", ["dense", "pallas-interpret"])
def test_span_verify_plain_matches_jax_f32(jax_impl):
    """S = 4 rows a sequence, rows 254-257 and 510-513 straddling an
    edge."""
    lengths = [254, 255, 510, 766, 829]
    q, kp, vp, tables, lens = _case(31, lengths, 16, s=4)
    got = tpa._verify_plain(_t(q), _t(kp), _t(vp), _t(tables), _t(lens),
                            None, None, SPAN)
    want = jpa.ragged_verify_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), impl=jax_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _quantized(kp, vp, kind):
    from triton_kubernetes_tpu.ops import quantization as jq
    jdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[kind]
    tdt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[kind]
    out = []
    for pages in (kp, vp):
        qp, sc = jq.quantize_kv_pages(jnp.asarray(pages), jdt)
        tp = torch.from_numpy(np.asarray(qp).view(np.uint8).copy()).view(tdt)
        out.append((qp, sc, tp, _t(np.array(sc))))
    return out


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("jax_impl", ["dense", "pallas-interpret"])
def test_span_plain_on_8bit_pages_matches_jax(kind, jax_impl):
    """Decode and verify (S 3) on int8/fp8 pages, f32 queries: the span
    plain version keeps p in f32 and applies the K scale to the scores and
    the V scale to each page's P @ V, as the reference does."""
    q, kp, vp, tables, lens = _case(32, [255, 257, 511, 700], 16, s=3)
    (jk, jks, tk, tks), (jv, jvs, tv, tvs) = _quantized(kp, vp, kind)
    jt, jl = jnp.asarray(tables), jnp.asarray(lens)
    got = tpa._decode_plain(_t(q[:, :1]), tk, tv, _t(tables), _t(lens),
                            tks, tvs, SPAN)
    want = jpa.ragged_paged_attention(jnp.asarray(q[:, :1]), jk, jv, jt, jl,
                                      jks, jvs, impl=jax_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = tpa._verify_plain(_t(q), tk, tv, _t(tables), _t(lens), tks, tvs,
                            SPAN)
    want = jpa.ragged_verify_attention(jnp.asarray(q), jk, jv, jt, jl, jks,
                                       jvs, impl=jax_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("jax_impl", ["dense", "pallas-interpret"])
def test_bf16_entry_points_take_the_span_and_match_jax(jax_impl):
    """bf16 queries over bf16 pages at D 64, bs 16: the entry points' plain
    versions run the span design the table names (bit for bit the span
    plain version) and stay within one bf16 ulp of the JAX reference in
    bf16."""
    q, kp, vp, tables, lens = _case(33, LENGTHS, 64)
    qb, kb, vb = (_t(x).to(torch.bfloat16) for x in (q, kp, vp))
    got = tpa.ragged_paged_attention(qb, kb, vb, _t(tables), _t(lens))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tpa._decode_plain(qb, kb, vb, _t(tables),
                                              _t(lens), None, None, SPAN))
    want = jpa.ragged_paged_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables),
        jnp.asarray(lens), impl=jax_impl)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
def test_verify_plain_rows_are_decode_plain_rows_across_span_edges(kind):
    """Through the entry points (bf16 queries, D 64, bs 16: the span
    design), every verify row is ``torch.equal`` to decode at its length,
    rows straddling a span edge included."""
    lengths = [0, 253, 254, 255, 509, 510, 766, 829]
    q, kp, vp, tables, lens = _case(34, lengths, 64, s=4)
    qb = _t(q).to(torch.bfloat16)
    if kind is None:
        k, v = (_t(x).to(torch.bfloat16) for x in (kp, vp))
        ks = vs = None
    else:
        (_, _, k, ks), (_, _, v, vs) = _quantized(kp, vp, kind)
    assert _kernels.paged_span(qb.dtype, k.dtype, BS, 64) == SPAN
    got = tpa.ragged_verify_attention(qb, k, v, _t(tables), _t(lens), ks,
                                      vs)
    for j in range(4):
        row = tpa.ragged_paged_attention(qb[:, j:j + 1].contiguous(), k, v,
                                         _t(tables), _t(lens + j), ks, vs)
        assert torch.equal(got[:, j:j + 1], row), f"row {j}"
    assert not got[0, 0].float().any()  # length 0: no key at all


def test_one_span_over_the_whole_table_is_the_unsplit_walk():
    """A span as long as the table is the no-span plain version bit for
    bit, and the restart at the span edges does change p's rounding in
    bf16: the span is part of the arithmetic, not a no-op."""
    q, kp, vp, tables, lens = _case(35, LENGTHS, 64)
    qb, kb, vb = (_t(x).to(torch.bfloat16) for x in (q, kp, vp))
    whole = tpa._decode_plain(qb, kb, vb, _t(tables), _t(lens), None, None,
                              None)
    assert torch.equal(whole, tpa._decode_plain(
        qb, kb, vb, _t(tables), _t(lens), None, None, T * BS))
    spans = tpa._decode_plain(qb, kb, vb, _t(tables), _t(lens), None, None,
                              SPAN)
    assert not torch.equal(whole, spans)
    torch.testing.assert_close(spans.float(), whole.float(), **BF16_TOL)
