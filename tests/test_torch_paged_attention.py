"""Port parity for ``triton_kubernetes_tpu_torch.ops.paged_attention``.

The page helpers are data movement, so they must match the JAX package
**exactly**. The two attention entry points run their plain PyTorch
versions here (CPU tensors) and are held against the JAX dense reference
and the JAX Pallas kernels in interpret mode, in f32, at atol/rtol 1e-5:
the plain versions compute the same softmax as the dense reference, one
page at a time, so they differ only in f32 summation order. The CUDA
kernels themselves run only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``); here the kernel build must fail with a
clear error naming ``nvcc``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.ops import paged_attention as jpa
from triton_kubernetes_tpu_torch.ops import _kernels
from triton_kubernetes_tpu_torch.ops import paged_attention as tpa

TOL = dict(rtol=1e-5, atol=1e-5)


def _pool(rng, num_pages, hkv, bs, d, poison=1e4):
    """A pool of random pages with a poisoned trash page."""
    pages = rng.standard_normal((num_pages, hkv, bs, d)).astype(np.float32)
    pages[tpa.TRASH_PAGE] = poison
    return pages


def _tables(rng, lengths, t, bs, num_pages):
    """Distinct, permuted physical pages per sequence; unused entries
    point at the trash page."""
    phys = rng.permutation(np.arange(1, num_pages))[:len(lengths) * t]
    tables = np.full((len(lengths), t), tpa.TRASH_PAGE, np.int32)
    for i, n in enumerate(lengths):
        used = tpa.blocks_for(int(n), bs)
        tables[i, :used] = phys[i * t: i * t + used]
    return tables


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ page helpers
def test_blocks_for_matches_jax():
    for n in range(0, 20):
        assert tpa.blocks_for(n, 4) == jpa.blocks_for(n, 4)


def test_gather_pages_exact():
    rng = np.random.default_rng(0)
    pages = _pool(rng, 12, 2, 4, 8)
    tables = _tables(rng, [7, 12, 1], 3, 4, 12)
    got = tpa.gather_pages(_t(pages), _t(tables))
    want = jpa.gather_pages(jnp.asarray(pages), jnp.asarray(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_table_slots_exact_incl_past_coverage():
    """Positions past the table's coverage resolve to the trash page."""
    rng = np.random.default_rng(1)
    tables = _tables(rng, [8, 5], 2, 4, 16)
    for positions in (np.array([3, 4], np.int32),
                      np.array([7, 9], np.int32),  # 9 is past 2 pages of 4
                      np.array([[0, 5, 8], [2, 7, 100]], np.int32)):
        gp, gs = tpa.table_slots(_t(tables), _t(positions), 4)
        wp, ws = jpa.table_slots(jnp.asarray(tables),
                                 jnp.asarray(positions), 4)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    gp, _ = tpa.table_slots(_t(tables), _t(np.array([8, 100], np.int32)), 4)
    assert gp.tolist() == [tpa.TRASH_PAGE, tpa.TRASH_PAGE]


def test_scatter_token_exact_incl_inactive_slots():
    """Active rows write their slot; inactive rows (all-trash table) land
    in the trash page only. The trash page's final bytes depend on which
    colliding write wins, so it is left out of the comparison."""
    rng = np.random.default_rng(2)
    kp = _pool(rng, 10, 2, 4, 8)
    vp = _pool(rng, 10, 2, 4, 8)
    tables = _tables(rng, [6, 3, 0, 0], 2, 4, 10)
    positions = np.array([6, 3, 0, 5], np.int32)
    k = rng.standard_normal((4, 1, 2, 8)).astype(np.float32)
    v = rng.standard_normal((4, 1, 2, 8)).astype(np.float32)
    tk, tv = _t(kp.copy()), _t(vp.copy())
    tpa.scatter_token(tk, tv, _t(k), _t(v), _t(tables), _t(positions))
    wk, wv = jpa.scatter_token(jnp.asarray(kp), jnp.asarray(vp),
                               jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(tables), jnp.asarray(positions))
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(wk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(wv)[1:])
    # Only the two active rows' pages changed outside the trash page.
    changed = np.nonzero((tk.numpy() != kp).any(axis=(1, 2, 3)))[0]
    assert set(changed.tolist()) - {tpa.TRASH_PAGE} == {
        int(tables[0, 1]), int(tables[1, 0])}


def test_scatter_span_exact():
    rng = np.random.default_rng(3)
    kp = _pool(rng, 10, 2, 4, 8)
    vp = _pool(rng, 10, 2, 4, 8)
    tables = _tables(rng, [9, 5], 3, 4, 10)
    start = np.array([5, 2], np.int32)
    k = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    tk, tv = _t(kp.copy()), _t(vp.copy())
    tpa.scatter_span(tk, tv, _t(k), _t(v), _t(tables), _t(start))
    wk, wv = jpa.scatter_span(jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(tables), jnp.asarray(start))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


def test_scatter_chunk_exact():
    rng = np.random.default_rng(4)
    kp = _pool(rng, 10, 2, 4, 8)
    vp = _pool(rng, 10, 2, 4, 8)
    window = np.array([7, 2], np.int32)
    k = rng.standard_normal((1, 8, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 8, 2, 8)).astype(np.float32)
    tk, tv = _t(kp.copy()), _t(vp.copy())
    tpa.scatter_chunk(tk, tv, _t(k), _t(v), _t(window))
    wk, wv = jpa.scatter_chunk(jnp.asarray(kp), jnp.asarray(vp),
                               jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(window))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    with pytest.raises(ValueError, match="does not cover"):
        tpa.scatter_chunk(tk, tv, _t(k[:, :6]), _t(v[:, :6]), _t(window))


# ------------------------------------------------------------- attention
def _decode_case(seed, lengths, bs=4, hq=4, hkv=2, d=16, t=4, pages=24):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((len(lengths), 1, hq, d)).astype(np.float32)
    kp = _pool(rng, pages, hkv, bs, d)
    vp = _pool(rng, pages, hkv, bs, d)
    tables = _tables(rng, lengths, t, bs, pages)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("lengths", [
    [1, 1],            # a single token
    [4, 2],            # exactly one block (bs), and mid-block
    [5, 16],           # bs + 1, and the full table (T * bs)
    [16, 7, 12, 3],
])
@pytest.mark.parametrize("jax_impl", ["dense", "pallas-interpret"])
def test_ragged_paged_attention_matches_jax(lengths, jax_impl):
    q, kp, vp, tables, lens = _decode_case(5, lengths)
    got = tpa.ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                     _t(lens))
    want = jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), impl=jax_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ragged_length_zero_is_zero_like_the_kernel():
    """A length-0 slot visits no page: the plain version returns 0, as
    the kernels (CUDA and the TPU one) do."""
    q, kp, vp, tables, lens = _decode_case(6, [0, 5])
    got = tpa.ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                     _t(lens))
    want = jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), impl="pallas-interpret")
    assert not got[0].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("offset,c,total", [
    (0, 8, 8),     # first window of a sequence
    (8, 8, 13),    # mid-sequence window, right-padded past the length
    (16, 8, 24),   # a later window attending two earlier pages' worth
])
@pytest.mark.parametrize("jax_impl", ["dense", "pallas-interpret"])
def test_paged_prefill_attention_matches_jax(offset, c, total, jax_impl):
    rng = np.random.default_rng(7 + offset)
    bs, hq, hkv, d, t, pages = 4, 4, 2, 16, 8, 24
    q = rng.standard_normal((1, c, hq, d)).astype(np.float32)
    kp = _pool(rng, pages, hkv, bs, d)
    vp = _pool(rng, pages, hkv, bs, d)
    table = _tables(rng, [total], t, bs, pages)[0]
    got = tpa.paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(table),
                                      offset)
    want = jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.int32(offset), impl=jax_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_versions_count_no_launches():
    q, kp, vp, tables, lens = _decode_case(8, [3, 9])
    tpa.reset_launch_counts()
    tpa.ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(lens))
    tpa.paged_prefill_attention(_t(q[:1, :1]).expand(1, 4, 4, 16)
                                .contiguous(), _t(kp), _t(vp),
                                _t(tables[1]), 4)
    assert tpa.ragged_paged_attention.launches == 0
    assert tpa.paged_prefill_attention.launches == 0


def test_resolve_paged_impl():
    cpu = torch.device("cpu")
    assert tpa.resolve_paged_impl(None, cpu) == "dense"
    assert tpa.resolve_paged_impl("auto", cpu) == "dense"
    assert tpa.resolve_paged_impl("dense", torch.device("cuda")) == "dense"
    assert tpa.resolve_paged_impl(None, torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="CUDA kernel"):
        tpa.resolve_paged_impl("cuda", cpu)
    with pytest.raises(ValueError, match="impl must be"):
        tpa.resolve_paged_impl("pallas", cpu)


def test_cuda_impl_on_cpu_tensors_raises_not_falls_back():
    q, kp, vp, tables, lens = _decode_case(9, [3, 9])
    with pytest.raises(ValueError, match="CUDA kernel"):
        tpa.ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                   _t(lens), impl="cuda")
    with pytest.raises(ValueError, match="CUDA kernel"):
        _kernels.paged_decode(_t(q), _t(kp), _t(vp), _t(tables), _t(lens))


def test_kernel_build_without_nvcc_names_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels.build()
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels.find_nvcc()


# ------------------------------------------------ speculative verify rows
@pytest.mark.parametrize("lengths", [
    [1, 5],            # one token; S - 1 rows cross a page edge (bs 4)
    [0, 16, 7],        # an inactive row; a row reaching past the table
])
@pytest.mark.parametrize("jax_impl", ["dense", "pallas-interpret"])
def test_ragged_verify_attention_matches_jax(lengths, jax_impl):
    """S = 3 staggered rows per sequence: row j at length ``len + j``. The
    JAX Pallas verify kernel walks only the table's T pages, as the port's
    does, so rows past the table agree too."""
    rng = np.random.default_rng(11)
    q, kp, vp, tables, lens = _decode_case(12, lengths)
    q = rng.standard_normal((len(lengths), 3, 4, 16)).astype(np.float32)
    got = tpa.ragged_verify_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                      _t(lens))
    want = jpa.ragged_verify_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), impl=jax_impl)
    live = np.asarray(lens)[:, None] + np.arange(3)[None] > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               **TOL)
    # The length-0 row gets 0, as the decode kernel gives at length 0.
    assert not got.numpy()[~live].any()


def test_verify_rows_are_the_decode_plain_version_at_staggered_lengths():
    """Each verify row is the decode plain version at ``len + j``, bit for
    bit: the contract the CUDA kernels hold on the card."""
    q, kp, vp, tables, lens = _decode_case(13, [3, 9])
    qv = np.random.default_rng(13).standard_normal((2, 4, 4, 16)).astype(
        np.float32)
    got = tpa.ragged_verify_attention(_t(qv), _t(kp), _t(vp), _t(tables),
                                      _t(lens))
    for j in range(4):
        row = tpa.ragged_paged_attention(_t(qv[:, j:j + 1]), _t(kp), _t(vp),
                                         _t(tables), _t(lens + j))
        assert torch.equal(got[:, j:j + 1], row)


# --------------------------------------------------------- quantized pools
QDTYPES = {"int8": (torch.int8, jnp.int8),
           "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


def _qpool(rng, kind, num_pages=12, hkv=2, bs=4, d=16):
    """Quantized pages and scales (made by the JAX quantizer from seeded
    normals), and the same as torch tensors."""
    from triton_kubernetes_tpu.ops import quantization as jq
    tdt, jdt = QDTYPES[kind]
    exact = rng.standard_normal((num_pages, hkv, bs, d)).astype(np.float32)
    qp, sc = jq.quantize_kv_pages(jnp.asarray(exact), jdt)
    qp_np = np.asarray(qp)
    t = torch.from_numpy(qp_np.view(np.uint8).copy()).view(tdt)
    return qp, sc, t, _t(np.array(sc))


def _bytes(x):
    """Page bytes (numpy uint8) of a torch or JAX 8-bit pool."""
    if isinstance(x, torch.Tensor):
        return tpa.byte_view(x).view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def test_gather_pages_with_scale_exact():
    rng = np.random.default_rng(20)
    tables = _tables(rng, [7, 12, 1], 3, 4, 12)
    for kind in QDTYPES:
        jp, js, tp, ts = _qpool(rng, kind)
        got = tpa.gather_pages(tp, _t(tables), ts)
        want = jpa.gather_pages(jp, jnp.asarray(tables), js)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_scatters_match_jax(kind):
    """The anchored-scale writes: a slot-0 token sets its page's scale,
    later slots quantize against it; span writes are token at a time and
    chunk writes re-anchor whole pages. Pages and scales are exact against
    JAX outside the trash page (colliding inactive writes land there)."""
    rng = np.random.default_rng(21)
    jk, jks, tk, tks = _qpool(rng, kind, num_pages=16)
    jv, jvs, tv, tvs = _qpool(rng, kind, num_pages=16)
    tables = _tables(rng, [12, 12, 0, 12], 3, 4, 16)

    def check():
        for t, j in ((tk, jk), (tv, jv)):
            np.testing.assert_array_equal(_bytes(t)[1:], _bytes(j)[1:])
        for t, j in ((tks, jks), (tvs, jvs)):
            np.testing.assert_array_equal(t.numpy()[1:], np.asarray(j)[1:])

    # Token writes: slots 2 and 1 (against the stored scale), slot 0 of a
    # page (sets its scale), and an inactive row (trash page).
    # Every active row owns 3 pages (12 slots).
    k = (rng.standard_normal((4, 1, 2, 16)) * 3).astype(np.float32)
    v = rng.standard_normal((4, 1, 2, 16)).astype(np.float32)
    pos = np.array([6, 4, 0, 9], np.int32)
    tpa.scatter_token(tk, tv, _t(k), _t(v), _t(tables), _t(pos), tks, tvs)
    jk, jv, jks, jvs = jpa.scatter_token(
        jk, jv, jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(pos), jks, jvs)
    check()
    # Spans of 3 crossing a page edge (slots 3, 0, 1), and one running
    # past the table (position 12: the trash page).
    ks = rng.standard_normal((4, 3, 2, 16)).astype(np.float32)
    vs = rng.standard_normal((4, 3, 2, 16)).astype(np.float32)
    start = np.array([7, 3, 0, 10], np.int32)
    tpa.scatter_span(tk, tv, _t(ks), _t(vs), _t(tables), _t(start), tks, tvs)
    jk, jv, jks, jvs = jpa.scatter_span(
        jk, jv, jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(tables),
        jnp.asarray(start), jks, jvs)
    check()
    # A two-page chunk.
    kc = rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
    window = np.array([5, 11], np.int32)
    tpa.scatter_chunk(tk, tv, _t(kc), _t(vc), _t(window), tks, tvs)
    jk, jv, jks, jvs = jpa.scatter_chunk(
        jk, jv, jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(window),
        jks, jvs)
    check()
    with pytest.raises(ValueError, match="both"):
        tpa.scatter_token(tk, tv, _t(k), _t(v), _t(tables), _t(pos), tks)


def _quant_case(rng, kind, lengths, t=4, pages=24):
    jk, jks, tk, tks = _qpool(rng, kind, num_pages=pages)
    jv, jvs, tv, tvs = _qpool(rng, kind, num_pages=pages)
    tables = _tables(rng, lengths, t, 4, pages)
    return (jk, jv, jks, jvs), (tk, tv, tks, tvs), tables


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("jax_impl", ["dense", "pallas-interpret"])
def test_quantized_plain_attention_matches_jax(kind, jax_impl):
    """The quantized plain versions (scores times the K scale, p kept in
    f32, P @ V times the V scale) against the JAX dense reference (which
    dequantizes first) and the JAX Pallas kernels' quantized branches, in
    f32 at 1e-5: decode, verify (S 3) and a prefill window."""
    rng = np.random.default_rng(22)
    lengths = [5, 16, 2]
    (jk, jv, jks, jvs), (tk, tv, tks, tvs), tables = _quant_case(
        rng, kind, lengths)
    lens = np.asarray(lengths, np.int32)
    q = rng.standard_normal((3, 3, 4, 16)).astype(np.float32)
    jt, jl = jnp.asarray(tables), jnp.asarray(lens)
    got = tpa.ragged_paged_attention(_t(q[:, :1]), tk, tv, _t(tables),
                                     _t(lens), tks, tvs)
    want = jpa.ragged_paged_attention(jnp.asarray(q[:, :1]), jk, jv, jt, jl,
                                      jks, jvs, impl=jax_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = tpa.ragged_verify_attention(_t(q), tk, tv, _t(tables), _t(lens),
                                      tks, tvs)
    want = jpa.ragged_verify_attention(jnp.asarray(q), jk, jv, jt, jl,
                                       jks, jvs, impl=jax_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    qp = rng.standard_normal((1, 8, 4, 16)).astype(np.float32)
    table = tables[1]
    got = tpa.paged_prefill_attention(_t(qp), tk, tv, _t(table), 8, tks, tvs)
    want = jpa.paged_prefill_attention(jnp.asarray(qp), jk, jv,
                                       jnp.asarray(table), jnp.int32(8),
                                       jks, jvs, impl=jax_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
