"""The paged prefill kernel's two designs (``csrc/paged_prefill.cu``), on
the CPU.

Which design a call runs is ``_kernels.paged_variant``'s table, by (q
dtype, page dtype, bs, D) alone: the tensor-core design (mma.sync over a
ring of 64-key stages) for bf16 queries at D 64/128, bs 16/32, on bf16,
int8 and fp8 pages; the CUDA-core design for the rest.

The C entries themselves are built here with g++ against the thread-level
emulation of ``scripts/cuda_emu/emu.h`` (shared memory, barriers, warp
shuffles, ldmatrix, mma.sync, cp.async), as ``emulate_paged.py`` does, and
driven with the arguments ``_kernels.paged_prefill`` passes. That checks
what the card cannot be asked here: that an entry refuses a design it is
not built for and a window outside the table, and that the tensor-core
design's indexing, fragment layouts, masking and ring give the JAX
package's answer -- held to one bf16 output ulp plus 1e-2 absolute (p is
rounded to bf16 in both, and the emulated mma sums in another order than
the reference) -- with every output row the same bits whatever window it
came in; and that the CUDA-core design's rows are the CUDA-core decode
kernel's rows bit for bit (fault F9: a preempted sequence's recompute takes
its next token from a prefill window's row where its solo run took it from
a decode tick). The emulation skips where there is no g++.
"""

import importlib.util
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.ops import paged_attention as jpa
from triton_kubernetes_tpu.ops import quantization as jq
from triton_kubernetes_tpu_torch.ops import _kernels
from triton_kubernetes_tpu_torch.ops import paged_attention as tpa

BF16_TOL = dict(rtol=2 ** -7, atol=1e-2)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
PAGES = {"same": None, "int8": torch.int8, "fp8": torch.float8_e4m3fn}
EMU = (Path(__file__).resolve().parents[1] / "scripts" / "cuda_emu"
       / "emulate_paged.py")


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("bs", [4, 8, 16, 32])
@pytest.mark.parametrize("pages", list(PAGES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_variant_is_chosen_by_shape(dtype, pages, bs, d):
    """bf16 queries at D 64/128, bs 16/32 go to the tensor cores on every
    page kind; f32 queries and the other widths and block sizes stay on
    the CUDA cores -- the same table entry decode and verify read."""
    page_dtype = PAGES[pages] or dtype
    want = ("tensor_core" if dtype == torch.bfloat16 and bs in (16, 32)
            and d in (64, 128) else "cuda_core")
    assert _kernels.paged_variant(dtype, page_dtype, bs, d) == want
    assert ((dtype, page_dtype, bs, d) in _kernels.PAGED_TENSOR_CORE) == (
        want == "tensor_core")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The prefill and decode C entries built with g++ against emu.h."""
    if shutil.which("g++") is None:
        pytest.skip("the CUDA emulation builds with g++, which is missing")
    spec = importlib.util.spec_from_file_location("emulate_paged", EMU)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    libs = mod.build(tmp_path_factory.mktemp("emu"),
                     ("paged_prefill", "paged_decode"))
    return mod.Emulated(libs)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pages(seed, kind, tw, hkv, bs, d):
    """A table of ``tw`` permuted pages (trash page poisoned) of ``kind``,
    as the JAX package's arrays and the port's tensors: (table, jax (k, v,
    ks, vs), torch (k, v, ks, vs))."""
    rng = np.random.default_rng(seed)
    exact = [rng.standard_normal((1 + tw, hkv, bs, d)).astype(np.float32)
             for _ in range(2)]
    for e in exact:
        e[tpa.TRASH_PAGE] = 1e4
    table = (rng.permutation(tw) + 1).astype(np.int32)
    if kind == "bf16":
        j = [jnp.asarray(e, jnp.bfloat16) for e in exact] + [None, None]
        t = [_t(e).to(torch.bfloat16) for e in exact] + [None, None]
        return table, j, t
    jdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[kind]
    (jk, jks), (jv, jvs) = (jq.quantize_kv_pages(jnp.asarray(e), jdt)
                            for e in exact)
    tk, tv = (_t(np.asarray(x).view(np.uint8).copy()).view(PAGES[kind])
              for x in (jk, jv))
    return table, [jk, jv, jks, jvs], [tk, tv, _t(np.array(jks)),
                                       _t(np.array(jvs))]


def _q(seed, c, hq, d):
    q = np.random.default_rng(seed).standard_normal((1, c, hq, d))
    return q.astype(np.float32)


REFUSALS = {
    # (what, q dtype, page kind, d, bs, C, offset, table pages, variant)
    "tensor_core for f32 queries": (
        torch.float32, "same", 64, 16, 8, 0, 4, "tensor_core"),
    "tensor_core at bs 8": (
        torch.bfloat16, "same", 64, 8, 8, 0, 4, "tensor_core"),
    "tensor_core at D 96": (
        torch.bfloat16, "same", 96, 16, 8, 0, 4, "tensor_core"),
    "tensor_core for f32 queries on int8 pages": (
        torch.float32, "int8", 64, 16, 8, 0, 4, "tensor_core"),
    "an unknown design": (torch.bfloat16, "same", 64, 16, 8, 0, 4, 7),
    "a window past the table (tensor_core)": (
        torch.bfloat16, "same", 64, 16, 8, 60, 4, "tensor_core"),
    "a window past the table (cuda_core)": (
        torch.float32, "same", 64, 16, 8, 60, 4, "cuda_core"),
    "a negative offset": (
        torch.bfloat16, "same", 64, 16, 8, -1, 4, "tensor_core"),
    "8-bit pages without scales": (
        torch.bfloat16, "fp8", 64, 16, 8, 0, 4, "tensor_core"),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_prefill_entry_refuses(emu, what):
    """The C entry returns an error and launches nothing: the output keeps
    the NaN it was filled with."""
    dtype, pages, d, bs, c, offset, tw, variant = REFUSALS[what]
    page_dtype = PAGES[pages] or dtype
    kp = torch.zeros((1 + tw, 2, bs, d)).to(page_dtype)
    sc = None if page_dtype == dtype else torch.ones((1 + tw, 2))
    if what == "8-bit pages without scales":
        sc = None
    q = torch.ones((1, c, 4, d), dtype=dtype)
    table = torch.arange(1, tw + 1, dtype=torch.int32)
    code = (_kernels.PAGED_VARIANTS[variant] if isinstance(variant, str)
            else variant)
    rc, out = emu.prefill(q, kp, kp, table, offset, sc, sc, code)
    assert rc != 0
    assert bool(out.float().isnan().all())


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("jax_impl", ["dense", "pallas-interpret"])
def test_tensor_core_prefill_matches_jax(emu, kind, jax_impl):
    """bf16 queries, D 64, bs 16, group 4: 20 tokens at offset 19 (80 rows
    a KV head, a ragged second row tile; the window starts and ends inside
    a 64-key stage) through the emulated tensor-core design and the JAX
    package, and the port's plain version beside them."""
    hq, hkv, d, bs, c, offset = 8, 2, 64, 16, 20, 19
    table, jp, tp = _pages(41, kind, 5, hkv, bs, d)
    q = _q(42, c, hq, d)
    qb = _t(q).to(torch.bfloat16)
    assert _kernels.paged_variant(qb.dtype, tp[0].dtype, bs,
                                  d) == "tensor_core"
    rc, got = emu.prefill(qb, tp[0], tp[1], _t(table), offset, tp[2], tp[3])
    assert rc == 0
    want = jpa.paged_prefill_attention(
        jnp.asarray(q, jnp.bfloat16), jp[0], jp[1], jnp.asarray(table),
        jnp.int32(offset), jp[2], jp[3], impl=jax_impl)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)
    plain = tpa.paged_prefill_attention(qb, tp[0], tp[1], _t(table), offset,
                                        tp[2], tp[3])
    torch.testing.assert_close(got.float(), plain.float(), **BF16_TOL)


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_tensor_core_prefill_rows_do_not_depend_on_the_window(emu, kind):
    """Positions 42-63 through a 48-token window at offset 16 (rows 104-191
    of a KV head: the second and third row tiles) and through a 22-token
    window at offset 42 (rows 0-87): the same bits, D 128, bs 32. The two
    windows put a position 104 rows apart, so each row sits at another
    row of its warp's 16 (g + 8 against g) and in another warp."""
    hq, hkv, d, bs = 8, 2, 128, 32
    _, _, (kp, vp, ks, vs) = _pages(43, kind, 3, hkv, bs, d)
    table = _t(np.array([3, 1, 2], np.int32))
    q = _t(_q(44, 48, hq, d)).to(torch.bfloat16)
    rc_a, whole = emu.prefill(q, kp, vp, table, 16, ks, vs)
    rc_b, part = emu.prefill(q[:, 26:].contiguous(), kp, vp, table, 42, ks,
                             vs)
    assert rc_a == rc_b == 0
    assert torch.equal(whole[:, 26:], part)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_tensor_core_prefill_converts_every_8bit_value_exactly(emu, kind):
    """A one-token window at offset 0 sees one key, so its p is 1 and each
    output row is that key's V row times its scale (1 here), rounded to
    bf16: the 256 byte values laid along two KV heads of 128 columns come
    out as the exact bf16 of their int8 or e4m3 value (e4m3's NaN bytes
    left out)."""
    dtype = PAGES[kind]
    vals = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    if kind == "fp8":
        vals[(vals & 0x7f) == 0x7f] = 0
    vp = torch.zeros((2, 2, 16, 128), dtype=torch.uint8)
    vp[1, :, 0] = vals.reshape(2, 128)
    vp = vp.view(dtype)
    kp = vp.clone()
    sc = torch.ones((2, 2))
    q = torch.randn((1, 1, 2, 128), generator=torch.Generator().manual_seed(5)
                    ).to(torch.bfloat16)
    rc, got = emu.prefill(q, kp, vp, torch.tensor([1], dtype=torch.int32), 0,
                          sc, sc)
    assert rc == 0
    assert torch.equal(got[0, 0], vp[1, :, 0].float().to(torch.bfloat16))


def test_cuda_core_prefill_matches_jax(emu):
    """f32 queries over f32 pages, bs 8, D 32, group 3: the emulated
    CUDA-core design against the JAX Pallas kernel in interpret mode, in
    f32 (summation order only)."""
    hq, hkv, d, bs, c, offset = 6, 2, 32, 8, 14, 11
    table, _, _ = _pages(45, "bf16", 4, hkv, bs, d)
    rng = np.random.default_rng(46)
    kp, vp = (rng.standard_normal((5, hkv, bs, d)).astype(np.float32)
              for _ in range(2))
    q = _q(47, c, hq, d)
    assert _kernels.paged_variant(torch.float32, torch.float32, bs,
                                  d) == "cuda_core"
    rc, got = emu.prefill(_t(q), _t(kp), _t(vp), _t(table), offset, None,
                          None)
    assert rc == 0
    want = jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.int32(offset), impl="pallas-interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# (q dtype, page kind, D, bs, Hq, Hkv): every shape the CUDA-core designs
# serve -- the chaos arms' pools (bf16, bs 4, D 128, the 8B's GQA group 4)
# on every page kind, bs 8, and f32 queries at a tensor-core width.
RECOMPUTE_CASES = [(torch.bfloat16, "bf16", 128, 4, 8, 2),
                   (torch.bfloat16, "int8", 128, 4, 8, 2),
                   (torch.bfloat16, "fp8", 128, 4, 8, 2),
                   (torch.bfloat16, "bf16", 64, 8, 4, 2),
                   (torch.float32, "bf16", 128, 16, 4, 1)]


@pytest.mark.parametrize("dtype,kind,d,bs,hq,hkv", RECOMPUTE_CASES,
                         ids=["bf16-bs4", "int8-bs4", "fp8-bs4",
                              "bf16-bs8-d64", "f32q-bs16"])
def test_cuda_core_prefill_rows_are_the_decode_rows(emu, dtype, kind, d, bs,
                                                    hq, hkv):
    """Every row of CUDA-core prefill windows -- at offset 0, mid-table,
    a ragged last window, a row alone -- is torch.equal to the CUDA-core
    decode kernel's output for that query at its length (length = the
    row's position + 1), on the same pages: the same per-row operations
    in the same order, the page's sum of exps in the decode's lane
    order."""
    tw = 12
    table, _, (kp, vp, ks, vs) = _pages(60 + bs, kind, tw, hkv, bs, d)
    if kind == "bf16" and dtype == torch.float32:
        kp, vp = kp.float(), vp.float()
    table = _t(table)
    assert _kernels.paged_variant(dtype, kp.dtype, bs, d) == "cuda_core"
    for c, offset in ((16, 0), (8, 8), (5, 24), (1, 29), (24, 21)):
        q = _t(_q(c + offset, c, hq, d)).to(dtype)
        rc, rows = emu.prefill(q, kp, vp, table, offset, ks, vs)
        assert rc == 0
        lens = torch.arange(offset + 1, offset + c + 1, dtype=torch.int32)
        dec = emu("paged_decode", q[0][:, None].contiguous(), kp, vp,
                  table[None].expand(c, tw).contiguous(), lens, ks, vs)
        assert torch.equal(rows[0], dec[:, 0]), (c, offset)
