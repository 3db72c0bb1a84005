"""The row-invariant decode GEMM's C entries (``csrc/decode_gemm.cu``), on
the CPU.

The CUDA source is built here with g++ against the thread-level emulation
of ``scripts/cuda_emu/emu.h`` (shared memory, barriers, ldmatrix,
mma.sync, cp.async, atomics; blocks run one at a time in a shuffled
order), as ``emulate_paged.py`` builds the paged kernels, and its C
entries are driven with the arguments ``_kernels.decode_gemm`` passes:
groups of one to three products of one input, ragged widths, and K cut
into ranges (S > 1) whose f32 partials the last block of each tile adds
in range order. That checks what the card cannot be asked here:

* every product within the card's tolerance of the plain version (bf16
  out: one output ulp plus 1e-2; f32 out: the bound any order of an f32
  sum of K products obeys), and of the JAX package's ``weight_einsum``;
* rows at M 1, 3, 8, 17, 33 and 63 bitwise the rows at M 64 (all three
  row-tile variants), which is what keeps a verify row the decode row;
* a prefill window's M (130 or 256) in one launch, its rows in row tiles
  of 64 side by side: each row tile bitwise a launch of its rows alone;
* the same bits whatever order the blocks run in, so the merge does not
  depend on which block arrives last; the arrival counters back at 0;
* the entries' refusals.

The W8A8 entries (``tk8s_decode_gemm_{s8,e4m3}_{bf16,f32}``: an 8-bit
activation quantized per row times a weight stored [N, K] quantized per
column; int8 on mma.sync m16n8k32 up to 64 rows, fp8 on the wgmma kernel
at every M) too: int8 rows bitwise their plain version (an exact integer
sum, merged in int32) at every M of 1-63 with K forced into 1-4 ranges,
at both tile widths and in two block orders; fp8 within one bf16 ulp of
its plain version, rows bitwise the rows at M 64.

Past 64 rows the entries run the wgmma kernel (two warpgroups of 64 rows
fed through a cp.async ring on mbarriers; the emulation reads wgmma's
operands through their descriptors and the 128-byte swizzle): at M 65,
100, 128 and 256, bf16, int8 and fp8, every row within tolerance of the
plain version and bitwise the same row through launches of at most 64
rows, ragged last one included; two block orders bitwise; and the bit
probe's C entries, whose two chains agree in the emulation.

The emulated mma.sync and wgmma sum a k step's 16 (bf16, f16) or 32
(fp8) products in order in f32, unlike the card's tensor cores, so
nothing here is compared with the card's bits (the int8 sum is exact on
both). The emulation skips only where there is no g++.
"""

import ctypes
import importlib.util
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import llama as jllama
from triton_kubernetes_tpu_torch.ops import _kernels
from triton_kubernetes_tpu_torch.ops import decode_gemm as dg
from triton_kubernetes_tpu_torch.ops import quantization as qz

EMU = (Path(__file__).resolve().parents[1] / "scripts" / "cuda_emu"
       / "emulate_paged.py")
# (operand dtype, output dtype): the three C entries, by suffix.
DTYPES = pytest.mark.parametrize(
    "dtype,out_dtype", list(_kernels.GEMM_SUFFIXES),
    ids=list(_kernels.GEMM_SUFFIXES.values()))
# (K, the group's widths, S, tile width): None is the wrapper's choice
# (``gemm_splits`` 2 and ``gemm_tile`` 64 for the first); the others force
# ranges of unequal length (K 512 in 3, K 1024 in 5), one range a k
# tile, and both tile widths over ragged edges.
GROUPS = [(1024, (200,), None, None), (512, (64, 24, 8), 3, 64),
          (1024, (24, 200), 5, 128), (512, (8,), 1, 64),
          (128, (136, 8), 2, 128)]
TILES = pytest.mark.parametrize("tile_n", [64, 128])


def _workspace(ns, m, splits, tile_n):
    """Words of a launch's workspace, as ``_kernels._gemm_split`` sizes it:
    one slab of ``splits`` partials a (column tile, row tile) pair."""
    tiles = sum(-(-n // tile_n) for n in ns) * max(1, -(-m // 64))
    return max(1, tiles * splits * max(1, min(m, 64)) * tile_n)


class EmulatedGemm:
    """The emulated C entries, called as ``_kernels.decode_gemm`` calls
    the real ones; outputs, workspace and unused arguments NaN-poisoned."""

    def __init__(self, lib):
        self.lib = lib
        self.counters = torch.zeros(4096, dtype=torch.int32)

    def seed(self, seed):
        self.lib.emu_set_shuffle_seed(ctypes.c_uint(seed))

    def rc(self, x, ws, ys, splits, tile_n=64, count=None, m=None):
        """The C entry's return code; ``count`` and ``m`` override what
        is passed."""
        ns = [w.shape[1] for w in ws]
        rows = x.shape[0] if m is None else m
        work = torch.full((_workspace(ns, rows, splits, tile_n),),
                          float("nan"))
        pad = _kernels.MAX_GEMM_PROBLEMS - len(ws)
        suffix = _kernels.GEMM_SUFFIXES[(x.dtype, ys[0].dtype)]
        return getattr(self.lib, f"tk8s_decode_gemm_{suffix}")(
            x.data_ptr(), *[w.data_ptr() for w in ws][:3], *[None] * pad,
            *[y.data_ptr() for y in ys][:3], *[None] * pad, *ns[:3],
            *[0] * pad, len(ws) if count is None else count, rows,
            x.shape[1], tile_n, splits, work.data_ptr(),
            self.counters.data_ptr(), None)

    def w8a8_rc(self, xq, xs, ws, scales, ys, splits, tile_n=64, k=None):
        """The W8A8 C entry's return code; ``k`` overrides what is
        passed."""
        ns = [w.shape[0] for w in ws]
        work = torch.full((_workspace(ns, xq.shape[0], splits, tile_n),),
                          -7, dtype=torch.int32)
        pad = _kernels.MAX_GEMM_PROBLEMS - len(ws)
        suffix = _kernels.W8A8_SUFFIXES[(xq.dtype, ys[0].dtype)]
        return getattr(self.lib, f"tk8s_decode_gemm_{suffix}")(
            xq.data_ptr(), xs.data_ptr(), *[w.data_ptr() for w in ws],
            *[None] * pad, *[sc.data_ptr() for sc in scales], *[None] * pad,
            *[y.data_ptr() for y in ys], *[None] * pad, *ns, *[0] * pad,
            len(ws), xq.shape[0], xq.shape[1] if k is None else k, tile_n,
            splits, work.data_ptr(), self.counters.data_ptr(), None)

    def w8a8(self, xq, xs, ws, scales, out_dtype, splits, tile_n=64):
        """The outputs of one W8A8 launch."""
        ys = [torch.full((xq.shape[0], w.shape[0]), float("nan"),
                         dtype=out_dtype) for w in ws]
        rc = self.w8a8_rc(xq, xs, ws, scales, ys, splits, tile_n)
        assert rc == 0, f"the W8A8 C entry refused ({rc})"
        assert not self.counters.any(), "arrival counters left non-zero"
        return ys

    def __call__(self, x, ws, out_dtype, splits=None, tile_n=None):
        """The outputs of one launch; S and the tile width default to the
        wrapper's choices."""
        n_total = sum(w.shape[1] for w in ws)
        if splits is None:
            splits = _kernels.gemm_splits(n_total, x.shape[1])
        if tile_n is None:
            tile_n = _kernels.gemm_tile(n_total)
        ys = [torch.full((x.shape[0], w.shape[1]), float("nan"),
                         dtype=out_dtype) for w in ws]
        rc = self.rc(x, ws, ys, splits, tile_n)
        assert rc == 0, f"the C entry refused ({rc})"
        assert not self.counters.any(), "arrival counters left non-zero"
        return ys


@pytest.fixture(scope="module")
def gemm(tmp_path_factory):
    """decode_gemm.cu built with g++ against emu.h."""
    if shutil.which("g++") is None:
        pytest.skip("the CUDA emulation builds with g++, which is missing")
    spec = importlib.util.spec_from_file_location("emulate_paged", EMU)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.build(tmp_path_factory.mktemp("emu"), ("decode_gemm",))
    lib = lib["decode_gemm"]
    lib.emu_set_shuffle_seed.argtypes = [ctypes.c_uint]
    return EmulatedGemm(lib)


def _inputs(seed, m, k, ns, dtype):
    """x [m, k] and weights [k, n] for n in ns, from a seeded numpy
    generator, as f32 numpy arrays and as tensors of ``dtype`` (the numpy
    arrays hold the tensors' values exactly)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         ).to(dtype)
    ws = [torch.from_numpy((0.05 * rng.standard_normal((k, n))).astype(
        np.float32)).to(dtype) for n in ns]
    return (x.float().numpy(), [w.float().numpy() for w in ws]), (x, ws)


def _assert_close(got, want, x, w, out_dtype):
    """bf16 out: one output ulp plus 1e-2 of the plain product. f32 out:
    |y - exact| <= 1.01 K 2^-24 sum_k |x_k w_k| (exact in f64)."""
    assert bool(torch.isfinite(got).all())
    if out_dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                                   rtol=2 ** -7)
        return
    exact = x.double() @ w.double()
    bound = 1.01 * x.shape[1] * 2.0 ** -24 * (x.double().abs()
                                              @ w.double().abs())
    assert bool(((got.double() - exact).abs() <= bound).all())


@pytest.mark.parametrize("k,ns,splits,tile_n", GROUPS)
@DTYPES
def test_emulated_gemm_matches_plain(gemm, dtype, out_dtype, k, ns, splits,
                                     tile_n):
    """Each product of a group, at M 20 (two 16-row tiles), against
    ``decode_gemm_group_plain``."""
    _, (x, ws) = _inputs(k + len(ns), 20, k, ns, dtype)
    got = gemm(x, ws, out_dtype, splits, tile_n)
    want = dg.decode_gemm_group_plain(x, ws, out_dtype)
    for y, w, p in zip(got, ws, want):
        _assert_close(y, p, x, w, out_dtype)


@TILES
@DTYPES
def test_emulated_gemm_rows_do_not_depend_on_m(gemm, dtype, out_dtype,
                                               tile_n):
    """Rows at M 1, 3, 8, 17, 33 and 63 (one, two and four 16-row tiles)
    are bitwise the rows at M 64, with K split in three."""
    _, (x, ws) = _inputs(64, 64, 1024, (64, 24, 200), dtype)
    full = gemm(x, ws, out_dtype, 3, tile_n)
    for m in (1, 3, 8, 17, 33, 63):
        part = gemm(x[:m].contiguous(), ws, out_dtype, 3, tile_n)
        for a, b in zip(part, full):
            assert torch.equal(a, b[:m]), m


@TILES
@DTYPES
def test_emulated_gemm_merge_does_not_depend_on_block_order(gemm, dtype,
                                                            out_dtype,
                                                            tile_n):
    """Two runs whose blocks run, and so arrive, in other orders give the
    same bits: the last block adds the partials in range order."""
    _, (x, ws) = _inputs(5, 24, 1024, (24, 200), dtype)
    runs = []
    for seed in (1, 2):
        gemm.seed(seed)
        runs.append(gemm(x, ws, out_dtype, 5, tile_n))
    gemm.seed(12345)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_gemm_matches_jax_weight_einsum(gemm, dtype):
    """A wq/wk/wv group at a small width (D 512 with 8 heads of 32 and 2
    KV heads), through one emulated launch with K split in two, against
    the reference's ``weight_einsum`` of each weight on the same numpy
    inputs: f32 within the sum bound's order of magnitude (1e-5), bf16
    within one output ulp plus 1e-2."""
    tdt = getattr(torch, dtype)
    (xn, wns), (x, ws) = _inputs(9, 12, 512, (256, 64, 64), tdt)
    got = gemm(x, ws, tdt, 2, 64)
    cfg = jget_config("llama-test", dtype=dtype)
    for y, wn in zip(got, wns):
        want = jllama.weight_einsum(
            "md,dn->mn", jnp.asarray(xn).astype(cfg.activation_dtype),
            jnp.asarray(wn), cfg)
        tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
               else dict(rtol=2 ** -7, atol=1e-2))
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   **tol)


def test_emulated_gemm_entries_refuse(gemm):
    """A group of 0 or 4 products, M 0, K or N not a multiple of 8, a tile
    width other than 64 or 128, S outside 1-16 or past K's k tiles, and S
    > 1 without a workspace: the entry returns an error and launches
    nothing."""
    _, (x, ws) = _inputs(3, 8, 128, (64, 64, 64), torch.bfloat16)
    ys = [torch.empty((8, 64), dtype=torch.bfloat16) for _ in ws]
    assert gemm.rc(x, ws, ys, 1) == 0
    assert gemm.rc(x, ws, ys, 1, count=0) != 0
    assert gemm.rc(x, ws, ys, 1, count=4) != 0
    assert gemm.rc(x, ws, ys, 1, m=0) != 0
    assert gemm.rc(x, ws, ys, 1, tile_n=96) != 0
    assert gemm.rc(x, ws, ys, 1, tile_n=128) == 0
    assert gemm.rc(x, ws, ys, 0) != 0
    assert gemm.rc(x, ws, ys, 3) != 0  # K 128 holds two k tiles
    x17 = torch.zeros((8, 1088), dtype=torch.bfloat16)
    w17 = [torch.zeros((1088, 64), dtype=torch.bfloat16)]
    assert gemm.rc(x17, w17, ys[:1], 17) != 0
    assert gemm.rc(x17, w17, ys[:1], 16) == 0
    assert not gemm.counters.any()
    x12 = torch.zeros((8, 12), dtype=torch.bfloat16)
    assert gemm.rc(x12, [torch.zeros((12, 64), dtype=torch.bfloat16)],
                   ys[:1], 1) != 0
    n12 = [torch.zeros((128, 12), dtype=torch.bfloat16)]
    assert gemm.rc(x, n12, [torch.empty((8, 12), dtype=torch.bfloat16)],
                   1) != 0
    suffix = _kernels.GEMM_SUFFIXES[(torch.bfloat16, torch.bfloat16)]
    assert getattr(gemm.lib, f"tk8s_decode_gemm_{suffix}")(
        x.data_ptr(), ws[0].data_ptr(), None, None, ys[0].data_ptr(), None,
        None, 64, 0, 0, 1, 8, 128, 64, 2, None, None, None) != 0


def _w8a8_inputs(seed, m, k, ns, qdtype):
    """x [m, k] quantized per row, and weights [k, n] for n in ns
    quantized per column and stored [n, k], from a seeded numpy
    generator."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    xq, xs = qz.quantize_rows_plain(x, qdtype)
    pairs = [qz.quantize_channelwise(torch.from_numpy(
        (0.05 * rng.standard_normal((k, n))).astype(np.float32)), 0, qdtype)
        for n in ns]
    return (xq, xs, [w.t().contiguous() for w, _ in pairs],
            [sc.reshape(-1).contiguous() for _, sc in pairs])


W8A8_OUT = pytest.mark.parametrize("out_dtype", [torch.bfloat16,
                                                 torch.float32],
                                   ids=["bf16", "f32"])


@pytest.mark.parametrize("out_dtype,rows", [
    (torch.bfloat16, range(1, 65)), (torch.float32, (1, 8, 17, 32, 63))],
    ids=["bf16", "f32"])
def test_emulated_w8a8_int8_rows_are_bitwise_the_plain_version(
        gemm, out_dtype, rows):
    """int8 at every M of 1-64 (bf16 out; f32 out at five), K cut into 1-4
    ranges (forced, S = 1 + M % 4) at both tile widths: each output bitwise
    ``w8a8_gemm_group_plain`` (exact int32 sums merged in int32, the f32
    epilogue in the reference's order), so bitwise the rows at M 64."""
    xq, xs, ws, scales = _w8a8_inputs(5, 64, 512, (24, 136), torch.int8)
    for m in rows:
        got = gemm.w8a8(xq[:m].contiguous(), xs[:m].contiguous(), ws,
                        scales, out_dtype, 1 + m % 4, (64, 128)[m % 2])
        want = dg.w8a8_gemm_group_plain(xq[:m], xs[:m], ws, scales,
                                        out_dtype)
        for a, b in zip(got, want):
            assert torch.equal(a, b), m


@W8A8_OUT
def test_emulated_w8a8_int8_merge_does_not_depend_on_block_order(gemm,
                                                                 out_dtype):
    xq, xs, ws, scales = _w8a8_inputs(7, 20, 512, (24, 200), torch.int8)
    runs = []
    for seed in (1, 2):
        gemm.seed(seed)
        runs.append(gemm.w8a8(xq, xs, ws, scales, out_dtype, 4, 64))
    gemm.seed(12345)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("splits,tile_n", [(1, 128), (3, 64)])
@W8A8_OUT
def test_emulated_w8a8_fp8_matches_plain_and_rows_do_not_depend_on_m(
        gemm, out_dtype, splits, tile_n):
    """fp8 within one bf16 ulp plus 1e-2 of its plain version (f32 sums in
    another order), rows at M 1, 9, 17, 33 and 63 bitwise the rows at M 64,
    and two block orders bitwise."""
    xq, xs, ws, scales = _w8a8_inputs(11, 64, 512, (64, 24),
                                      torch.float8_e4m3fn)
    full = gemm.w8a8(xq, xs, ws, scales, out_dtype, splits, tile_n)
    for a, b in zip(full, dg.w8a8_gemm_group_plain(xq, xs, ws, scales,
                                                   out_dtype)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a.float(), b.float(), atol=1e-2,
                                   rtol=2 ** -7)
    for m in (1, 9, 17, 33, 63):
        part = gemm.w8a8(xq[:m].contiguous(), xs[:m].contiguous(), ws,
                         scales, out_dtype, splits, tile_n)
        for a, b in zip(part, full):
            assert torch.equal(a, b[:m]), m
    gemm.seed(3)
    again = gemm.w8a8(xq, xs, ws, scales, out_dtype, splits, tile_n)
    gemm.seed(12345)
    for a, b in zip(again, full):
        assert torch.equal(a, b)


def test_emulated_w8a8_entries_refuse(gemm):
    """K not a multiple of 16, S past K's 128-wide k tiles, a missing
    activation or weight scale, and M 0: the entry returns an error and
    launches nothing."""
    xq, xs, ws, scales = _w8a8_inputs(3, 8, 256, (64,), torch.int8)
    ys = [torch.empty((8, 64), dtype=torch.bfloat16)]
    assert gemm.w8a8_rc(xq, xs, ws, scales, ys, 2) == 0
    assert gemm.w8a8_rc(xq, xs, ws, scales, ys, 3) != 0  # K 256: 2 tiles
    assert gemm.w8a8_rc(xq, xs, ws, scales, ys, 1, k=248) != 0
    suffix = _kernels.W8A8_SUFFIXES[(torch.int8, torch.bfloat16)]
    entry = getattr(gemm.lib, f"tk8s_decode_gemm_{suffix}")

    def rc(x_scale, w_scale, m):
        return entry(xq.data_ptr(), x_scale, ws[0].data_ptr(), None, None,
                     w_scale, None, None, ys[0].data_ptr(), None, None, 64,
                     0, 0, 1, m, 256, 64, 1, None, None, None)

    assert rc(xs.data_ptr(), scales[0].data_ptr(), 8) == 0
    assert rc(None, scales[0].data_ptr(), 8) != 0
    assert rc(xs.data_ptr(), None, 8) != 0
    assert rc(xs.data_ptr(), scales[0].data_ptr(), 0) != 0
    assert not gemm.counters.any()


@pytest.mark.parametrize("kind,m", [("bf16", 256), ("f32", 130),
                                    ("int8", 130), ("fp8", 130)])
def test_emulated_row_tiles_are_bitwise_launches_of_64_rows(gemm, kind, m):
    """M past 64 in one launch (row tiles of 64 in the grid, K split in
    two): each row tile's outputs bitwise a launch of those rows alone, for
    the bf16 and f32 entries and the W8A8 ones."""
    k, ns = 512, (24, 136)
    if kind in ("bf16", "f32"):
        dtype = getattr(torch, {"bf16": "bfloat16", "f32": "float32"}[kind])
        _, (x, ws) = _inputs(m, m, k, ns, dtype)
        full = gemm(x, ws, dtype, 2, 64)
        parts = [gemm(x[r:r + 64].contiguous(), ws, dtype, 2, 64)
                 for r in range(0, m, 64)]
    else:
        qdtype = torch.int8 if kind == "int8" else torch.float8_e4m3fn
        xq, xs, ws, scales = _w8a8_inputs(m, m, k, ns, qdtype)
        full = gemm.w8a8(xq, xs, ws, scales, torch.bfloat16, 2, 128)
        parts = [gemm.w8a8(xq[r:r + 64].contiguous(),
                           xs[r:r + 64].contiguous(), ws, scales,
                           torch.bfloat16, 2, 128) for r in range(0, m, 64)]
    for i, part in enumerate(parts):
        for a, b in zip(part, full):
            assert torch.equal(a, b[64 * i:64 * (i + 1)]), i


# M past 64: the wgmma kernel (two warpgroups of 64 rows, the M <= 64
# kernels' chains of k steps). (kind, tile width, S): bf16 with bf16 or
# f32 out, int8 and fp8, both tile widths, K whole or split.
WGMMA_CASES = [("bf16", 64, 1), ("bf16", 128, 3), ("bf16_f32", 64, 2),
               ("bf16_f32", 128, 1), ("int8", 64, 2), ("int8", 128, 1),
               ("fp8", 64, 3), ("fp8", 128, 2)]


def _wgmma_launch(gemm, kind, k, ns, seed, m):
    """(launch(lo, rows) -> outputs of one launch on rows lo .. lo + rows
    - 1, plain(rows) -> the plain version's outputs on rows 0 .. rows - 1)
    for a group of ``kind`` at M up to ``m``."""
    if kind.startswith("bf16"):
        out = torch.float32 if kind == "bf16_f32" else torch.bfloat16
        _, (x, ws) = _inputs(seed, m, k, ns, torch.bfloat16)
        return ((lambda lo, r, splits, tile: gemm(
                    x[lo:lo + r].contiguous(), ws, out, splits, tile)),
                (lambda r: dg.decode_gemm_group_plain(x[:r], ws, out)),
                out)
    qdtype = torch.int8 if kind == "int8" else torch.float8_e4m3fn
    xq, xs, ws, scales = _w8a8_inputs(seed, m, k, ns, qdtype)
    return ((lambda lo, r, splits, tile: gemm.w8a8(
                xq[lo:lo + r].contiguous(), xs[lo:lo + r].contiguous(), ws,
                scales, torch.bfloat16, splits, tile)),
            (lambda r: dg.w8a8_gemm_group_plain(xq[:r], xs[:r], ws, scales,
                                                torch.bfloat16)),
            torch.bfloat16)


@pytest.mark.parametrize("kind,tile_n,splits", WGMMA_CASES)
def test_emulated_wgmma_rows_match_plain_and_mma_sync_launches(
        gemm, kind, tile_n, splits):
    """At M 65, 100, 128 and 256 (one launch each, the wgmma kernel; rows
    past M in its last row block), every output within tolerance of the
    plain version (int8 ``torch.equal``), and every row bitwise the same
    row through launches of at most 64 rows (mma.sync), the last one
    ragged. Widths 24 and 136 leave ragged column tiles at both widths
    and, for int8's two-tile column blocks, a lone tile."""
    k, ns = 512, (24, 136)
    launch, plain, out = _wgmma_launch(gemm, kind, k, ns, 40 + tile_n, 256)
    for m in (65, 100, 128, 256):
        got = launch(0, m, splits, tile_n)
        for a, b in zip(got, plain(m)):
            assert bool(torch.isfinite(a).all())
            if kind == "int8":
                assert torch.equal(a, b), m
            elif out == torch.float32:
                torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
            else:
                torch.testing.assert_close(a.float(), b.float(), atol=1e-2,
                                           rtol=2 ** -7)
        tiles = [launch(lo, min(64, m - lo), splits, tile_n)
                 for lo in range(0, m, 64)]
        for a, parts in zip(got, zip(*tiles)):
            assert torch.equal(a, torch.cat(parts)), m


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_emulated_wgmma_merge_does_not_depend_on_block_order(gemm, kind):
    """A 192-row launch (two row blocks, the second half past M) with K cut
    into four ranges, run with its blocks in two orders: the same bits, and
    the arrival counters back at 0."""
    launch, _, _ = _wgmma_launch(gemm, kind, 1024, (64, 200), 9, 192)
    runs = []
    for seed in (1, 2):
        gemm.seed(seed)
        runs.append(launch(0, 192, 4, 64))
    gemm.seed(12345)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["bf16", "s8", "e4m3", "e4m3_f16"])
def test_emulated_probe_chains_agree(gemm, kind):
    """The bit probe's C entry (``tk8s_gemm_probe_*``): its mma.sync chain
    and its wgmma chain over the same shared tiles agree bitwise in the
    emulation (each k step summed in order, then added, both ways; for
    e4m3 converted to f16, two wgmma k16 steps a k32 step, within f32
    rounding), and the mma.sync chain is within f32 rounding of C + A B
    (int8 exact): what the card's run of the probe then compares is the
    tensor cores' rounding alone."""
    rng = np.random.default_rng(7)
    steps = 8
    if kind == "bf16":
        a = torch.from_numpy(rng.standard_normal((64, 16 * steps)).astype(
            np.float32)).bfloat16()
        b = torch.from_numpy(rng.standard_normal((16 * steps, 64)).astype(
            np.float32)).bfloat16()
        c = torch.from_numpy(rng.standard_normal((64, 64)).astype(
            np.float32))
        want = c.double() + a.double() @ b.double()
        size = c.double().abs() + a.double().abs() @ b.double().abs()
    else:
        codes = rng.integers(0, 256, (2, 64, 32 * steps), dtype=np.uint8)
        if kind.startswith("e4m3"):
            codes[(codes & 0x7f) == 0x7f] = 0  # no NaN codes
            a, b = (torch.from_numpy(v).view(torch.float8_e4m3fn)
                    for v in codes)
            c = torch.from_numpy(rng.standard_normal((64, 64)).astype(
                np.float32))
            want = c.double() + a.double() @ b.double().t()
            size = c.double().abs() + a.double().abs() @ b.double().abs().t()
        else:
            a, b = (torch.from_numpy(v).view(torch.int8) for v in codes)
            c = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, (64, 64),
                                              dtype=np.int32))
            want = c.double() + a.double() @ b.double().t()
    d_mma, d_wg = torch.full_like(c, -1), torch.full_like(c, -1)
    rc = getattr(gemm.lib, f"tk8s_gemm_probe_{kind}")(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), d_mma.data_ptr(),
        d_wg.data_ptr(), steps, None)
    assert rc == 0
    # 8 steps of at most 32 f32 additions: 40 roundings a chain.
    bound = 40 * 2.0 ** -24 * (size if kind != "s8" else 0)
    for d in (d_mma, d_wg):
        assert bool(((d.double() - want).abs() <= bound).all())
    if kind != "e4m3_f16":
        assert torch.equal(d_mma, d_wg)
    assert getattr(gemm.lib, f"tk8s_gemm_probe_{kind}")(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), d_mma.data_ptr(),
        d_wg.data_ptr(), 9, None) != 0
