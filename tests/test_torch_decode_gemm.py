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
* the same bits whatever order the blocks run in, so the merge does not
  depend on which block arrives last; the arrival counters back at 0;
* the entries' refusals.

Rows at M 1-63 bitwise the rows at M 64 are held in
``test_torch_decode_gemm_rows.py``, the W8A8 entries
(``tk8s_decode_gemm_{s8,e4m3}_{bf16,f32}``) in
``test_torch_decode_gemm_w8a8.py``, the kernel past 64 rows (row tiles,
the wgmma kernel) and the bit probe in ``test_torch_decode_gemm_wgmma.py``:
each imports this file's ``gemm`` fixture and input helpers, and sits in
a file of its own so that a run giving each file one worker spreads the
emulated GEMM over four.

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
