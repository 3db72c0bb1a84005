"""The decode GEMM past 64 rows (``csrc/decode_gemm.cu``'s wgmma kernel
and its row tiles) and the wgmma bit probe, on the CPU, through the g++
emulation that ``test_torch_decode_gemm.py`` builds (its ``gemm`` fixture
and input helpers, imported here).

A prefill window's M (130 or 256) in one launch, its rows in row tiles of
64 side by side: each row tile bitwise a launch of its rows alone (bf16,
f32, int8, fp8). The wgmma kernel (two warpgroups of 64 rows fed through
a cp.async ring on mbarriers; the emulation reads wgmma's operands through
their descriptors and the 128-byte swizzle) at M 65, 100, 128 and 256,
bf16, int8 and fp8: every row within tolerance of the plain version and
bitwise the same row through launches of at most 64 rows (mma.sync),
ragged last one included; two block orders bitwise; and the bit probe's C
entries, whose two chains agree in the emulation. These tests sit in a
file of their own so that a run that gives each file one worker
(``--dist loadfile``) spreads the emulated GEMM over four workers.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_decode_gemm import (  # noqa: E402,F401
    _inputs, _w8a8_inputs, gemm)
from triton_kubernetes_tpu_torch.ops import decode_gemm as dg  # noqa: E402


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
