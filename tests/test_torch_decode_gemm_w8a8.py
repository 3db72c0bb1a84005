"""The W8A8 entries of the row-invariant decode GEMM
(``tk8s_decode_gemm_{s8,e4m3}_{bf16,f32}`` in ``csrc/decode_gemm.cu``), on
the CPU, through the g++ emulation that ``test_torch_decode_gemm.py``
builds (its ``gemm`` fixture and input helpers, imported here).

An 8-bit activation quantized per row times a weight stored [N, K]
quantized per column; int8 on mma.sync m16n8k32 up to 64 rows, fp8 on the
wgmma kernel at every M. int8 rows bitwise their plain version (an exact
integer sum, merged in int32) at every M of 1-63 with K forced into 1-4
ranges, at both tile widths and in two block orders; fp8 within one bf16
ulp of its plain version, rows bitwise the rows at M 64; the entries'
refusals. These tests sit in a file of their own so that a run that gives
each file one worker (``--dist loadfile``) spreads the emulated GEMM over
four workers.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_decode_gemm import _w8a8_inputs, gemm  # noqa: E402,F401
from triton_kubernetes_tpu_torch.ops import _kernels  # noqa: E402
from triton_kubernetes_tpu_torch.ops import decode_gemm as dg  # noqa: E402


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
