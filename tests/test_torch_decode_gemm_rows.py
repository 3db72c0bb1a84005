"""Rows of the row-invariant decode GEMM (``csrc/decode_gemm.cu``, the
bf16 and f32 entries) on the CPU, through the g++ emulation that
``test_torch_decode_gemm.py`` builds (its ``gemm`` fixture, ``DTYPES``,
``TILES`` and input helpers, imported here): rows at M 1, 3, 8, 17, 33
and 63 (one, two and four 16-row tiles) bitwise the rows at M 64, all
three row-tile variants, both tile widths, K split in three -- what keeps
a verify row the decode row. In a file of its own so that a run giving
each file one worker (``--dist loadfile``) spreads the emulated GEMM over
four workers.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_decode_gemm import (  # noqa: E402,F401
    DTYPES, TILES, _inputs, gemm)


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
