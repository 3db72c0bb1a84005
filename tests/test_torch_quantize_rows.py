"""The per-token activation quantizer of the W8A8 products
(``csrc/quantize_rows.cu``, ``ops.quantization.quantize_rows``), on the
CPU.

The CUDA source is built here with g++ against the thread-level emulation
of ``scripts/cuda_emu/emu.h`` (blocks one at a time, 256 threads each,
real barriers and warp shuffles; fp8 conversion by a search of the e4m3
values, ties to even), as ``emulate_paged.py`` builds the paged kernels,
and its C entries are driven with the arguments ``_kernels.quantize_rows``
passes. Every step of the kernel is exact or one IEEE rounding, so its
bytes and scales must be ``torch.equal`` to the plain version
(``quantize_rows_plain``, torch's ops), which is itself bitwise the JAX
package's activation quantization (``tests/test_torch_w8a8.py``): int8 and
fp8, bf16 and f32 input, rows of zeros (the scale floor), rows whose
values land on rounding ties, widths that are not a multiple of the block,
the serving widths (K 4096, 5120, 14,336: the most a thread holds in
registers) and a width past them (chunks read again after the barrier).
The emulation skips only where there is no g++.
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from triton_kubernetes_tpu_torch.ops import _kernels
from triton_kubernetes_tpu_torch.ops import quantization as qz

EMU = (Path(__file__).resolve().parents[1] / "scripts" / "cuda_emu"
       / "emulate_paged.py")
QDTYPES = pytest.mark.parametrize("qdtype", [torch.int8, torch.float8_e4m3fn],
                                  ids=["int8", "fp8"])
DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                                 ids=["bf16", "f32"])


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """quantize_rows.cu built with g++ against emu.h."""
    if shutil.which("g++") is None:
        pytest.skip("the CUDA emulation builds with g++, which is missing")
    spec = importlib.util.spec_from_file_location("emulate_paged", EMU)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build(tmp_path_factory.mktemp("emu"),
                     ("quantize_rows",))["quantize_rows"]


def _run(lib, x, qdtype, m=None):
    """The C entry on x [M, K] as ``_kernels.quantize_rows`` calls it:
    (rc, xq, x_scale), the outputs NaN-poisoned first."""
    xq = torch.full(x.shape, 0x55, dtype=torch.uint8).view(qdtype)
    scale = torch.full((x.shape[0],), float("nan"))
    rc = getattr(lib, f"tk8s_quantize_rows_{_kernels._SUFFIX[x.dtype]}_"
                      f"{_kernels._PAGE_SUFFIX[qdtype]}")(
        x.data_ptr(), xq.data_ptr(), scale.data_ptr(),
        x.shape[0] if m is None else m, x.shape[1], None)
    return rc, xq, scale


def _rows(seed, m, k, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)) * np.exp(rng.uniform(-6, 6, (m, 1)))
    x[0] = 0.0  # the scale floor
    if m > 2:
        # Values at exact rounding ties of x / scale: amax 127 (scale 1),
        # halves in between.
        x[2, :] = np.arange(k) % 255 - 127 + 0.5
        x[2, 0] = 127.0
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@QDTYPES
@DTYPES
@pytest.mark.parametrize("m,k", [(1, 64), (7, 200), (33, 4096), (4, 5120),
                                 (3, 14336), (2, 16392)])
def test_emulated_quantize_rows_is_bitwise_the_plain_version(lib, qdtype,
                                                             dtype, m, k):
    x = _rows(m + k, m, k, dtype)
    rc, xq, scale = _run(lib, x, qdtype)
    assert rc == 0
    want_q, want_s = qz.quantize_rows_plain(x, qdtype)
    assert torch.equal(xq.view(torch.uint8), want_q.view(torch.uint8))
    assert torch.equal(scale, want_s)
    assert float(scale[0]) == pytest.approx(qz.MIN_SCALE)


@QDTYPES
def test_emulated_quantize_rows_rows_do_not_depend_on_m(lib, qdtype):
    x = _rows(9, 40, 520, torch.bfloat16)
    _, full_q, full_s = _run(lib, x, qdtype)
    for m in (1, 5, 17):
        _, q, s = _run(lib, x[:m].contiguous(), qdtype)
        assert torch.equal(q.view(torch.uint8), full_q[:m].view(torch.uint8))
        assert torch.equal(s, full_s[:m])


def test_emulated_quantize_rows_refuses_empty_rows(lib):
    x = _rows(1, 4, 64, torch.float32)
    assert _run(lib, x, torch.int8, m=0)[0] != 0
    assert _run(lib, x, torch.int8)[0] == 0


def test_emulated_quantize_rows_refuses_ragged_widths(lib):
    """K must be a multiple of 8: the kernel moves 16-byte chunks."""
    x = _rows(1, 2, 60, torch.bfloat16)
    rc, xq, scale = _run(lib, x, torch.int8)
    assert rc != 0 and scale.isnan().all()


def test_quantize_rows_wrapper_runs_the_plain_version_on_cpu_tensors():
    x = _rows(3, 6, 96, torch.bfloat16)
    qz.reset_launch_counts()
    got = qz.quantize_rows(x, torch.int8)
    want = qz.quantize_rows_plain(x, torch.int8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert qz.quantize_rows.launches == 0  # no kernel on the CPU
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.quantize_rows(x, torch.int8)
