"""The fused SwiGLU of w2's quantized input (``swiglu_quant`` in
``csrc/quantize_rows.cu``, ``ops.quantization.swiglu_quantize_rows``), on
the CPU.

Under W8A8 the serving steps form w2's input in one launch: from gate (the
w3 product) and up (the w1 product) it computes ``T(T(silu(gate)) * up)``
and quantizes each row, where the steps composed torch's SiLU, its casts
and its multiply with a standalone quantizer before. Its plain version
(``swiglu_quantize_rows_plain``, which CPU tensors run) must give the JAX
package's bytes and scales: ``silu(gate.astype(f32)).astype(bf16) * up``
(``triton_kubernetes_tpu/models/llama.py:298-302``), then the activation
quantizer of ``quantized_einsum``.

The CUDA source is built with g++ against ``scripts/cuda_emu/emu.h`` and
its entries driven as ``_kernels.swiglu_quant`` drives them. g++'s
``expf`` (glibc's) need not give the card's bits, so the emulated entry is
held to the emulated composition -- its own SiLU as the SiLU probe entry
gives it (equal to ``x / (1 + expf(-x))`` with glibc's ``expf`` on every
bf16 input), then torch's multiply and the emulated standalone quantizer --
bitwise, at F 5120, 14,336 (the most a thread holds in registers) and a
width past it. Its agreement with torch's SiLU is asserted only on the
card (``chip_smoke.py``'s SiLU probe). The emulation skips only where
there is no g++.
"""

import ctypes
import ctypes.util
import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.ops import quantization as jq
from triton_kubernetes_tpu_torch.ops import _kernels
from triton_kubernetes_tpu_torch.ops import quantization as qz

EMU = (Path(__file__).resolve().parents[1] / "scripts" / "cuda_emu"
       / "emulate_paged.py")
QDTYPES = {"int8": (jnp.int8, torch.int8),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                                 ids=["bf16", "f32"])


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _gate_up(seed, m, f, dtype):
    """Seeded gate and up [m, f] of ``dtype``: gate over the SiLU's whole
    range (deep negatives, where exp overflows, included), up unit
    normal."""
    rng = np.random.default_rng(seed)
    gate = rng.standard_normal((m, f)) * 4
    gate[0, :8] = [-120.0, -90.0, -20.0, -0.0, 0.0, 1e-30, 20.0, 90.0]
    up = rng.standard_normal((m, f))
    return [torch.from_numpy(a.astype(np.float32)).to(dtype)
            for a in (gate, up)]


@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_plain_version_is_the_reference(qname):
    """bf16 gate and up: the plain version's bytes and scales are the JAX
    package's SwiGLU in bf16 followed by its activation quantizer."""
    jdt, tdt = QDTYPES[qname]
    gate, up = _gate_up(1, 6, 96, torch.bfloat16)
    jgate, jup = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (gate, up))
    p = (jax.nn.silu(jgate.astype(jnp.float32)).astype(jnp.bfloat16)
         * jup).astype(jnp.float32)
    amax = jnp.max(jnp.abs(p), axis=-1, keepdims=True)
    js = jnp.maximum(amax / jq.qmax_for(jdt), jq.MIN_SCALE)
    jxq = np.asarray(jq.quantize_with_scale(p, js, jdt))
    got = qz.swiglu_quantize_rows_plain(gate.reshape(2, 3, 96),
                                        up.reshape(2, 3, 96), tdt)
    assert got.lead == (2, 3) and got.dtype == tdt
    np.testing.assert_array_equal(
        jxq.view(np.uint8), _bytes(got.xq).numpy())
    np.testing.assert_array_equal(np.asarray(js)[:, 0], got.x_scale.numpy())


@DTYPES
def test_wrapper_runs_the_plain_version_on_cpu_tensors(dtype):
    """On CPU tensors: the plain version, which is torch's SiLU, cast and
    multiply followed by ``quantize_rows_plain``; no launch counted; the
    binding refuses CPU tensors."""
    gate, up = _gate_up(2, 4, 64, dtype)
    qz.reset_launch_counts()
    got = qz.swiglu_quantize_rows(gate, up, torch.int8)
    p = torch.nn.functional.silu(gate.float()).to(dtype) * up
    want_q, want_s = qz.quantize_rows_plain(p, torch.int8)
    assert torch.equal(got.xq, want_q) and torch.equal(got.x_scale, want_s)
    assert torch.equal(qz.swiglu(gate, up), p)
    assert qz.swiglu_quantize_rows.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.swiglu_quant(gate, up, torch.int8)


def test_w8a8_rows_takes_quantized_rows_as_they_come():
    """``w8a8_rows`` runs the product on quantized rows without
    quantizing again: the same outputs as on the rows they came from."""
    gate, up = _gate_up(3, 5, 32, torch.bfloat16)
    qs, scales = qz.quantize_channelwise(
        torch.from_numpy(np.random.default_rng(3).standard_normal(
            (32, 16)).astype(np.float32)), 0, torch.int8)
    w, s = qs.t().contiguous(), scales.reshape(-1)
    rows = qz.swiglu_quantize_rows(gate, up, torch.int8)
    qz.reset_launch_counts()
    got = qz.w8a8_rows(rows, [w], [s], torch.bfloat16)[0]
    want = qz.w8a8_rows(qz.swiglu(gate, up), [w], [s], torch.bfloat16)[0]
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="quantized to"):
        qz.w8a8_rows(rows, [w.view(torch.float8_e4m3fn)], [s],
                     torch.bfloat16)


# ------------------------------------------------------------ emulation
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


def _libm_silu(x: torch.Tensor) -> torch.Tensor:
    """x / (1 + expf(-x)) in f32 with glibc's expf, as the emulated kernel
    computes it (f32 in, f32 out)."""
    expf = ctypes.CDLL(ctypes.util.find_library("m")).expf
    expf.argtypes, expf.restype = [ctypes.c_float], ctypes.c_float
    v = x.float().numpy().reshape(-1)
    e = np.array([expf(-float(a)) for a in v], dtype=np.float32)
    with np.errstate(invalid="ignore"):  # NaN and infinite inputs
        return torch.from_numpy(v / (np.float32(1) + e)).reshape(x.shape)


def _emulated_silu(lib, x: torch.Tensor) -> torch.Tensor:
    """The SiLU probe entry on bf16 x: bf16(silu(x)) by the kernel's
    SiLU."""
    y = torch.full_like(x, float("nan"))
    assert lib.tk8s_silu_probe_bf16(x.data_ptr(), y.data_ptr(), x.numel(),
                                    None) == 0
    return y


def _quantize(lib, x, qdtype):
    xq = torch.full(x.shape, 0x55, dtype=torch.uint8).view(qdtype)
    xs = torch.full((x.shape[0],), float("nan"))
    fn = getattr(lib, f"tk8s_quantize_rows_{_kernels._SUFFIX[x.dtype]}_"
                      f"{_kernels._PAGE_SUFFIX[qdtype]}")
    assert fn(x.data_ptr(), xq.data_ptr(), xs.data_ptr(), x.shape[0],
              x.shape[1], None) == 0
    return xq, xs


def _swiglu_quant(lib, gate, up, qdtype, m=None, f=None):
    """(rc, xq, x_scale) of the emulated fused entry."""
    xq = torch.full(gate.shape, 0x55, dtype=torch.uint8).view(qdtype)
    xs = torch.full((gate.shape[0],), float("nan"))
    fn = getattr(lib, f"tk8s_swiglu_quant_{_kernels._SUFFIX[gate.dtype]}_"
                      f"{_kernels._PAGE_SUFFIX[qdtype]}")
    rc = fn(gate.data_ptr(), up.data_ptr(), xq.data_ptr(), xs.data_ptr(),
            gate.shape[0] if m is None else m,
            gate.shape[1] if f is None else f, None)
    return rc, xq, xs


def test_emulated_silu_probe_is_glibc_silu_on_every_bf16_input(lib):
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    got = _emulated_silu(lib, x)
    want = _libm_silu(x).to(torch.bfloat16)
    same = (got.view(torch.int16) == want.view(torch.int16)) | (
        got.isnan() & want.isnan())
    assert bool(same.all()), int((~same).sum())


@pytest.mark.parametrize("qname", sorted(QDTYPES))
@DTYPES
@pytest.mark.parametrize("m,f", [(3, 5120), (2, 14336), (2, 16392)])
def test_emulated_entry_is_the_emulated_composition(lib, qname, dtype, m, f):
    """The fused entry's bytes and scales bitwise the emulated SiLU
    (rounded to the dtype), torch's multiply and the emulated standalone
    quantizer, with its rows bitwise across M."""
    qdtype = QDTYPES[qname][1]
    gate, up = _gate_up(m + f, m, f, dtype)
    silu = (_emulated_silu(lib, gate) if dtype == torch.bfloat16
            else _libm_silu(gate))
    want_q, want_s = _quantize(lib, (silu * up).contiguous(), qdtype)
    rc, xq, xs = _swiglu_quant(lib, gate, up, qdtype)
    assert rc == 0
    assert torch.equal(_bytes(xq), _bytes(want_q))
    assert torch.equal(xs, want_s)
    rc, q1, s1 = _swiglu_quant(lib, gate[:1].contiguous(),
                               up[:1].contiguous(), qdtype)
    assert rc == 0 and torch.equal(_bytes(q1), _bytes(xq[:1]))
    assert torch.equal(s1, xs[:1])


@pytest.mark.parametrize("what,m,f", [("no row", 0, 64),
                                      ("F not a multiple of 8", 2, 60)])
def test_emulated_entry_refuses(lib, what, m, f):
    gate, up = _gate_up(5, 2, 64, torch.bfloat16)
    rc, _, xs = _swiglu_quant(lib, gate, up, torch.int8, m=m, f=f)
    assert rc != 0 and xs.isnan().all(), what
