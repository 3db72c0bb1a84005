"""The residual add fused with RMSNorm (``ops/norms.py``,
``csrc/rms_norm.cu``), on the CPU.

``add_rms_norm_rows`` runs a serving step's layer boundary: h = x + delta
and the norm of h, one kernel launch on the card. On CPU tensors it runs
its plain version, which must be bitwise torch's add followed by the plain
norm (what the steps composed before the fusion) and agree with the JAX
package's add and ``rms_norm`` on the same seeded numpy inputs.

The CUDA source is built here with g++ against the thread-level emulation
of ``scripts/cuda_emu/emu.h`` (blocks one at a time, 256 threads each,
real barriers and warp shuffles), as ``emulate_paged.py`` builds the paged
kernels, and its C entries are driven with the arguments
``_kernels.add_rms_norm`` and ``_kernels.rms_norm`` pass. That checks what
the card cannot be asked here, at D 4096, 5120 (not a multiple of the
2048 elements a pass of the block covers), 8192 (the most a thread keeps
in registers) and 8704 (past it: h read back):

* the fused entry's h bitwise torch's ``x + delta`` and its y bitwise the
  delta-null entry on that h;
* rows at M 1, 8, 32 and 256 bitwise the rows at M 64;
* y within one bf16 ulp of the plain version (f32: 1e-6 relative; the
  sum is taken in another order, and the emulated rsqrtf rounds twice);
* the entries' refusals;
* the quantizing entries (kernel A as the epilogue, for a W8A8 product):
  bytes and scales bitwise the emulated quantizer (``quantize_rows.cu``)
  on the y the norm entries write, h bitwise the fused entry's, at M 1, 8
  and 32 (and a prefill window's 256 at D 4096), int8 and fp8; and on CPU
  tensors ``rms_norm_quant_rows`` / ``add_rms_norm_quant_rows`` bitwise
  the plain norm followed by ``quantize_rows_plain``.

The emulation skips only where there is no g++.
"""

import importlib.util
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.ops import norms as jnorms
from triton_kubernetes_tpu_torch.ops import _kernels, norms
from triton_kubernetes_tpu_torch.ops import quantization as qz

EMU = (Path(__file__).resolve().parents[1] / "scripts" / "cuda_emu"
       / "emulate_paged.py")
DTYPES = [torch.bfloat16, torch.float32]
EPS = 1e-5
ROWS = (1, 8, 32, 64, 256)
WIDTHS = (4096, 5120, 8192, 8704)


def _inputs(seed, m, d, dtype):
    """x, delta [m, d] and scale [d] from a seeded numpy generator, as f32
    numpy arrays and as tensors of ``dtype`` holding their values."""
    rng = np.random.default_rng(seed)
    arrays = [3 * rng.standard_normal((m, d)), rng.standard_normal((m, d)),
              1 + 0.1 * rng.standard_normal(d)]
    tensors = [torch.from_numpy(a.astype(np.float32)).to(dtype)
               for a in arrays]
    return [t.float().numpy() for t in tensors], tensors


@pytest.mark.parametrize("dtype", DTYPES)
def test_add_rms_norm_rows_plain_is_add_then_rms_norm(dtype):
    _, (x, delta, scale) = _inputs(1, 12, 64, dtype)
    h, y = norms.add_rms_norm_rows(x.reshape(3, 4, 64),
                                   delta.reshape(3, 4, 64), scale, EPS)
    want = x + delta
    assert h.dtype == y.dtype == dtype
    assert torch.equal(h, want.reshape(3, 4, 64))
    assert torch.equal(y, norms.rms_norm(want, scale, EPS).reshape(3, 4, 64))
    assert torch.equal(y, norms.rms_norm_rows(h, scale, EPS))
    assert norms.add_rms_norm_rows.launches == 0  # no kernel on the CPU


@pytest.mark.parametrize("dtype", DTYPES)
def test_add_rms_norm_matches_jax(dtype):
    """Against the JAX package's ``x + delta`` and ``rms_norm`` in the same
    dtype: bf16 within one output ulp (1e-2 + 2^-7 |ref|: the f32 sum is
    taken in another order); f32 within 1e-6 relative (f32 rounding)."""
    (xn, dn, sn), (x, delta, scale) = _inputs(2, 6, 96, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jh = jnp.asarray(xn).astype(jdt) + jnp.asarray(dn).astype(jdt)
    jy = jnorms.rms_norm(jh, jnp.asarray(sn).astype(jdt), EPS)
    h, y = norms.add_rms_norm_rows(x, delta, scale, EPS)
    np.testing.assert_array_equal(h.float().numpy(),
                                  np.asarray(jh).astype(np.float32))
    tol = (dict(rtol=2 ** -7, atol=1e-2) if dtype == torch.bfloat16
           else dict(rtol=1e-6, atol=0))
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy).astype(np.float32), **tol)


QDTYPES = pytest.mark.parametrize("qdtype",
                                  [torch.int8, torch.float8_e4m3fn],
                                  ids=["int8", "fp8"])


def _bitwise(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@QDTYPES
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantizing_norm_rows_plain_is_the_norm_then_the_quantizer(dtype,
                                                                   qdtype):
    _, (x, delta, scale) = _inputs(7, 12, 64, dtype)
    x3, d3 = x.reshape(3, 4, 64), delta.reshape(3, 4, 64)
    norms.reset_launch_counts()
    got = norms.rms_norm_quant_rows(x3, scale, EPS, qdtype)
    want_q, want_s = qz.quantize_rows_plain(norms.rms_norm(x, scale, EPS),
                                            qdtype)
    assert got.lead == (3, 4) and got.dtype == qdtype
    assert _bitwise(got.xq, want_q) and torch.equal(got.x_scale, want_s)
    h, got = norms.add_rms_norm_quant_rows(x3, d3, scale, EPS, qdtype)
    want_h, y = norms.add_rms_norm(x, delta, scale, EPS)
    want_q, want_s = qz.quantize_rows_plain(y, qdtype)
    assert torch.equal(h, want_h.reshape(3, 4, 64)) and got.lead == (3, 4)
    assert _bitwise(got.xq, want_q) and torch.equal(got.x_scale, want_s)
    assert norms.rms_norm_quant_rows.launches == 0  # no kernel on the CPU
    assert norms.add_rms_norm_quant_rows.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.add_rms_norm_quant(x, None, scale, EPS, qdtype)


def test_add_rms_norm_wrapper_refuses_cpu_tensors():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.add_rms_norm(x, x, torch.ones(8), EPS)


def test_fused_entries_are_built_and_bound():
    """The fused C entries live in ``rms_norm.cu`` beside the delta-null
    ones, one per dtype, and are bound with their own argument types."""
    text = (_kernels.CSRC / "rms_norm.cu").read_text()
    sig = _kernels._MORE_ENTRIES["rms_norm"]["add_rms_norm"]
    assert len(sig) == 9 and sig[-4:] == (_kernels._I, _kernels._I,
                                          _kernels._F, _kernels._P)
    for suffix in _kernels._entry_suffixes("rms_norm"):
        assert f"tk8s_add_rms_norm_{suffix}(" in text
        assert f"tk8s_rms_norm_{suffix}(" in text


# ------------------------------------------------------------ emulation
class EmulatedNorm:
    """The emulated C entries, called as the wrappers call the real ones;
    outputs NaN-poisoned."""

    def __init__(self, lib, quant):
        self.lib, self.quant = lib, quant

    def add(self, x, delta, scale, m=None, d=None):
        """(rc, h, y) of the fused entry; ``m``/``d`` override what is
        passed."""
        h = torch.full_like(x, float("nan"))
        y = torch.full_like(x, float("nan"))
        suffix = _kernels._SUFFIX[x.dtype]
        fn = getattr(self.lib, f"tk8s_add_rms_norm_{suffix}")
        rc = fn(x.data_ptr(), None if delta is None else delta.data_ptr(),
                scale.data_ptr(), h.data_ptr(), y.data_ptr(),
                x.shape[0] if m is None else m,
                x.shape[1] if d is None else d, EPS, None)
        return rc, h, y

    def norm(self, x, scale, m=None, d=None):
        """(rc, y) of the delta-null entry."""
        y = torch.full_like(x, float("nan"))
        fn = getattr(self.lib, f"tk8s_rms_norm_{_kernels._SUFFIX[x.dtype]}")
        rc = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                x.shape[0] if m is None else m,
                x.shape[1] if d is None else d, EPS, None)
        return rc, y

    def add_quant(self, x, delta, scale, qdtype):
        """(rc, h, xq, x_scale) of the quantizing entry (delta None: the
        delta-null norm, h not written)."""
        h = torch.full_like(x, float("nan"))
        xq = torch.full(x.shape, 0x55, dtype=torch.uint8).view(qdtype)
        xs = torch.full((x.shape[0],), float("nan"))
        fn = getattr(self.lib, f"tk8s_add_rms_norm_quant_"
                               f"{_kernels._SUFFIX[x.dtype]}_"
                               f"{_kernels._PAGE_SUFFIX[qdtype]}")
        rc = fn(x.data_ptr(), None if delta is None else delta.data_ptr(),
                scale.data_ptr(), None if delta is None else h.data_ptr(),
                xq.data_ptr(), xs.data_ptr(), x.shape[0], x.shape[1], EPS,
                None)
        return rc, h, xq, xs

    def quantize(self, x, qdtype):
        """(xq, x_scale) of the emulated standalone quantizer."""
        xq = torch.full(x.shape, 0x55, dtype=torch.uint8).view(qdtype)
        xs = torch.full((x.shape[0],), float("nan"))
        fn = getattr(self.quant, f"tk8s_quantize_rows_"
                                 f"{_kernels._SUFFIX[x.dtype]}_"
                                 f"{_kernels._PAGE_SUFFIX[qdtype]}")
        assert fn(x.data_ptr(), xq.data_ptr(), xs.data_ptr(), x.shape[0],
                  x.shape[1], None) == 0
        return xq, xs


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """rms_norm.cu (and quantize_rows.cu, the quantizer its quantizing
    entries are held to) built with g++ against emu.h."""
    if shutil.which("g++") is None:
        pytest.skip("the CUDA emulation builds with g++, which is missing")
    spec = importlib.util.spec_from_file_location("emulate_paged", EMU)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.build(tmp_path_factory.mktemp("emu"),
                    ("rms_norm", "quantize_rows"))
    return EmulatedNorm(lib["rms_norm"], lib["quantize_rows"])


_runs = {}


def _run(emu, dtype, d):
    """The fused entry at every M of ROWS on the first M rows of one set
    of inputs, and the delta-null entry on torch's x + delta at M 64:
    (inputs, {M: (h, y)}, delta-null y), made once per (dtype, D)."""
    key = (dtype, d)
    if key not in _runs:
        _, (x, delta, scale) = _inputs(d, max(ROWS), d, dtype)
        out = {}
        for m in ROWS:
            rc, h, y = emu.add(x[:m], delta[:m], scale)
            assert rc == 0, f"the fused entry refused M {m}, D {d} ({rc})"
            out[m] = (h, y)
        rc, y_null = emu.norm((x[:64] + delta[:64]).contiguous(), scale)
        assert rc == 0
        _runs[key] = ((x, delta, scale), out, y_null)
    return _runs[key]


CASES = pytest.mark.parametrize(
    "dtype,d", [(torch.bfloat16, d) for d in WIDTHS]
    + [(torch.float32, 4096)], ids=lambda v: str(v).removeprefix("torch."))


@CASES
def test_emulated_fused_entry_is_add_then_the_norm_entry(emu, dtype, d):
    """h is bitwise torch's x + delta (an f32 add rounded once), and y is
    bitwise the delta-null entry on that h."""
    (x, delta, _), out, y_null = _run(emu, dtype, d)
    for m, (h, _) in out.items():
        assert torch.equal(h, x[:m] + delta[:m]), m
    assert torch.equal(out[64][1], y_null)


@CASES
def test_emulated_rows_do_not_depend_on_m(emu, dtype, d):
    _, out, _ = _run(emu, dtype, d)
    h64, y64 = out[64]
    for m in (1, 8, 32):
        assert torch.equal(out[m][1], y64[:m]), m
        assert torch.equal(out[m][0], h64[:m]), m
    assert torch.equal(out[256][1][:64], y64)


def _ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value of t (8 significant bits)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32),
                       (e - 8).float())


@CASES
def test_emulated_norm_within_one_ulp_of_plain(emu, dtype, d):
    (x, delta, scale), out, _ = _run(emu, dtype, d)
    _, want = norms.add_rms_norm(x, delta, scale, EPS)
    got = out[256][1]
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        assert (err <= _ulp(want)).all(), float(err.max())
    else:
        assert (err <= 1e-6 * want.abs()).all(), float(err.max())


@QDTYPES
@CASES
def test_emulated_quantizing_entries_are_the_norm_then_the_quantizer(
        emu, dtype, d, qdtype):
    """xq and x_scale bitwise the emulated quantizer on the y that the
    fused entry (and the delta-null entry on torch's x + delta) writes, h
    bitwise the fused entry's, at M 1, 8 and 32 -- and a prefill window's
    256 for bf16 int8 at D 4096 -- with rows bitwise across M."""
    (x, delta, scale), out, y_null = _run(emu, dtype, d)
    want = emu.quantize(out[32][1], qdtype)
    want_null = emu.quantize(y_null[:32].contiguous(), qdtype)
    h64 = (x[:64] + delta[:64]).contiguous()
    rows = (1, 8, 32) + ((256,) if (dtype, d, qdtype) == (
        torch.bfloat16, 4096, torch.int8) else ())
    for m in rows:
        rc, h, xq, xs = emu.add_quant(x[:m], delta[:m], scale, qdtype)
        assert rc == 0 and torch.equal(h, out[m][0]), m
        wq, ws = (want if m <= 32 else emu.quantize(out[m][1], qdtype))
        k = min(m, 32)
        assert _bitwise(xq[:k], wq[:k]) and torch.equal(xs[:k], ws[:k]), m
        if m > 32:
            assert _bitwise(xq, wq) and torch.equal(xs, ws)
        if m > 32:
            continue
        rc, h, xq, xs = emu.add_quant(h64[:m], None, scale, qdtype)
        assert rc == 0 and h.isnan().all(), m  # h is not written
        assert _bitwise(xq, want_null[0][:m]), m
        assert torch.equal(xs, want_null[1][:m]), m


@pytest.mark.parametrize("what,m,d", [("no row", 0, 64),
                                      ("negative rows", -1, 64),
                                      ("D not a multiple of 8", 2, 60),
                                      ("D under 8", 2, 4)])
def test_emulated_entries_refuse(emu, what, m, d):
    _, (x, delta, scale) = _inputs(5, 2, 64, torch.bfloat16)
    rc, h, y = emu.add(x, delta, scale, m=m, d=d)
    assert rc != 0 and h.isnan().all() and y.isnan().all(), what
    rc, y = emu.norm(x, scale, m=m, d=d)
    assert rc != 0 and y.isnan().all(), what
