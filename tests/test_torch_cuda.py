"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (marker ``cuda``); anywhere
else they skip, decided inside the fixture at run time. They import
neither JAX nor the JAX package, so they run on the card's machine with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` because ``tests/conftest.py`` sets up JAX). They cover
what ``chip_smoke.py``'s Llama-3-8B shapes do not: other group sizes, head
dims, block sizes, f32 pools, a window that is not page aligned in its
last rows, quantized (int8/fp8) pools, the verify kernel's rows against the
decode kernel bit for bit, and the wrappers' refusals.
"""

import pytest
import torch

from triton_kubernetes_tpu_torch.ops import _kernels
from triton_kubernetes_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    try:
        _kernels.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def _tol(dtype):
    # bf16: one output ulp apart at most (f32 summation order differs);
    # f32: summation order only.
    return (dict(atol=1e-2, rtol=2 ** -7) if dtype == torch.bfloat16
            else dict(atol=1e-5, rtol=1e-5))


def _pool(gen, n, hkv, bs, d, dtype, device):
    pool = torch.randn((n, hkv, bs, d), generator=gen, device=device)
    pool[pa.TRASH_PAGE] = 1e4
    return pool.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,hkv,d,bs", [
    (32, 8, 128, 16), (8, 8, 64, 8), (16, 2, 128, 32), (12, 4, 96, 4),
])
def test_decode_kernel_matches_plain(device, dtype, hq, hkv, d, bs):
    gen = torch.Generator(device=device).manual_seed(hq + d + bs)
    t = 10
    lengths = [0, 1, bs, bs + 1, t * bs - 1, t * bs]
    b = len(lengths)
    n = 1 + b * t
    kp = _pool(gen, n, hkv, bs, d, dtype, device)
    vp = _pool(gen, n, hkv, bs, d, dtype, device)
    tables = (torch.randperm(b * t, device=device).reshape(b, t) + 1
              ).to(torch.int32)
    for i, length in enumerate(lengths):
        tables[i, pa.blocks_for(length, bs):] = pa.TRASH_PAGE
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    q = torch.randn((b, 1, hq, d), generator=gen, device=device).to(dtype)
    pa.reset_launch_counts()
    got = pa.ragged_paged_attention(q, kp, vp, tables, lens)  # None -> cuda
    assert pa.ragged_paged_attention.launches == 1
    want = pa.ragged_paged_attention(q, kp, vp, tables, lens, impl="dense")
    torch.cuda.synchronize()
    assert not got[0].any()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,offset,hq,hkv,d,bs", [
    (256, 1024, 32, 8, 128, 16),
    (64, 64, 8, 8, 64, 8),     # group 1
    (32, 96, 16, 2, 128, 32),  # group 8, rows spill into a second tile
    (24, 0, 12, 4, 96, 4),     # C*G = 72: a ragged last tile of rows
])
def test_prefill_kernel_matches_plain(device, dtype, c, offset, hq, hkv, d,
                                      bs):
    gen = torch.Generator(device=device).manual_seed(c + offset + d)
    t = (offset + c) // bs + 3
    kp = _pool(gen, 1 + t, hkv, bs, d, dtype, device)
    vp = _pool(gen, 1 + t, hkv, bs, d, dtype, device)
    table = (torch.randperm(t, device=device) + 1).to(torch.int32)
    q = torch.randn((1, c, hq, d), generator=gen, device=device).to(dtype)
    pa.reset_launch_counts()
    got = pa.paged_prefill_attention(q, kp, vp, table, offset)
    assert pa.paged_prefill_attention.launches == 1
    want = pa.paged_prefill_attention(q, kp, vp, table, offset,
                                      impl="dense")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    q = torch.zeros((2, 1, 8, 64), dtype=torch.bfloat16, device=device)
    kp = torch.zeros((4, 2, 16, 64), dtype=torch.bfloat16, device=device)
    tables = torch.zeros((2, 2), dtype=torch.int32, device=device)
    lens = torch.ones(2, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="dtype"):
        pa.ragged_paged_attention(q.half(), kp.half(), kp.half(), tables,
                                  lens)
    with pytest.raises(ValueError, match="int32"):
        pa.ragged_paged_attention(q, kp, kp, tables.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        pa.ragged_paged_attention(q, kp.transpose(2, 3).contiguous()
                                  .transpose(2, 3), kp, tables, lens)
    with pytest.raises(ValueError, match="outside the table"):
        pa.paged_prefill_attention(q[:1].expand(1, 40, 8, 64).contiguous(),
                                   kp, kp, tables[0], 0)


# ---- speculative verify (csrc/paged_verify.cu) and quantized pools ----

QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _quant_pool(gen, n, hkv, bs, d, kind, device):
    """8-bit pages and scales, the anchored quantization of unit normals
    (the trash page poisoned before quantizing)."""
    from triton_kubernetes_tpu_torch.ops import quantization as qz
    exact = torch.randn((n, hkv, bs, d), generator=gen, device=device)
    exact[pa.TRASH_PAGE] = 1e4
    return qz.quantize_kv_pages(exact, QUANT[kind])


def _paged_case(gen, device, dtype, kind, lengths, hq, hkv, d, bs, t, s=1):
    b = len(lengths)
    n = 1 + b * t
    if kind is None:
        kp, vp = (_pool(gen, n, hkv, bs, d, dtype, device) for _ in range(2))
        ks = vs = None
    else:
        kp, ks = _quant_pool(gen, n, hkv, bs, d, kind, device)
        vp, vs = _quant_pool(gen, n, hkv, bs, d, kind, device)
    tables = (torch.randperm(b * t, device=device).reshape(b, t) + 1
              ).to(torch.int32)
    for i, length in enumerate(lengths):
        tables[i, pa.blocks_for(length + s - 1, bs):] = pa.TRASH_PAGE
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    q = torch.randn((b, s, hq, d), generator=gen, device=device).to(dtype)
    return q, kp, vp, ks, vs, tables, lens


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,hq,hkv,d,bs", [
    (4, 32, 8, 128, 16),  # spec_k 3 at Llama-3-8B heads: 16 rows
    (8, 32, 8, 128, 16),  # spec_k 7: 32 rows, the most a block takes
    (3, 8, 8, 64, 8),     # group 1
    (2, 12, 4, 96, 32),   # group 3, bs 32
])
def test_verify_kernel_rows_equal_decode_kernel(device, kind, dtype, s, hq,
                                                hkv, d, bs):
    """Row j of the verify kernel is the decode kernel at length len + j,
    bit for bit, on unquantized and quantized pools; and both agree with
    their plain versions."""
    if kind is not None and d % 16:
        pytest.skip("8-bit pages need head_dim % 16 == 0")
    gen = torch.Generator(device=device).manual_seed(s + hq + d)
    t = 10
    lengths = [0, 1, bs - 1, bs, t * bs - s, t * bs - s + 1]
    q, kp, vp, ks, vs, tables, lens = _paged_case(
        gen, device, dtype, kind, lengths, hq, hkv, d, bs, t, s)
    pa.reset_launch_counts()
    got = pa.ragged_verify_attention(q, kp, vp, tables, lens, ks, vs)
    assert pa.ragged_verify_attention.launches == 1
    want = pa.ragged_verify_attention(q, kp, vp, tables, lens, ks, vs,
                                      impl="dense")
    for j in range(s):
        row = pa.ragged_paged_attention(q[:, j:j + 1].contiguous(), kp, vp,
                                        tables, lens + j, ks, vs)
        assert torch.equal(got[:, j:j + 1], row), f"row {j}"
    torch.cuda.synchronize()
    assert not got[0, 0].any()  # length 0: no key at all
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantized_decode_and_prefill_kernels_match_plain(device, kind,
                                                          dtype):
    gen = torch.Generator(device=device).manual_seed(7)
    hq, hkv, d, bs, t = 32, 8, 128, 16, 10
    q, kp, vp, ks, vs, tables, lens = _paged_case(
        gen, device, dtype, kind, [0, 1, 16, 17, 159, 160], hq, hkv, d, bs,
        t)
    got = pa.ragged_paged_attention(q, kp, vp, tables, lens, ks, vs)
    want = pa.ragged_paged_attention(q, kp, vp, tables, lens, ks, vs,
                                     impl="dense")
    torch.cuda.synchronize()
    assert not got[0].any()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    for c, offset in ((64, 64), (24, 0)):
        qp = torch.randn((1, c, hq, d), generator=gen, device=device
                         ).to(dtype)
        got = pa.paged_prefill_attention(qp, kp, vp, tables[-1], offset,
                                         ks, vs)
        want = pa.paged_prefill_attention(qp, kp, vp, tables[-1], offset,
                                          ks, vs, impl="dense")
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_verify_and_quantized_bindings_refuse(device):
    q = torch.zeros((2, 9, 32, 128), dtype=torch.bfloat16, device=device)
    kp = torch.zeros((4, 8, 16, 128), dtype=torch.bfloat16, device=device)
    tables = torch.zeros((2, 2), dtype=torch.int32, device=device)
    lens = torch.ones(2, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="S \\* group <= 32"):
        _kernels.paged_verify(q, kp, kp, tables, lens)  # 9 x 4 = 36 rows
    q1, q4 = q[:, :1].contiguous(), q[:, :4].contiguous()
    k8 = kp.to(torch.int8)
    with pytest.raises(ValueError, match="need their scales"):
        _kernels.paged_decode(q1, k8, k8, tables, lens)
    sc = torch.ones((4, 8), device=device)
    with pytest.raises(ValueError, match="int8 or float8"):
        _kernels.paged_decode(q1, kp, kp, tables, lens, sc, sc)
    with pytest.raises(ValueError, match="float32"):
        _kernels.paged_decode(q1, k8, k8, tables, lens, sc.double(),
                              sc.double())
    with pytest.raises(ValueError, match="both"):
        _kernels.paged_verify(q4, k8, k8, tables, lens, sc, None)


# ---- flash attention: kernels 1-3 (csrc/flash_*.cu) ----

def _flash_inputs(gen, b, s, hq, hkv, d, dtype, device):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    return rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), \
        rnd(b, s, hq, d)


# bf16 at D 64 and 128 runs the tensor-core design of flash_fwd and
# flash_bwd_dkv (key tiles of 128, query tiles of 128 and 64), f32 and
# bf16 at other widths the CUDA-core design (tiles of 64): the cases
# below cover both on either side of their tile boundaries.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (2, 128, 4, 4, 64),    # MHA, whole tiles
    (1, 200, 8, 2, 128),   # group 4, a ragged last tile
    (2, 77, 6, 2, 32),     # group 3, one ragged tile pair
    (1, 1000, 32, 8, 128),  # Llama-3-8B heads, S = 1,000
    (4, 2048, 32, 8, 128),  # the training shape
    (2, 5, 8, 2, 128),     # S below one tile
    (1, 129, 8, 2, 128),   # one past a 128 boundary
    (1, 65, 4, 2, 64),     # one past a 64 boundary
    (1, 300, 4, 4, 128),   # group 1 at D 128
    (1, 300, 6, 2, 96),    # bf16 at a width only the CUDA cores take
])
def test_flash_kernels_match_plain(device, dtype, b, s, hq, hkv, d):
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(s + hq + d)
    q, k, v, do = _flash_inputs(gen, b, s, hq, hkv, d, dtype, device)
    out, lse = _kernels.flash_fwd(q, k, v)
    want_out, want_lse = fa._flash_forward_plain(
        q, k, v, fa.kernel_block_k(dtype, d))
    dvec = fa._row_dot(do, out)
    dq = _kernels.flash_bwd_dq(q, k, v, do, lse, dvec)
    dk, dv = _kernels.flash_bwd_dkv(q, k, v, do, lse, dvec)
    want = fa._flash_backward_plain(q, k, v, do, lse, dvec)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), want_out.float(), **tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    for got, exp in zip((dq, dk, dv), want):
        torch.testing.assert_close(got.float(), exp.float(), **tol)


@pytest.mark.parametrize("dtype,d,name", [
    (torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 96, "cuda_core"), (torch.float32, 128, "cuda_core"),
])
def test_flash_variant_reaches_the_c_entry(device, monkeypatch, dtype, d,
                                           name):
    """The wrappers hand the C entries the code of the design the table
    names, and the entries refuse a design they are not built for."""
    gen = torch.Generator(device=device).manual_seed(d)
    q, k, v, do = _flash_inputs(gen, 1, 70, 4, 2, d, dtype, device)
    seen = []
    real = _kernels._entry

    def spy(kernel, dt):
        fn = real(kernel, dt)

        def call(*args):
            seen.append((kernel, args[-2]))
            return fn(*args)
        return call

    monkeypatch.setattr(_kernels, "_entry", spy)
    out, lse = _kernels.flash_fwd(q, k, v)
    _kernels.flash_bwd_dkv(q, k, v, do, lse, torch.zeros_like(lse))
    torch.cuda.synchronize()
    code = _kernels.FLASH_VARIANTS[name].code
    assert _kernels.flash_variant(dtype, d) == name
    assert seen == [("flash_fwd", code), ("flash_bwd_dkv", code)]
    if name == "cuda_core":  # no tensor-core kernel for these: refused
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), 1, 70, 4, 2, d, *_kernels._strides(q, k, v),
                d ** -0.5, 1,
                torch.cuda.current_stream(q.device).cuda_stream]
        assert real("flash_fwd", dtype)(*args) != 0


def test_flash_attention_counts_launches_and_takes_strided_views(device):
    """The autograd Function launches each kernel once per call on CUDA
    tensors, reading q/k/v through their strides (views of one fused
    projection here), and agrees with the plain versions' gradients."""
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(5)
    qkv = torch.randn((2, 96, 12, 64), generator=gen, device=device
                      ).to(torch.bfloat16)
    leaves = []
    for plain in (False, True):
        x = qkv.clone().requires_grad_(True)
        q, k, v = x[:, :, :8], x[:, :, 8:10], x[:, :, 10:]
        fa.reset_launch_counts()
        out = (fa.flash_attention_plain(q, k, v) if plain
               else fa.flash_attention(q, k, v))
        out.float().square().sum().backward()
        leaves.append((out.detach(), x.grad))
        want = ({"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
                if plain else
                {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1})
        assert fa.flash_attention.launches == want
    torch.cuda.synchronize()
    for got, exp in zip(*leaves):
        torch.testing.assert_close(got.float(), exp.float(), atol=2e-2,
                                   rtol=2 ** -6)


def test_flash_refuses_and_never_falls_back(device, monkeypatch):
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa

    q = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16, device=device)
    k = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="head_dim"):
        _kernels.flash_fwd(torch.zeros((1, 64, 4, 256), device=device,
                                       dtype=torch.bfloat16),
                           torch.zeros((1, 64, 2, 256), device=device,
                                       dtype=torch.bfloat16),
                           torch.zeros((1, 64, 2, 256), device=device,
                                       dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiple"):
        _kernels.flash_fwd(q, torch.zeros((1, 64, 3, 64), device=device,
                                          dtype=torch.bfloat16),
                           torch.zeros((1, 64, 3, 64), device=device,
                                       dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        _kernels.flash_fwd(q.half(), k.half(), k.half())

    # A launch that fails raises from the autograd Function: no plain
    # version runs in its place.
    def refuse(*args):
        return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(_kernels, "_entry", lambda name, dtype: refuse)
    fa.reset_launch_counts()
    with pytest.raises(RuntimeError, match="flash_fwd kernel launch failed"):
        fa.flash_attention(q, k, k)
    assert fa.flash_attention.launches["flash_fwd"] == 0


def test_flash_takes_any_stride_on_size_one_dims(device):
    """Autograd hands the backward a contiguous dO whose size-1 batch dim
    may carry stride 1; the binding ignores strides of size-1 dims."""
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(9)
    q, k, v, do = _flash_inputs(gen, 1, 130, 8, 2, 64, torch.bfloat16,
                                device)
    do1 = do.as_strided(do.shape, (1,) + do.stride()[1:])
    out, lse = _kernels.flash_fwd(q, k, v)
    dvec = fa._row_dot(do1, out)
    dq = _kernels.flash_bwd_dq(q, k, v, do1, lse, dvec)
    want = fa._flash_backward_plain(q, k, v, do, lse, dvec)[0]
    torch.cuda.synchronize()
    torch.testing.assert_close(dq.float(), want.float(),
                               **_tol(torch.bfloat16))
