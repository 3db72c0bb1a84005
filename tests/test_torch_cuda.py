"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (marker ``cuda``); anywhere
else they skip, decided inside the fixture at run time. They import
neither JAX nor the JAX package, so they run on the card's machine with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` because ``tests/conftest.py`` sets up JAX). They cover
what ``chip_smoke.py``'s Llama-3-8B shapes do not: other group sizes, head
dims, block sizes, f32 pools, a window that is not page aligned in its
last rows, quantized (int8/fp8) pools, the verify kernel's rows against the
decode kernel bit for bit, the decode and verify span walk at lengths on
either side of its span edges and the table that picks it, the prefill
kernel's tensor-core design (page kinds, widths, block sizes, groups,
windows around its 64-key stages, rows bitwise the same in any window,
the design the table sends to the C entry), the dQ
kernel's tensor-core design at ragged
sequences, the row-invariant decode GEMM (one launch for each 8B group,
K split by the shape: rows at every M of 1-63 bitwise, twenty launches
bitwise, grouped refusals) and RMSNorm (rows at M 1 and 8 bitwise) with
its fused residual add (h bitwise torch's add, y the norm kernel's of h,
rows at M 1-256 bitwise, D past the 8192 a thread keeps), a small model's
verify logits rows against
its decode rows, and the wrappers' refusals; and the W8A8 kernels --
the per-token quantizer (bytes and scales ``torch.equal`` to its plain
version), standalone, as the norm's epilogue and fused with the SwiGLU
(whose SiLU gives torch's bits on every bf16 input), and the int8/fp8
GEMM entries (int8 ``torch.equal`` to its plain
version at every M of 1-64, fp8 within one bf16 ulp, rows bitwise, K
split by the shape), ``quantized_einsum`` on CUDA tensors, a small W8A8
model's verify rows against its decode rows and its spec-on tokens against
spec-off, and a prefill window's full pages the same under two window
widths (fault F2), bf16 and W8A8 int8; and KV-session migration between
two small engines on the card (handoff and drain keep the tokens, a torn
payload leaves the destination's pool unchanged), two engines stepping
on two threads of one process (each request keeps its tokens), and the
serving MoE layer (rows bitwise across row counts, within one bf16 ulp
of ``moe_layer``).
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


# ---- the span walk: decode and verify on the tensor cores ----

SPAN_LENGTHS = [0, 1, 255, 256, 257, 511, 512, 513, 2047, 2048]


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
@pytest.mark.parametrize("d,bs", [(128, 16), (64, 32), (128, 32), (64, 16)])
def test_span_decode_matches_plain_at_span_edges(device, kind, d, bs):
    """bf16 queries at D 64/128, bs 16/32 run the span walk: within one
    bf16 ulp of the span plain version at lengths on either side of the
    span edges, one launch a call, and a second call gives the same bits
    (the arrival counters were set back to 0)."""
    assert _kernels.paged_variant(
        torch.bfloat16, torch.bfloat16 if kind is None else QUANT[kind], bs,
        d) == "tensor_core"
    gen = torch.Generator(device=device).manual_seed(d + bs)
    t = 2048 // bs
    q, kp, vp, ks, vs, tables, lens = _paged_case(
        gen, device, torch.bfloat16, kind, SPAN_LENGTHS, 32, 8, d, bs, t)
    pa.reset_launch_counts()
    got = pa.ragged_paged_attention(q, kp, vp, tables, lens, ks, vs)
    assert pa.ragged_paged_attention.launches == 1
    again = pa.ragged_paged_attention(q, kp, vp, tables, lens, ks, vs)
    want = pa.ragged_paged_attention(q, kp, vp, tables, lens, ks, vs,
                                     impl="dense")
    torch.cuda.synchronize()
    assert not got[0].any()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
@pytest.mark.parametrize("s,d,bs", [(4, 128, 16), (8, 128, 16), (4, 64, 32)])
def test_span_verify_rows_equal_decode_across_span_edges(device, kind, s, d,
                                                         bs):
    """Verify rows whose stagger straddles a span edge (254 + 0..3 crosses
    256; 509 + 0..7 crosses 512) are bitwise the decode kernel at their
    lengths, and the verify kernel is within one bf16 ulp of its plain
    version; 32 rows (S 8, group 4) take two 16-row tiles."""
    gen = torch.Generator(device=device).manual_seed(s + d + bs)
    t = 2048 // bs
    lengths = [0, 1, 253, 254, 256 - s + 1, 509, 768, 2048 - s + 1]
    q, kp, vp, ks, vs, tables, lens = _paged_case(
        gen, device, torch.bfloat16, kind, lengths, 32, 8, d, bs, t, s)
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
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))


def test_paged_variant_table_reaches_the_c_entries(device, monkeypatch):
    """Decode and verify hand their C entries the code of the design the
    table names for (q dtype, page dtype, bs, D) -- the same for both --
    and an entry refuses a design it is not built for: the span walk for
    f32 queries or for a shape outside the table."""
    cases = [(torch.bfloat16, None, 128, 16, "tensor_core"),
             (torch.bfloat16, "int8", 64, 32, "tensor_core"),
             (torch.bfloat16, "fp8", 128, 16, "tensor_core"),
             (torch.bfloat16, None, 96, 16, "cuda_core"),
             (torch.bfloat16, None, 128, 8, "cuda_core"),
             (torch.float32, None, 128, 16, "cuda_core"),
             (torch.float32, "int8", 128, 16, "cuda_core")]
    real = _kernels._entry
    for dtype, kind, d, bs, name in cases:
        pages = dtype if kind is None else QUANT[kind]
        assert _kernels.paged_variant(dtype, pages, bs, d) == name
        gen = torch.Generator(device=device).manual_seed(d + bs)
        q, kp, vp, ks, vs, tables, lens = _paged_case(
            gen, device, dtype, kind, [300, 17], 8, 2, d, bs, 40, 4)
        seen = []

        def spy(kernel, dt, page_dtype=None):
            fn = real(kernel, dt, page_dtype)

            def call(*args):
                seen.append((kernel, args[-2]))
                return fn(*args)
            return call

        monkeypatch.setattr(_kernels, "_entry", spy)
        _kernels.paged_decode(q[:, :1].contiguous(), kp, vp, tables, lens,
                              ks, vs)
        _kernels.paged_verify(q, kp, vp, tables, lens, ks, vs)
        monkeypatch.setattr(_kernels, "_entry", real)
        torch.cuda.synchronize()
        code = _kernels.PAGED_VARIANTS[name]
        assert seen == [("paged_decode", code), ("paged_verify", code)]
        if name == "cuda_core":  # the span walk is not built for these
            out = torch.empty_like(q[:, :1])
            ws = torch.empty(1 << 20, device=device)
            cnt = torch.zeros(64, dtype=torch.int32, device=device)
            sc = (None, None) if ks is None else (ks.data_ptr(),
                                                  vs.data_ptr())
            rc = real("paged_decode", dtype, kp.dtype)(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), *sc,
                tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                ws.data_ptr(), cnt.data_ptr(), 2, 2, 4, d, bs, 40,
                d ** -0.5, _kernels.PAGED_VARIANTS["tensor_core"],
                torch.cuda.current_stream(device).cuda_stream)
            assert rc != 0


# ---- the prefill kernel on the tensor cores (csrc/paged_prefill.cu) ----

# (C, offset): edge to edge of a 64-key stage; inside to inside across
# stages; from an edge to inside one; ending one key past an edge.
PREFILL_WINDOWS = [(64, 0), (40, 100), (20, 64), (73, 192)]


def _prefill_pages(gen, kind, tw, hkv, bs, d, device):
    if kind is None:
        return (*(_pool(gen, 1 + tw, hkv, bs, d, torch.bfloat16, device)
                  for _ in range(2)), None, None)
    kp, ks = _quant_pool(gen, 1 + tw, hkv, bs, d, kind, device)
    vp, vs = _quant_pool(gen, 1 + tw, hkv, bs, d, kind, device)
    return kp, vp, ks, vs


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d,bs", [(128, 16), (64, 32), (128, 32), (64, 16)])
@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
def test_tensor_core_prefill_matches_plain(device, kind, d, bs, group):
    """bf16 queries at D 64/128, bs 16/32 run the tensor-core design on
    bf16, int8 and fp8 pages: within one bf16 ulp of the plain version on
    windows that start and end inside a 64-key stage and on its edge, with
    ragged last row tiles (C * group not a multiple of 64), one launch a
    call."""
    pages = torch.bfloat16 if kind is None else QUANT[kind]
    assert _kernels.paged_variant(torch.bfloat16, pages, bs,
                                  d) == "tensor_core"
    gen = torch.Generator(device=device).manual_seed(d + bs + group)
    hkv, tw = 2, 320 // bs
    kp, vp, ks, vs = _prefill_pages(gen, kind, tw, hkv, bs, d, device)
    table = (torch.randperm(tw, device=device) + 1).to(torch.int32)
    for c, offset in PREFILL_WINDOWS:
        q = torch.randn((1, c, hkv * group, d), generator=gen,
                        device=device).to(torch.bfloat16)
        pa.reset_launch_counts()
        got = pa.paged_prefill_attention(q, kp, vp, table, offset, ks, vs)
        assert pa.paged_prefill_attention.launches == 1
        want = pa.paged_prefill_attention(q, kp, vp, table, offset, ks, vs,
                                          impl="dense")
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   **_tol(torch.bfloat16),
                                   msg=lambda m: f"C {c} @ {offset}: {m}")


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
def test_tensor_core_prefill_rows_do_not_depend_on_the_window(device, kind):
    """At the Llama-3-8B heads (Hq 32, Hkv 8, D 128, bs 16): rows 256-511
    of a 512-token window at offset 0 are torch.equal to a 256-token window
    at offset 256 over the same pages; so are positions 42-63 of a 48-token
    window at offset 16 and a 22-token window at offset 42, which sit 104
    rows apart: in other row tiles, warps and rows of a warp."""
    gen = torch.Generator(device=device).manual_seed(11)
    tw = 40
    kp, vp, ks, vs = _prefill_pages(gen, kind, tw, 8, 16, 128, device)
    table = (torch.randperm(tw, device=device) + 1).to(torch.int32)
    q = torch.randn((1, 512, 32, 128), generator=gen, device=device
                    ).to(torch.bfloat16)
    for (c, offset), (c2, offset2) in (((512, 0), (256, 256)),
                                       ((48, 16), (22, 42))):
        whole = pa.paged_prefill_attention(q[:, :c].contiguous(), kp, vp,
                                           table, offset, ks, vs)
        part = pa.paged_prefill_attention(
            q[:, c - c2:c].contiguous(), kp, vp, table, offset2, ks, vs)
        torch.cuda.synchronize()
        assert torch.equal(whole[:, c - c2:], part), (c, offset)


def test_prefill_windows_launch_from_threads(device):
    """Serving replicas in one process prefill on threads of their own, and
    the tensor-core design's shared memory grows with the window's last
    page. Short windows at offset 0 and long ones deep in the table, each
    launched through the C entry over and over from threads of their own
    (little Python between calls, so the calls overlap): every launch
    succeeds, and each window's output is torch.equal to the wrapper's
    output for it alone."""
    import threading

    gen = torch.Generator(device=device).manual_seed(5)
    tw, hkv, group, d, bs = 160, 8, 4, 128, 16
    kp, vp, _, _ = _prefill_pages(gen, None, tw, hkv, bs, d, device)
    table = (torch.randperm(tw, device=device) + 1).to(torch.int32)
    windows = [(16, 0), (64, 2400), (8, 8), (128, 2048)]
    qs = [torch.randn((1, c, hkv * group, d), generator=gen, device=device
                      ).to(torch.bfloat16) for c, _ in windows]
    want = [pa.paged_prefill_attention(q, kp, vp, table, offset)
            for q, (_, offset) in zip(qs, windows)]
    outs = [torch.empty_like(q) for q in qs]
    torch.cuda.synchronize()
    entry = _kernels._entry("paged_prefill", torch.bfloat16, torch.bfloat16)
    code = _kernels.PAGED_VARIANTS[_kernels.paged_variant(
        torch.bfloat16, torch.bfloat16, bs, d)]
    stream = torch.cuda.current_stream(device).cuda_stream
    failed = []

    def run(i):
        c, offset = windows[i]
        args = (qs[i].data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None,
                table.data_ptr(), outs[i].data_ptr(), c, hkv, group, d, bs,
                tw, offset, d ** -0.5, code, stream)
        for _ in range(2000):
            rc = entry(*args)
            if rc:
                failed.append((windows[i], rc))
                return

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(windows))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not failed, failed[:4]
    for window, got, w in zip(windows, outs, want):
        assert torch.equal(got, w), window


def test_prefill_variant_reaches_the_c_entry(device, monkeypatch):
    """The prefill wrapper hands its C entry the code of the design the
    table names -- bf16 at bs 16 / D 128 the tensor cores, f32 and the
    shapes outside the table the CUDA cores -- and the entry refuses the
    tensor-core design for f32 queries."""
    cases = [(torch.bfloat16, None, 128, 16, "tensor_core"),
             (torch.bfloat16, "int8", 64, 32, "tensor_core"),
             (torch.bfloat16, "fp8", 128, 16, "tensor_core"),
             (torch.bfloat16, None, 96, 16, "cuda_core"),
             (torch.bfloat16, None, 128, 8, "cuda_core"),
             (torch.float32, None, 128, 16, "cuda_core"),
             (torch.float32, "int8", 128, 16, "cuda_core")]
    real = _kernels._entry
    for dtype, kind, d, bs, name in cases:
        pages = dtype if kind is None else QUANT[kind]
        assert _kernels.paged_variant(dtype, pages, bs, d) == name
        gen = torch.Generator(device=device).manual_seed(d + bs)
        q, kp, vp, ks, vs, tables, _ = _paged_case(
            gen, device, dtype, kind, [300], 8, 2, d, bs, 40)
        qc = torch.randn((1, 37, 8, d), generator=gen, device=device
                         ).to(dtype)
        seen = []

        def spy(kernel, dt, page_dtype=None):
            fn = real(kernel, dt, page_dtype)

            def call(*args):
                seen.append((kernel, args[-2]))
                return fn(*args)
            return call

        monkeypatch.setattr(_kernels, "_entry", spy)
        got = _kernels.paged_prefill(qc, kp, vp, tables[0], 200, ks, vs)
        monkeypatch.setattr(_kernels, "_entry", real)
        want = pa.paged_prefill_attention(qc, kp, vp, tables[0], 200, ks, vs,
                                          impl="dense")
        torch.cuda.synchronize()
        assert seen == [("paged_prefill", _kernels.PAGED_VARIANTS[name])]
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
        if dtype == torch.float32:  # the tensor-core design is not built
            out = torch.empty_like(qc)
            sc = (None, None) if ks is None else (ks.data_ptr(),
                                                  vs.data_ptr())
            rc = real("paged_prefill", dtype, kp.dtype)(
                qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), *sc,
                tables[0].data_ptr(), out.data_ptr(), 37, 2, 4, d, bs, 40,
                200, d ** -0.5, _kernels.PAGED_VARIANTS["tensor_core"],
                torch.cuda.current_stream(device).cuda_stream)
            assert rc != 0


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
    _kernels.flash_bwd_dq(q, k, v, do, lse, torch.zeros_like(lse))
    _kernels.flash_bwd_dkv(q, k, v, do, lse, torch.zeros_like(lse))
    torch.cuda.synchronize()
    code = _kernels.FLASH_VARIANTS[name].code
    assert _kernels.flash_variant(dtype, d) == name
    assert seen == [("flash_fwd", code), ("flash_bwd_dq", code),
                    ("flash_bwd_dkv", code)]
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


# ---- the row-invariant decode GEMM and RMSNorm, and dQ's tensor cores

# Llama-3-8B's decode and verify products as the steps launch them, (K,
# widths of the group, out dtype): wq+wk+wv, wo, w3+w1, w2, and the lm
# head in f32.
GEMM_8B = [(4096, (4096, 1024, 1024), torch.bfloat16),
           (4096, (4096,), torch.bfloat16),
           (4096, (14336, 14336), torch.bfloat16),
           (14336, (4096,), torch.bfloat16),
           (4096, (128256,), torch.float32)]
GEMM_8B_IDS = ["wq+wk+wv", "wo", "w3+w1", "w2", "lm_head"]


def _gemm_group(gen, k, ns, dtype, device):
    ws = [(torch.randn((k, n), generator=gen, device=device) * 0.02
           ).to(dtype) for n in ns]
    x = torch.randn((64, k), generator=gen, device=device).to(dtype)
    return x, ws


@pytest.mark.parametrize("k,ns,out", GEMM_8B, ids=GEMM_8B_IDS)
def test_decode_gemm_rows_are_bitwise_and_match_plain(device, k, ns, out):
    """One grouped launch at each 8B group (K split by ``gemm_splits``):
    rows at every M of 1-63 are torch.equal to the rows at M 64 (so a
    decode tick's rows are a verify tick's for any max_batch and spec_k
    within one launch), the kernel is within one bf16 ulp of torch.mm at
    M 8 and 32, and twenty repeated launches give the same bits."""
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg

    gen = torch.Generator(device=device).manual_seed(k + sum(ns))
    x, ws = _gemm_group(gen, k, ns, torch.bfloat16, device)
    dg.reset_launch_counts()
    full = dg.decode_gemm_group(x, ws, out)
    assert dg.decode_gemm_group.launches == 1
    for m in range(1, 64):
        for a, b in zip(dg.decode_gemm_group(x[:m].contiguous(), ws, out),
                        full):
            assert torch.equal(a, b[:m]), m
    for m in (8, 32):
        want = dg.decode_gemm_group_plain(x[:m].contiguous(), ws, out)
        for a, b in zip(full, want):
            torch.testing.assert_close(a[:m].float(), b.float(),
                                       **_tol(torch.bfloat16))
    for _ in range(20):
        for a, b in zip(dg.decode_gemm_group(x, ws, out), full):
            assert torch.equal(a, b)
    torch.cuda.synchronize()


@pytest.mark.parametrize("k,ns", [(k, ns) for k, ns, _ in GEMM_8B],
                         ids=GEMM_8B_IDS)
def test_decode_gemm_f32_rows_are_bitwise_and_within_the_sum_bound(device, k,
                                                                   ns):
    """f32 operands (a model served in f32), one grouped launch at each 8B
    group: rows at every M of 1-63 are torch.equal to the rows at M 64,
    twenty repeated launches give the same bits, and each output is
    within the bound any order of an f32 sum of K products obeys,
    |y - exact| <= K 2^-24 sum_k |x_k w_k| (exact: the f64 product)."""
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg

    gen = torch.Generator(device=device).manual_seed(k + sum(ns) + 1)
    x, ws = _gemm_group(gen, k, ns, torch.float32, device)
    dg.reset_launch_counts()
    full = dg.decode_gemm_group(x, ws)
    assert dg.decode_gemm_group.launches == 1
    for m in range(1, 64):
        for a, b in zip(dg.decode_gemm_group(x[:m].contiguous(), ws), full):
            assert torch.equal(a, b[:m]), m
    for _ in range(20):
        for a, b in zip(dg.decode_gemm_group(x, ws), full):
            assert torch.equal(a, b)
    for y, w in zip(full, ws):
        assert y.dtype == torch.float32
        exact = x.double() @ w.double()
        bound = 1.01 * k * 2.0 ** -24 * (x.double().abs() @ w.double().abs())
        assert bool(((y.double() - exact).abs() <= bound).all())
    torch.cuda.synchronize()


def test_decode_gemm_runs_more_than_64_rows_in_launches_of_64(device):
    """70 rows are one launch of two row tiles of 64 (a prefill window's
    rows the same way): each tile's rows bitwise a launch of them alone."""
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg

    gen = torch.Generator(device=device).manual_seed(70)
    w = torch.randn((136, 200), generator=gen, device=device
                    ).to(torch.bfloat16)
    x = torch.randn((70, 136), generator=gen, device=device
                    ).to(torch.bfloat16)
    dg.reset_launch_counts()
    full = dg.decode_gemm(x, w)
    assert dg.decode_gemm_group.launches == 1
    assert torch.equal(dg.decode_gemm(x[:64].contiguous(), w), full[:64])
    assert torch.equal(dg.decode_gemm(x[64:].contiguous(), w), full[64:])
    assert torch.equal(dg.decode_gemm(x[:5].contiguous(), w), full[:5])
    torch.testing.assert_close(full.float(), (x.float() @ w.float()),
                               **_tol(torch.bfloat16))


def test_row_wrappers_count_only_their_launches(device):
    """The counters rise by the launches made: none for zero rows, one a
    call of the GEMM (130 rows: one launch of three row tiles)."""
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg
    from triton_kubernetes_tpu_torch.ops import norms

    x = torch.ones((130, 64), dtype=torch.bfloat16, device=device)
    w = torch.ones((64, 32), dtype=torch.bfloat16, device=device)
    scale = torch.ones(64, dtype=torch.bfloat16, device=device)
    dg.reset_launch_counts()
    norms.reset_launch_counts()
    assert dg.decode_gemm(x[:0], w).shape == (0, 32)
    assert norms.rms_norm_rows(x[:0], scale, 1e-5).shape == (0, 64)
    assert dg.decode_gemm_group.launches == norms.rms_norm_rows.launches == 0
    assert torch.equal(dg.decode_gemm(x, w), torch.full(
        (130, 32), 64.0, dtype=torch.bfloat16, device=device))
    assert dg.decode_gemm_group.launches == 1
    for y in dg.decode_gemm_group(x, [w, w[:, :8].contiguous(), w]):
        assert torch.equal(y, torch.full((130, y.shape[1]), 64.0,
                                         dtype=torch.bfloat16, device=device))
    assert dg.decode_gemm_group.launches == 2
    norms.rms_norm_rows(x, scale, 1e-5)
    assert norms.rms_norm_rows.launches == 1
    h, y = norms.add_rms_norm_rows(x[:0], x[:0], scale, 1e-5)
    assert h.shape == y.shape == (0, 64)
    assert norms.add_rms_norm_rows.launches == 0
    norms.add_rms_norm_rows(x, x, scale, 1e-5)
    assert norms.add_rms_norm_rows.launches == 1
    assert norms.rms_norm_rows.launches == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [4096, 64, 136])
def test_rms_norm_kernel_rows_are_bitwise_and_match_plain(device, dtype, d):
    from triton_kubernetes_tpu_torch.ops import norms

    gen = torch.Generator(device=device).manual_seed(d)
    x = (3 * torch.randn((32, d), generator=gen, device=device)).to(dtype)
    scale = (1 + 0.1 * torch.randn((d,), generator=gen, device=device)
             ).to(dtype)
    norms.reset_launch_counts()
    full = norms.rms_norm_rows(x, scale, 1e-5)
    assert norms.rms_norm_rows.launches == 1
    for m in (1, 8):
        assert torch.equal(norms.rms_norm_rows(x[:m], scale, 1e-5),
                           full[:m])
    torch.testing.assert_close(full.float(),
                               norms.rms_norm(x, scale, 1e-5).float(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [4096, 5120, 8192, 8704, 64, 136])
def test_add_rms_norm_kernel_is_add_then_the_norm_kernel(device, dtype, d):
    """One fused launch: h torch.equal to torch's x + delta, y torch.equal
    to the delta-null kernel on that h, rows at M 1, 8, 32 and 256 bitwise
    the rows at M 64, y within one bf16 ulp of the plain version (f32:
    summation order), x and delta not written."""
    from triton_kubernetes_tpu_torch.ops import norms

    gen = torch.Generator(device=device).manual_seed(d + 1)
    x = (3 * torch.randn((256, d), generator=gen, device=device)).to(dtype)
    delta = torch.randn((256, d), generator=gen, device=device).to(dtype)
    scale = (1 + 0.1 * torch.randn((d,), generator=gen, device=device)
             ).to(dtype)
    before = (x.clone(), delta.clone())
    norms.reset_launch_counts()
    h, y = norms.add_rms_norm_rows(x[:64], delta[:64], scale, 1e-5)
    assert norms.add_rms_norm_rows.launches == 1
    assert torch.equal(x, before[0]) and torch.equal(delta, before[1])
    assert torch.equal(h, x[:64] + delta[:64])
    assert torch.equal(y, norms.rms_norm_rows(h, scale, 1e-5))
    for m in (1, 8, 32):
        hm, ym = norms.add_rms_norm_rows(x[:m], delta[:m], scale, 1e-5)
        assert torch.equal(hm, h[:m]) and torch.equal(ym, y[:m]), m
    h_all, y_all = norms.add_rms_norm_rows(x, delta, scale, 1e-5)
    assert torch.equal(h_all[:64], h) and torch.equal(y_all[:64], y)
    torch.testing.assert_close(
        y_all.float(), norms.add_rms_norm(x, delta, scale, 1e-5)[1].float(),
        **_tol(dtype))


def test_add_rms_norm_kernel_refuses_what_it_does_not_take(device):
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=device)
    scale = torch.ones(64, dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="share a dtype"):
        _kernels.add_rms_norm(x, x.float(), scale, 1e-5)
    with pytest.raises(ValueError, match="delta"):
        _kernels.add_rms_norm(x, x[:2], scale, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.add_rms_norm(x, x.T.contiguous().T, scale, 1e-5)
    flat = torch.zeros(4 * 64 + 4, dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _kernels.add_rms_norm(x, flat[4:].view(4, 64), scale, 1e-5)
    with pytest.raises(ValueError, match="a row"):
        _kernels.add_rms_norm(x[:0], x[:0], scale, 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        _kernels.add_rms_norm(x[:, :60].contiguous(), x[:, :60].contiguous(),
                              scale[:60].contiguous(), 1e-5)


def test_row_kernels_refuse_what_they_do_not_take(device):
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=device)
    w = torch.zeros((64, 32), dtype=torch.bfloat16, device=device)
    y = torch.empty((4, 32), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="bfloat16"):
        _kernels.decode_gemm(x.float(), [w], [y])
    with pytest.raises(ValueError, match="float32"):
        _kernels.decode_gemm(x.float(), [w.float()], [y])  # f32 in, bf16 out
    with pytest.raises(ValueError, match="multiple of 8"):
        _kernels.decode_gemm(x[:, :60].contiguous(), [w[:60]], [y])
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.decode_gemm(x, [w.T.contiguous().T], [y])
    with pytest.raises(ValueError, match="a row"):
        _kernels.decode_gemm(x[:0], [w], [y[:0]])  # M 0: the wrapper's job
    with pytest.raises(ValueError, match="a row"):
        _kernels.rms_norm(x[:0], torch.ones(64, dtype=torch.bfloat16,
                                            device=device), 1e-5)
    with pytest.raises(ValueError, match="share a dtype"):
        _kernels.rms_norm(x, torch.ones(64, device=device), 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        _kernels.rms_norm(x[:, :60].contiguous(),
                          torch.ones(60, dtype=torch.bfloat16,
                                     device=device), 1e-5)


def test_decode_gemm_group_refuses(device):
    """A group whose weights do not share x's K, more than three products,
    outputs that do not match, mixed output dtypes, and CPU tensors: the
    binding raises before any launch, and the counter does not move."""
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg

    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=device)
    w = torch.zeros((64, 32), dtype=torch.bfloat16, device=device)
    dg.reset_launch_counts()
    with pytest.raises(ValueError, match=r"w \[64, N\]"):
        dg.decode_gemm_group(x, [w, torch.zeros(
            (72, 32), dtype=torch.bfloat16, device=device)])
    with pytest.raises(ValueError, match="1-3 weights"):
        dg.decode_gemm_group(x, [w] * 4)
    y = torch.empty((4, 32), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="as many"):
        _kernels.decode_gemm(x, [w, w], [y])
    with pytest.raises(ValueError, match="every y"):
        _kernels.decode_gemm(x, [w, w], [y, y.float()])
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.decode_gemm(x.cpu(), [w.cpu()], [y.cpu()])
    with pytest.raises(ValueError, match="on cuda"):
        _kernels.decode_gemm(x, [w, w.cpu()], [y, y])
    assert dg.decode_gemm_group.launches == 0


@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (1, 333, 16, 4, 128),  # group 4, odd S, a ragged 64-key tile
    (2, 131, 8, 2, 64),    # group 4 at D 64, three past a 128 boundary
    (1, 63, 4, 1, 128),    # below one key tile, group 4
    (1, 257, 8, 2, 64),    # one past two query tiles
    (2, 1, 4, 4, 128),     # one query
])
def test_flash_dq_tensor_cores_match_plain(device, b, s, hq, hkv, d):
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa

    assert _kernels.flash_variant(torch.bfloat16, d) == "tensor_core"
    gen = torch.Generator(device=device).manual_seed(s + d)
    q, k, v, do = _flash_inputs(gen, b, s, hq, hkv, d, torch.bfloat16,
                                device)
    out, lse = _kernels.flash_fwd(q, k, v)
    dvec = fa._row_dot(do, out)
    dq = _kernels.flash_bwd_dq(q, k, v, do, lse, dvec)
    want = fa._flash_backward_plain(q, k, v, do, lse, dvec)[0]
    torch.cuda.synchronize()
    torch.testing.assert_close(dq.float(), want.float(),
                               **_tol(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_small_model_verify_rows_are_decode_rows(device, dtype):
    """At llama-test widths on the card, in bf16 and in f32: each verify
    logits row (b, j) is torch.equal to the decode logits at length
    lengths[b] + j, and the two pools end bitwise equal -- through the
    paged kernels, the row-invariant GEMM and the fused add + norm."""
    from triton_kubernetes_tpu_torch.models import (
        get_config, init_params, paged)
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg
    from triton_kubernetes_tpu_torch.ops import norms

    cfg = get_config("llama-test", dtype=dtype)
    model = init_params(cfg, seed=2, device=device)
    bs, per, b, s = 4, 6, 3, 3
    cache = paged.init_paged_cache(cfg, 1 + b * per, bs, device=device)
    tables = (torch.arange(b * per, dtype=torch.int32, device=device)
              .reshape(b, per) + 1)
    gen = torch.Generator(device=device).manual_seed(6)
    lengths = [5, 9, 14]
    with torch.inference_mode():
        for i, n in enumerate(lengths):
            width = -(-n // bs) * bs
            toks = torch.randint(0, cfg.vocab_size, (1, width),
                                 generator=gen, device=device)
            paged.paged_prefill(model, toks.to(torch.int32), n, cfg, cache,
                                tables[i, :width // bs])
        tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                            device=device).to(torch.int32)
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        vcache = paged.PagedKVCache(cache.k.clone(), cache.v.clone())
        dg.reset_launch_counts()
        norms.reset_launch_counts()
        verify, _ = paged.paged_verify_step(model, tok, cfg, vcache, tables,
                                            lens)
        assert dg.decode_gemm_group.launches == 4 * cfg.num_layers + 1
        # The embeddings' norm, then one fused add + norm a layer boundary.
        assert norms.rms_norm_rows.launches == 1
        assert norms.add_rms_norm_rows.launches == 2 * cfg.num_layers
        for j in range(s):
            row = paged.paged_decode_step(model, tok[:, j].contiguous(), cfg,
                                          cache, tables, lens + j)
            assert torch.equal(verify[:, j], row), j
    assert torch.equal(vcache.k, cache.k) and torch.equal(vcache.v, cache.v)


# ------------------------------------------------------------------ W8A8
QDTYPES = [torch.int8, torch.float8_e4m3fn]


@pytest.mark.parametrize("qdtype", QDTYPES, ids=["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", [(1, 4096), (8, 4096), (32, 14336),
                                 (256, 4096), (5, 200)])
def test_quantize_rows_kernel_is_bitwise_the_plain_version(device, qdtype,
                                                           dtype, m, k):
    from triton_kubernetes_tpu_torch.ops import quantization as qz

    gen = torch.Generator(device=device).manual_seed(m + k)
    x = (torch.randn((m, k), generator=gen, device=device)
         * torch.exp(4 * torch.randn((m, 1), generator=gen, device=device))
         ).to(dtype)
    x[0] = 0
    qz.reset_launch_counts()
    got_q, got_s = qz.quantize_rows(x, qdtype)
    want_q, want_s = qz.quantize_rows_plain(x, qdtype)
    torch.cuda.synchronize()
    assert qz.quantize_rows.launches == 1
    assert torch.equal(got_q.view(torch.uint8), want_q.view(torch.uint8))
    assert torch.equal(got_s, want_s)


def _bits(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


@pytest.mark.parametrize("qdtype", QDTYPES, ids=["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [4096, 8704])
def test_norm_quant_entries_are_the_norm_kernels_then_the_quantizer(
        device, qdtype, dtype, d):
    """Kernel A as the norm's epilogue: h, xq and x_scale torch.equal to
    the norm kernel's entries followed by ``quantize_rows_plain`` at M 1,
    8, 32 and 256, D 4096 and 8704 (past the chunks a thread holds), rows
    bitwise across M; the wrappers count one launch each."""
    from triton_kubernetes_tpu_torch.ops import norms
    from triton_kubernetes_tpu_torch.ops import quantization as qz

    gen = torch.Generator(device=device).manual_seed(d)
    x = (3 * torch.randn((256, d), generator=gen, device=device)).to(dtype)
    delta = torch.randn((256, d), generator=gen, device=device).to(dtype)
    scale = (1 + 0.1 * torch.randn((d,), generator=gen, device=device)
             ).to(dtype)
    _, q256, s256 = _kernels.add_rms_norm_quant(x, delta, scale, 1e-5,
                                                qdtype)
    for m in (1, 8, 32, 256):
        h, xq, xs = _kernels.add_rms_norm_quant(x[:m], delta[:m], scale,
                                                1e-5, qdtype)
        want_h, y = _kernels.add_rms_norm(x[:m], delta[:m], scale, 1e-5)
        want_q, want_s = qz.quantize_rows_plain(y, qdtype)
        assert torch.equal(h, want_h), m
        assert torch.equal(_bits(xq), _bits(want_q)), m
        assert torch.equal(xs, want_s), m
        assert torch.equal(_bits(xq), _bits(q256[:m])), m
        assert torch.equal(xs, s256[:m]), m
        none, xq, xs = _kernels.add_rms_norm_quant(x[:m], None, scale, 1e-5,
                                                   qdtype)
        want_q, want_s = qz.quantize_rows_plain(
            _kernels.rms_norm(x[:m], scale, 1e-5), qdtype)
        assert none is None
        assert torch.equal(_bits(xq), _bits(want_q)), m
        assert torch.equal(xs, want_s), m
    norms.reset_launch_counts()
    rows = norms.rms_norm_quant_rows(x[:8].view(2, 4, d), scale, 1e-5,
                                     qdtype)
    h, rows2 = norms.add_rms_norm_quant_rows(x[:8].view(2, 4, d),
                                             delta[:8].view(2, 4, d), scale,
                                             1e-5, qdtype)
    torch.cuda.synchronize()
    assert rows.lead == rows2.lead == (2, 4) and h.shape == (2, 4, d)
    assert norms.rms_norm_quant_rows.launches == 1
    assert norms.add_rms_norm_quant_rows.launches == 1


@pytest.mark.parametrize("qdtype", QDTYPES, ids=["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("f", [14336, 16392])
def test_swiglu_quant_kernel_is_bitwise_the_plain_version(device, qdtype,
                                                          dtype, f):
    """The fused SwiGLU's bytes and scales torch.equal to torch's
    ``silu(gate.float()).to(T) * up`` followed by ``quantize_rows_plain``
    at M 1, 8, 32 and 256 (F 16392: past the chunks a thread holds), rows
    bitwise across M; one launch counted a call."""
    from triton_kubernetes_tpu_torch.ops import quantization as qz

    gen = torch.Generator(device=device).manual_seed(f)
    gate = (4 * torch.randn((256, f), generator=gen, device=device)
            ).to(dtype)
    up = torch.randn((256, f), generator=gen, device=device).to(dtype)
    q256, s256 = _kernels.swiglu_quant(gate, up, qdtype)
    for m in (1, 8, 32, 256):
        xq, xs = _kernels.swiglu_quant(gate[:m], up[:m], qdtype)
        want = qz.swiglu_quantize_rows_plain(gate[:m], up[:m], qdtype)
        assert torch.equal(_bits(xq), _bits(want.xq)), m
        assert torch.equal(xs, want.x_scale), m
        assert torch.equal(_bits(xq), _bits(q256[:m])), m
    qz.reset_launch_counts()
    rows = qz.swiglu_quantize_rows(gate[:8].view(2, 4, f),
                                   up[:8].view(2, 4, f), qdtype)
    torch.cuda.synchronize()
    assert rows.lead == (2, 4) and qz.swiglu_quantize_rows.launches == 1


def test_silu_probe_matches_torch_on_every_bf16_input(device):
    """The fused SwiGLU's SiLU gives torch's bits on all 65,536 bf16
    inputs (two NaNs agree): what lets one pass replace torch's SiLU."""
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32,
                     device=device).to(torch.int16).view(torch.bfloat16)
    got = _kernels.silu_probe(x)
    want = torch.nn.functional.silu(x.float()).to(torch.bfloat16)
    same = (got.view(torch.int16) == want.view(torch.int16)) | (
        got.isnan() & want.isnan())
    assert bool(same.all()), int((~same).sum())


def test_kernel_a_bindings_refuse(device):
    """Widths that are not a multiple of 8, shapes or dtypes that differ,
    a dtype that is not 8-bit, CPU tensors: refused before any launch."""
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=device)
    sc = torch.ones(64, dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="multiple of 8"):
        _kernels.quantize_rows(x[:, :60].contiguous(), torch.int8)
    with pytest.raises(ValueError, match="multiple of 8"):
        _kernels.swiglu_quant(x[:, :60].contiguous(),
                              x[:, :60].contiguous(), torch.int8)
    with pytest.raises(ValueError, match="one dtype"):
        _kernels.swiglu_quant(x, x.float(), torch.int8)
    with pytest.raises(ValueError, match="one dtype"):
        _kernels.swiglu_quant(x, x[:2], torch.int8)
    with pytest.raises(ValueError, match="int8 or float8"):
        _kernels.swiglu_quant(x, x, torch.bfloat16)
    with pytest.raises(ValueError, match="int8 or float8"):
        _kernels.add_rms_norm_quant(x, x, sc, 1e-5, torch.bfloat16)
    with pytest.raises(ValueError, match="share a dtype"):
        _kernels.add_rms_norm_quant(x, x.float(), sc, 1e-5, torch.int8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.swiglu_quant(x.cpu(), x.cpu(), torch.int8)


def _w8a8_group(gen, k, ns, qdtype, device):
    from triton_kubernetes_tpu_torch.ops import quantization as qz

    x = torch.randn((64, k), generator=gen, device=device).to(torch.bfloat16)
    xq, xs = qz.quantize_rows_plain(x, qdtype)
    pairs = [qz.quantize_channelwise(
        torch.randn((k, n), generator=gen, device=device) * 0.02, 0, qdtype)
        for n in ns]
    return (xq, xs, [w.t().contiguous() for w, _ in pairs],
            [sc.reshape(-1).contiguous() for _, sc in pairs])


@pytest.mark.parametrize("qdtype", QDTYPES, ids=["int8", "fp8"])
@pytest.mark.parametrize("k,ns,out", GEMM_8B, ids=GEMM_8B_IDS)
def test_w8a8_gemm_rows_are_bitwise_and_match_plain(device, qdtype, k, ns,
                                                    out):
    """One grouped W8A8 launch at each 8B group: int8 outputs torch.equal
    to the plain version at every M of 1-64 (exact int32 sums merged in
    int32), fp8 within one bf16 ulp at M 8 and 32; rows at every M
    bitwise the rows at M 64; twenty launches bitwise."""
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg

    gen = torch.Generator(device=device).manual_seed(k + sum(ns) + 7)
    xq, xs, ws, scales = _w8a8_group(gen, k, ns, qdtype, device)
    dg.reset_launch_counts()
    full = dg.w8a8_gemm_group(xq, xs, ws, scales, out)
    assert dg.w8a8_gemm_group.launches == 1
    for m in range(1, 65):
        got = dg.w8a8_gemm_group(xq[:m].contiguous(), xs[:m].contiguous(),
                                 ws, scales, out)
        for a, b in zip(got, full):
            assert torch.equal(a, b[:m]), m
        if qdtype == torch.int8 and m in (1, 8, 17, 32, 64):
            want = dg.w8a8_gemm_group_plain(xq[:m], xs[:m], ws, scales, out)
            for a, b in zip(got, want):
                assert torch.equal(a, b), m
    if qdtype != torch.int8:
        for m in (8, 32):
            want = dg.w8a8_gemm_group_plain(xq[:m], xs[:m], ws, scales, out)
            for a, b in zip(full, want):
                torch.testing.assert_close(a[:m].float(), b.float(),
                                           **_tol(torch.bfloat16))
    for _ in range(20):
        for a, b in zip(dg.w8a8_gemm_group(xq, xs, ws, scales, out), full):
            assert torch.equal(a, b)
    torch.cuda.synchronize()


@pytest.mark.parametrize("qdtype", QDTYPES, ids=["int8", "fp8"])
def test_quantized_einsum_on_the_card_is_the_cpu_result(device, qdtype):
    """quantized_einsum on CUDA tensors (kernels A and B, 70 rows: two
    launches of B) against the same call on CPU tensors (the reference's
    steps): int8 bitwise, fp8 within one bf16 ulp of the f32 result."""
    from triton_kubernetes_tpu_torch.ops import quantization as qz

    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 35, 64), generator=gen)
    w = torch.randn((64, 4, 16), generator=gen) * 0.02
    q, scale = qz.quantize_channelwise(w, 0, qdtype)
    want = qz.quantized_einsum("bsd,dhk->bshk", x, q, scale)
    got = qz.quantized_einsum("bsd,dhk->bshk", x.to(device), q.to(device),
                              scale.to(device))
    torch.cuda.synchronize()
    if qdtype == torch.int8:
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, atol=1e-2, rtol=2 ** -7)
    with pytest.raises(ValueError, match="trailing"):
        qz.quantized_einsum("bds,dhk->bshk",
                            x.transpose(1, 2).contiguous().to(device),
                            q.to(device), scale.to(device))


def test_w8a8_bindings_refuse(device):
    """Wrong dtypes, shapes, a K that is not a multiple of 16, a scale of
    the wrong size, and CPU tensors: the bindings raise before any
    launch."""
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg

    xq = torch.zeros((4, 64), dtype=torch.int8, device=device)
    xs = torch.ones(4, device=device)
    w = torch.zeros((32, 64), dtype=torch.int8, device=device)
    sc = torch.ones(32, device=device)
    y = torch.empty((4, 32), dtype=torch.bfloat16, device=device)
    dg.reset_launch_counts()
    with pytest.raises(ValueError, match="multiple of 16"):
        _kernels.decode_gemm_w8a8(xq[:, :56].contiguous(), xs,
                                  [w[:, :56].contiguous()], [sc], [y])
    with pytest.raises(ValueError, match="scale"):
        _kernels.decode_gemm_w8a8(xq, xs, [w], [sc[:16]], [y])
    with pytest.raises(ValueError, match="x_scale"):
        _kernels.decode_gemm_w8a8(xq, xs[:2], [w], [sc], [y])
    with pytest.raises(ValueError, match="every w"):
        _kernels.decode_gemm_w8a8(xq, xs, [w.view(torch.float8_e4m3fn)],
                                  [sc], [y])
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.decode_gemm_w8a8(xq.cpu(), xs.cpu(), [w.cpu()], [sc.cpu()],
                                  [y.cpu()])
    with pytest.raises(ValueError, match="int8 or float8"):
        _kernels.quantize_rows(y, torch.bfloat16)
    assert dg.w8a8_gemm_group.launches == 0


@pytest.mark.parametrize("wd", ["int8", "fp8"])
def test_small_w8a8_model_verify_rows_are_decode_rows(device, wd):
    """At llama-test widths (bf16) under W8A8: each verify logits row is
    torch.equal to the decode logits at its length, the pools end bitwise
    equal, and every product ran kernels A and B (one quantization a
    group: the norms' and the SwiGLU's own, wo's standalone)."""
    from triton_kubernetes_tpu_torch.models import (
        get_config, init_params, paged)
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg
    from triton_kubernetes_tpu_torch.ops import norms
    from triton_kubernetes_tpu_torch.ops import quantization as qz

    cfg = get_config("llama-test", dtype="bfloat16", weight_quant=wd,
                     matmul_dtype=wd)
    model = init_params(cfg, seed=2, device=device)
    bs, per, b, s = 4, 6, 3, 3
    cache = paged.init_paged_cache(cfg, 1 + b * per, bs, device=device)
    tables = (torch.arange(b * per, dtype=torch.int32, device=device)
              .reshape(b, per) + 1)
    gen = torch.Generator(device=device).manual_seed(6)
    lengths = [5, 9, 14]
    with torch.inference_mode():
        for i, n in enumerate(lengths):
            toks = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen,
                                 device=device).to(torch.int32)
            for off in range(0, n, 8):
                paged.paged_prefill_chunk(model, toks[:, off:off + 8], off,
                                          min(8, n - off), cfg, cache,
                                          tables[i])
        tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                            device=device).to(torch.int32)
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        vcache = paged.PagedKVCache(cache.k.clone(), cache.v.clone())
        dg.reset_launch_counts()
        qz.reset_launch_counts()
        norms.reset_launch_counts()
        verify, _ = paged.paged_verify_step(model, tok, cfg, vcache, tables,
                                            lens)
        assert dg.w8a8_gemm_group.launches == 4 * cfg.num_layers + 1
        # Kernel A: wo's input standalone, every other input inside the
        # launch that produces it.
        assert qz.quantize_rows.launches == cfg.num_layers
        assert qz.swiglu_quantize_rows.launches == cfg.num_layers
        assert norms.rms_norm_quant_rows.launches == 1
        assert norms.add_rms_norm_quant_rows.launches == 2 * cfg.num_layers
        assert norms.rms_norm_rows.launches == 0
        assert norms.add_rms_norm_rows.launches == 0
        assert dg.decode_gemm_group.launches == 0
        for j in range(s):
            row = paged.paged_decode_step(model, tok[:, j].contiguous(), cfg,
                                          cache, tables, lens + j)
            assert torch.equal(verify[:, j], row), j
    assert torch.equal(vcache.k, cache.k) and torch.equal(vcache.v, cache.v)


@pytest.mark.parametrize("wd", ["int8", "fp8"])
def test_small_w8a8_engine_spec_on_tokens_equal_spec_off(device, wd):
    from triton_kubernetes_tpu_torch.models import get_config, init_params
    from triton_kubernetes_tpu_torch.serve import Request, ServeEngine

    cfg = get_config("llama-test", dtype="bfloat16")
    model = init_params(cfg, seed=4, device=device)
    prompts = [[5, 7, 9, 11, 2, 4, 6, 8] * 3, [3] * 20, [9, 1, 9, 1] * 5]

    def run(spec_k):
        eng = ServeEngine(model, cfg, block_size=4, num_blocks=64,
                          max_batch=3, max_model_len=96, prefill_chunk=8,
                          prefix_cache=True, spec_k=spec_k, weight_dtype=wd,
                          matmul_dtype=wd, device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", p, 24))
        done = {d.request_id: d.tokens for d in eng.run_until_idle()}
        eng.release_prefix_cache()
        assert eng.allocator.in_use == 0
        return done, eng.stats()

    on, stats = run(3)
    off, _ = run(0)
    assert stats["verify_steps"] > 0
    assert on == off


@pytest.mark.parametrize("wd", [None, "int8"])
def test_prefill_windows_pages_do_not_depend_on_the_window(device, wd):
    """Fault F2 at llama-test widths (bf16): a 100-token prompt written by
    16-token windows and by 32-token ones leaves the same bytes in every
    full page, unquantized and under W8A8 int8."""
    from triton_kubernetes_tpu_torch.models import (
        get_config, init_params, paged)

    cfg = get_config("llama-test", dtype="bfloat16", max_seq_len=256,
                     **({} if wd is None else dict(weight_quant=wd,
                                                   matmul_dtype=wd)))
    model = init_params(cfg, seed=5, device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (100,), generator=gen,
                           device=device).tolist()
    pools = []
    for c in (16, 32):
        cache = paged.init_paged_cache(cfg, 33, 4, device=device)
        table = torch.arange(1, 33, dtype=torch.int32, device=device)
        with torch.inference_mode():
            for off in range(0, len(prompt), c):
                clen = min(c, len(prompt) - off)
                toks = prompt[off:off + clen] + [0] * (c - clen)
                paged.paged_prefill_chunk(
                    model, torch.tensor([toks], dtype=torch.int32,
                                        device=device),
                    off, clen, cfg, cache, table)
        pools.append(cache)
    torch.cuda.synchronize()
    full = len(prompt) // 4
    assert torch.equal(pools[0].k[:, 1:1 + full], pools[1].k[:, 1:1 + full])
    assert torch.equal(pools[0].v[:, 1:1 + full], pools[1].v[:, 1:1 + full])


@pytest.mark.parametrize("kv", ["auto", "int8", "fp8"])
@pytest.mark.parametrize("spec_k", [0, 3])
def test_small_engine_handoff_and_drain_keep_the_tokens(device, kv, spec_k):
    """KV-session migration between two engines on the card (bf16
    llama-test): each session handed off after its first token, or drained
    mid-stream, continues on the destination to the unmigrated engine's
    tokens; a torn payload leaves the destination's pool ``torch.equal``
    to before and the source resumes it to the same tokens."""
    from triton_kubernetes_tpu_torch.models import get_config, init_params
    from triton_kubernetes_tpu_torch.serve import (
        Request, ServeEngine, TornPayloadError, corrupt)

    cfg = get_config("llama-test", dtype="bfloat16")
    model = init_params(cfg, seed=6, device=device)
    prompts = [[5, 7, 9, 11, 2, 4, 6, 8] * 3, [3] * 20, [9, 1, 9, 1] * 5]
    kw = dict(block_size=4, num_blocks=64, max_batch=3, max_model_len=96,
              prefill_chunk=8, prefix_cache=True, spec_k=spec_k,
              kv_dtype=kv, device=device)

    def engine():
        return ServeEngine(model, cfg, **kw)

    base = engine()
    for i, p in enumerate(prompts):
        base.submit(Request(f"r{i}", p, 24))
    want = {d.request_id: d.tokens for d in base.run_until_idle()}

    # Handoff: first token on the source, the rest on the destination.
    src, dst = engine(), engine()
    for i, p in enumerate(prompts):
        src.submit(Request(f"r{i}", p, 24, handoff=True))
    got = {}
    for d in src.run_until_idle():
        assert d.finish_reason == "handoff"
        got[d.request_id] = d.tokens
        dst.import_session(src.export_session(d.request_id),
                           request_id=d.request_id)
        assert src.release_session(d.request_id) is None
    for d in dst.run_until_idle():
        assert got[d.request_id] == d.tokens[:1]
        got[d.request_id] = d.tokens
    assert got == want

    # Drain after a few decode ticks; a torn copy first, then the real one.
    src, dst = engine(), engine()
    for i, p in enumerate(prompts):
        src.submit(Request(f"r{i}", p, 24))
    done = {}
    for _ in range(8):
        done.update({d.request_id: d.tokens for d in src.step()})
    sessions = src.exportable_sessions()
    assert sessions
    for rid in sessions:
        blob = src.export_session(rid, reason="drain")
        pool = {n: t.clone() for n, t in dst._components().items()}
        with pytest.raises(TornPayloadError):
            dst.import_session(corrupt(blob, mode="bitflip",
                                       offset=len(blob) // 2))
        assert all(torch.equal(t, pool[n])
                   for n, t in dst._components().items())
        dst.import_session(blob, request_id=rid, reason="drain")
        assert src.release_session(rid).finish_reason == "migrated"
    done.update({d.request_id: d.tokens for d in src.run_until_idle()})
    done.update({d.request_id: d.tokens for d in dst.run_until_idle()})
    assert done == want


def test_two_engine_threads_keep_their_tokens(device):
    """Two engines stepping on two threads of one process, as two HTTP
    replicas do, launch on the device's default stream in turns: each
    request gets the tokens one engine alone gives it. The span walk's
    workspace (bf16 queries, D 64, bs 16: the tensor-core walk) is held
    until its launch is enqueued: freed before it, it went to the other
    thread's tensors (fault F4 of ROADMAP.md)."""
    import threading

    from triton_kubernetes_tpu_torch.models import get_config, init_params
    from triton_kubernetes_tpu_torch.serve import Request, ServeEngine

    cfg = get_config("llama-test", dtype="bfloat16", embed_dim=256,
                     num_heads=8, num_kv_heads=2, head_dim=64, mlp_dim=512,
                     max_seq_len=1024)
    assert _kernels.paged_variant(torch.bfloat16, torch.bfloat16, 16,
                                  64) == "tensor_core"
    model = init_params(cfg, seed=3, device=device)
    gen = torch.Generator().manual_seed(0)
    reqs = [Request(f"r{i}", torch.randint(0, cfg.vocab_size, (n,),
                                           generator=gen).tolist(), 24)
            for i, n in enumerate((300, 450, 600, 200, 500, 350, 250, 400))]
    kw = dict(block_size=16, num_blocks=512, max_batch=4, max_model_len=1024,
              prefill_chunk=64, prefix_cache=True, device=device)

    def run(engine, mine, out):
        for r in mine:
            engine.submit(r)
        out.update({d.request_id: d.tokens for d in engine.run_until_idle()})

    want = {}
    run(ServeEngine(model, cfg, **kw), reqs, want)
    for _ in range(3):
        got = [{}, {}]
        threads = [threading.Thread(target=run, args=(
            ServeEngine(model, cfg, **kw), reqs[i::2], got[i]))
            for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert {**got[0], **got[1]} == want


# ------------------------------------------------------------------- MoE
@pytest.mark.parametrize("e,d,f", [(8, 256, 512), (4, 128, 256)])
def test_moe_serve_layer_rows_are_bitwise_and_match_plain(device, e, d, f):
    """The serving MoE layer (``moe_layer_rows``: the router on the f32
    decode GEMM, padded to 8 columns where E is 4; each expert's w3+w1 and
    w2 on the bf16 one), dropless (cf E / K): its rows at M 1, 8 and 32
    bitwise its rows at M 256 -- on the mma.sync and the wgmma kernels --
    and each M within one bf16 ulp plus 1e-2 of the plain ``moe_layer``;
    the router and 2 E expert launches a call."""
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg
    from triton_kubernetes_tpu_torch.ops import moe

    gen = torch.Generator(device=device).manual_seed(e + d)
    params = {"router": torch.randn((d, e), generator=gen, device=device)
              * 0.05,
              **{k: (torch.randn(shape, generator=gen, device=device)
                     * 0.05).to(torch.bfloat16)
                 for k, shape in (("w1", (e, d, f)), ("w3", (e, d, f)),
                                  ("w2", (e, f, d)))}}
    x = torch.randn((256, d), generator=gen, device=device).to(torch.bfloat16)
    cf = e / 2

    def rows(xx):
        return moe.moe_layer_rows(xx[None], params, 2, cf)[0][0]

    full = rows(x)
    for m in (1, 8, 32):
        assert torch.equal(rows(x[:m].contiguous()), full[:m]), m
    for m in (1, 8, 32, 256):
        want = moe.moe_layer(x[:m][None], params, 2, cf)[0][0]
        torch.testing.assert_close(rows(x[:m].contiguous()), want,
                                   **_tol(torch.bfloat16))
    dg.reset_launch_counts()
    rows(x[:8].contiguous())
    assert dg.decode_gemm_group.launches == 1 + 2 * e


def test_f32_head_product_trains_on_the_card(device):
    """The lm head's f32-out product (``decode_gemm_plain``, which the
    pipeline's logits take) carries gradients on the card: those of the
    f32 product of the same bf16 operands, cast to each operand's dtype."""
    from triton_kubernetes_tpu_torch.ops.decode_gemm import decode_gemm_plain

    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn((64, 256), generator=gen, device=device).to(
        torch.bfloat16).requires_grad_(True)
    w = torch.randn((256, 512), generator=gen, device=device).to(
        torch.bfloat16).requires_grad_(True)
    g = torch.randn((64, 512), generator=gen, device=device)
    out = decode_gemm_plain(x, w, torch.float32)
    assert out.dtype == torch.float32
    out.backward(g)
    # Two f32 sums of the same 256 exact bf16 products, in different
    # orders (cuBLAS's and the f32 GEMM's): 1.3e-5 apart at worst on the
    # H100, where assert_close's f32 default (1.3e-6 relative) is for one
    # rounding.
    torch.testing.assert_close(out.detach(), x.float() @ w.float(),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(x.grad, (g @ w.float().t()).to(x.dtype))
    torch.testing.assert_close(w.grad, (x.float().t() @ g).to(w.dtype))


# Fault F9: a preempted sequence recomputes its history in prefill windows
# and takes its next token from a window's last row, where its solo run
# took it from a decode tick; a prefix-cache hit starts a prefill at
# another request's window boundary. The chaos arms' pools (bs 4) run the
# CUDA-core designs at every head width.
F9_CONFIG = dict(dtype="bfloat16", embed_dim=512, num_heads=4,
                 num_kv_heads=1, head_dim=128, mlp_dim=1024,
                 max_seq_len=256)


# The lengths past 256 cross the first span of the tensor-core decode walk.
F9_LONG = (250, 255, 256, 257, 258, 262)


@pytest.mark.parametrize("bs,chunk,design,lengths", [
    pytest.param(4, 8, "cuda_core", range(2, 40), id="4-8"),
    pytest.param(8, 16, "cuda_core", range(2, 40), id="8-16"),
    pytest.param(16, 16, "tensor_core", (*range(2, 40), *F9_LONG),
                 id="16-16"),
    pytest.param(32, 32, "tensor_core", (*range(2, 40), *F9_LONG),
                 id="32-32")])
def test_recompute_rows_are_decode_rows(device, bs, chunk, design, lengths):
    """A small bf16 model at the 8B's head width D 128 and GQA group 4,
    bs 4 and 8 (the CUDA-core designs) and bs 16 and 32 (the tensor-core
    designs, lengths across the decode walk's first 256-key span too): for
    every length L of a seeded sequence, the logits of the last row of the
    prefill windows over its first L tokens are torch.equal to those of
    one decode step at length L - 1 after windows over L - 1 tokens, and
    the pages the two wrote are torch.equal -- the kernels' rows, the
    row-invariant GEMM (the window's head included) and the norms give a
    recomputed row its solo bits."""
    from triton_kubernetes_tpu_torch.models import (
        get_config, init_params, paged)

    cfg = get_config("llama-test", **dict(F9_CONFIG, max_seq_len=512))
    assert _kernels.paged_variant(torch.bfloat16, torch.bfloat16, bs,
                                  cfg.head_dim) == design
    model = init_params(cfg, seed=9, device=device)
    gen = torch.Generator().manual_seed(9)
    seq = torch.randint(0, cfg.vocab_size, (max(lengths),),
                        generator=gen).tolist()
    per = max(48 // bs, -(-max(lengths) // chunk) * chunk // bs)
    table = torch.arange(1, per + 1, dtype=torch.int32, device=device)

    def windows(n):
        cache = paged.init_paged_cache(cfg, per + 1, bs, device=device)
        logits = None
        for off in range(0, n, chunk):
            clen = min(chunk, n - off)
            toks = seq[off:off + clen] + [0] * (chunk - clen)
            logits = paged.paged_prefill_chunk(
                model, torch.tensor([toks], dtype=torch.int32,
                                    device=device),
                off, clen, cfg, cache, table)
        return logits, cache

    def written(cache, n):
        """K and V of positions 0..n-1, [L, Hkv, n, D]."""
        pages = table[:-(-n // bs)].long()
        return [x[:, pages].transpose(1, 2).flatten(2, 3)[:, :, :n]
                for x in (cache.k, cache.v)]

    with torch.inference_mode():
        for n in lengths:
            want, wcache = windows(n)
            _, cache = windows(n - 1)
            got = paged.paged_decode_step(
                model, torch.tensor([seq[n - 1]], dtype=torch.int32,
                                    device=device),
                cfg, cache, table[None], torch.tensor(
                    [n - 1], dtype=torch.int32, device=device))[0]
            assert torch.equal(got, want), (n, float((got - want).abs()
                                                     .max()))
            for a, b in zip(written(cache, n), written(wcache, n)):
                assert torch.equal(a, b), n


def test_chaos_preempt_arm_on_the_card(device):
    """The engine-preempt chaos arm on the card, at the F9 model (weights
    from seed 9, as above), with the prefix cache and spec_k 3: a request
    preempted mid-prefill recomputes to its solo tokens, pages converge,
    the trace is complete -- through the paged decode, verify and prefill
    kernels, with drafts accepted (kept tokens that came from verify rows
    under preemption and recompute)."""
    from triton_kubernetes_tpu_torch.chaos import workload as wl
    from triton_kubernetes_tpu_torch.chaos.generator import generate_spec
    from triton_kubernetes_tpu_torch.chaos.runner import run_scenario
    from triton_kubernetes_tpu_torch.models import get_config, init_params
    from triton_kubernetes_tpu_torch.utils import metrics

    cfg = get_config("llama-test", **F9_CONFIG)
    wl.use_model(cfg, init_params(cfg, seed=9, device=device))
    try:
        spec = generate_spec(11, "workload")
        spec["workload"] = {"kind": "engine-preempt", "long_windows": 5,
                            "requests": 3, "prefix_cache": True,
                            "spec_k": 3}
        pa.reset_launch_counts()
        metrics.configure()
        res = run_scenario(spec, device="cuda")
        assert res.passed, res.violations
        assert res.stats["workload_preemptions"] >= 1
        assert metrics.counter(
            "tk8s_serve_spec_accepted_tokens_total").value() >= 1
        assert pa.ragged_paged_attention.launches > 0
        assert pa.paged_prefill_attention.launches > 0
        assert pa.ragged_verify_attention.launches > 0
    finally:
        wl.use_model()


def test_chaos_preempt_arm_in_a_tensor_core_pool(device):
    """The engine-preempt arm at the F9 model in a pool of 16-token pages
    (the paged kernels' tensor-core designs; 4 usable pages, 48-token
    prompts): it preempts, and every request's tokens are its solo run's
    -- a recomputed row's next token comes from a tensor-core prefill
    window's last row where the solo run took it from a decode tick."""
    from triton_kubernetes_tpu_torch.chaos import workload as wl
    from triton_kubernetes_tpu_torch.chaos.generator import generate_spec
    from triton_kubernetes_tpu_torch.chaos.runner import run_scenario
    from triton_kubernetes_tpu_torch.models import get_config, init_params

    cfg = get_config("llama-test", **F9_CONFIG)
    assert _kernels.paged_variant(torch.bfloat16, torch.bfloat16, 16,
                                  cfg.head_dim) == "tensor_core"
    wl.use_model(cfg, init_params(cfg, seed=9, device=device))
    try:
        spec = generate_spec(11, "workload")
        spec["workload"] = {"kind": "engine-preempt", "long_windows": 6,
                            "requests": 3, "block_size": 16}
        pa.reset_launch_counts()
        res = run_scenario(spec, device="cuda")
        assert res.passed, res.violations
        assert "engine-parity" in res.checked
        assert res.stats["workload_preemptions"] >= 1
        assert pa.ragged_paged_attention.launches > 0
        assert pa.paged_prefill_attention.launches > 0
    finally:
        wl.use_model()


def test_checkpoint_arm_holds_its_values_beside_forks(device):
    """Fault F11: the reshard-torn-checkpoint arm (a two-leaf state on the
    card saved through the pinned staging arena, the newest manifest
    torn, the step before restored) keeps each step's values while this
    process forks over and over, each child holding the pages
    copy-on-write (``forking_beside``): the arena's pages are its own and
    no fork shares them, so no save's bytes go stale."""
    import copy
    import os

    from triton_kubernetes_tpu_torch.chaos import corpus
    from triton_kubernetes_tpu_torch.chaos import workload as wl
    from triton_kubernetes_tpu_torch.chaos.runner import run_scenario

    entries = {e["name"]: e for _, e in corpus.load_entries(
        os.path.join(os.path.dirname(__file__), "chaos_corpus"))}
    spec = entries["workload-reshard-torn-checkpoint"]["spec"]
    with wl.forking_beside() as forks:
        bad = []
        for i in range(100):
            res = run_scenario(copy.deepcopy(spec), ns=f"f11-{i}",
                               device=device)
            if not res.passed:
                bad.append([v["detail"] for v in res.violations])
    assert forks[0] > 0
    assert not bad, bad


def test_cuda_core_decode_launches_from_replica_threads(device):
    """Replicas in one process decode on threads of their own, and the
    CUDA-core page walk's dynamic shared memory follows (rows, D, bs): the
    chaos arms' replicas (one model, bs 4) ask the same, replicas of other
    pool shapes do not. Decode and verify at bs 4 and 8, each launched
    through its C entry over and over from threads of their own: every
    launch succeeds, and each output is torch.equal to the wrapper's for
    it alone."""
    import threading

    gen = torch.Generator(device=device).manual_seed(8)
    hkv, group, d, tw = 2, 4, 128, 12
    cases = []
    for bs, s in ((4, 1), (8, 1), (4, 4), (8, 4)):
        kp = _pool(gen, 1 + 3 * tw, hkv, bs, d, torch.bfloat16, device)
        vp = _pool(gen, 1 + 3 * tw, hkv, bs, d, torch.bfloat16, device)
        tables = (torch.randperm(3 * tw, device=device).reshape(3, tw) + 1
                  ).to(torch.int32)
        lens = torch.tensor([5, tw * bs // 2, tw * bs - s], dtype=torch.int32,
                            device=device)
        q = torch.randn((3, s, hkv * group, d), generator=gen,
                        device=device).to(torch.bfloat16)
        fn = (pa.ragged_paged_attention if s == 1
              else pa.ragged_verify_attention)
        assert _kernels.paged_variant(q.dtype, kp.dtype, bs, d) == \
            "cuda_core"
        cases.append((bs, s, kp, vp, tables, lens, q, fn(q, kp, vp, tables,
                                                           lens)))
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(device).cuda_stream
    code = _kernels.PAGED_VARIANTS["cuda_core"]
    outs = [torch.empty_like(c[6]) for c in cases]
    failed = []

    def run(i):
        bs, s, kp, vp, tables, lens, q, _ = cases[i]
        name = "paged_decode" if s == 1 else "paged_verify"
        entry = _kernels._entry(name, torch.bfloat16, torch.bfloat16)
        args = [q.data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None,
                tables.data_ptr(), lens.data_ptr(), outs[i].data_ptr(),
                None, None, 3]
        if s > 1:
            args.append(s)
        args += [hkv, group, d, bs, tw, d ** -0.5, code, stream]
        for _ in range(2000):
            rc = entry(*args)
            if rc:
                failed.append(((bs, s), rc))
                return

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not failed, failed[:4]
    for case, got in zip(cases, outs):
        assert torch.equal(got, case[7]), case[:2]


_PPERMUTE_RANK = r"""
import json, sys
import torch
import torch.distributed as dist
from triton_kubernetes_tpu_torch.parallel import MeshConfig, create_mesh
from triton_kubernetes_tpu_torch.parallel import collectives

rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
mesh = create_mesh(MeshConfig(stage=2, fsdp=1), device_type="cuda")


def mine(r):
    gen = torch.Generator(device="cuda").manual_seed(100 + r)
    return torch.randn((3, 64, 96), generator=gen, device="cuda").to(
        torch.bfloat16)


x = mine(rank).requires_grad_()
swap = [(0, 1), (1, 0)]
y = collectives.ppermute(x, mesh, "stage", swap)
pos = collectives.ppermute(torch.arange(5, device="cuda") + 10 * rank, mesh,
                           "stage", [(0, 1)])
(y.float() * (rank + 2)).sum().backward()
torch.cuda.synchronize()
want_pos = torch.arange(5, device="cuda") if rank == 1 else torch.zeros(
    5, dtype=torch.long, device="cuda")
rec = dict(
    through_host=collectives._through_host(x, mesh.group(["stage"])),
    on_card=y.is_cuda and x.grad.is_cuda,
    peer_bitwise=bool(torch.equal(y, mine(1 - rank))),
    positions=bool(torch.equal(pos, want_pos)),
    grad_bitwise=bool(torch.equal(x.grad, torch.full_like(
        x, float((1 - rank) + 2)))))
open(out, "w").write(json.dumps(rec))
dist.barrier()
dist.destroy_process_group()
"""


def test_ppermute_over_gloo_on_the_card_goes_through_the_host(device,
                                                              tmp_path):
    """GPipe's shift (``collectives.ppermute`` along ``stage``) in a
    two-rank gloo world on cuda:0, as ``chip_smoke.py``'s four-rank world
    runs it: gloo's send and receive read a CUDA tensor's pointer as host
    memory (the process aborts, ``writev ... Bad address``), so over gloo
    a CUDA tensor goes through the host (``_through_host``, chosen by the
    backend). Each rank gets its peer's bf16 tensor bitwise, on the card;
    an integer tensor sent one way arrives and the other rank gets zeros;
    the backward's inverse shift brings each rank its peer's cotangent
    bitwise."""
    import json
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PPERMUTE_RANK, str(r), str(port), outs[r]],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = [p.communicate(timeout=180)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [x[-2000:] for x in logs]
    for path in outs:
        rec = json.loads(open(path).read())
        assert rec == dict(through_host=True, on_card=True,
                           peer_bitwise=True, positions=True,
                           grad_bitwise=True), rec
