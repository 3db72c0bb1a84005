"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (marker ``cuda``); anywhere
else they skip, decided inside the fixture at run time. They import
neither JAX nor the JAX package, so they run on the card's machine with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` because ``tests/conftest.py`` sets up JAX). They cover
what ``chip_smoke.py``'s Llama-3-8B shapes do not: other group sizes, head
dims, block sizes, f32 pools, a window that is not page aligned in its
last rows, and the wrappers' refusals.
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
