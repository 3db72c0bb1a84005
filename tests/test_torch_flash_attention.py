"""The port's flash attention (``triton_kubernetes_tpu_torch.ops.
flash_attention``) against the JAX package's Pallas kernels, run as the
JAX tests run them on the CPU (``interpret=True``).

The same seeded numpy q/k/v and output cotangent go through both; on CPU
tensors the port runs its plain versions with the reference's block rule
(``_pick_block``), so both sides walk the same key tiles. Tolerances:
f32 1e-5 (summation order only); bf16 ``2e-2 + 2^-6 |ref|`` -- the two
sides round p and ds to bf16 at the same points, but an f32 sum in another
order can put a value on the other side of a bf16 rounding boundary, and
the few such flips in p or ds move an output by about one bf16 ulp of the
terms they touch (2^-8 relative), doubled for headroom.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.ops.attention import causal_attention
from triton_kubernetes_tpu.ops.flash_attention import \
    flash_attention as jflash
from triton_kubernetes_tpu_torch.ops import flash_attention as fa

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2 ** -6)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, s, hq, d))]


def _jax_side(arrs, dtype, block):
    q, k, v, g = (jnp.asarray(a).astype(JDT[dtype]) for a in arrs)

    def f(q, k, v):
        return jflash(q, k, v, block_q=block, block_k=block, interpret=True)

    out, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *vjp(g))]


def _port_side(arrs, dtype, block):
    q, k, v, g = (torch.from_numpy(a).to(TDT[dtype]) for a in arrs)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = fa.flash_attention(q, k, v, block_q=block, block_k=block)
    out.backward(g)
    return [t.detach().float().numpy() for t in (out, q.grad, k.grad, v.grad)]


# The key tiles of the port's two forward designs (``_kernels.
# FLASH_VARIANTS``): the plain forward is held against the JAX kernel at
# each. The reference pads S to a multiple of 128 and takes the largest
# 128-multiple block that fits, so 64 asks for 128 at these lengths and
# 128 asks for it outright; S = 300 walks three such tiles.
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s", [(4, 4, 128), (4, 2, 200), (8, 2, 128),
                                      (4, 2, 300)])
def test_forward_and_gradients_match_pallas(dtype, hq, hkv, s, block):
    arrs = _inputs(1, s, hq, hkv, 32, seed=hq * 1000 + s)
    want = _jax_side(arrs, dtype, block)
    got = _port_side(arrs, dtype, block)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **TOL[dtype])


def test_plain_forward_tiles_follow_the_block():
    """With several key tiles the plain forward still equals dense
    softmax attention in f32 (the closed-form running max is exact), and
    its lse is the row logsumexp."""
    arrs = _inputs(2, 96, 4, 2, 16, seed=3)
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    out, lse = fa._flash_forward_plain(q, k, v, block_k=32)
    want = causal_attention(*(jnp.asarray(a) for a in arrs[:3]))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    scores = fa._scores(q, k)  # [B, Hkv, G, S, S]
    np.testing.assert_allclose(
        lse.numpy(), torch.logsumexp(scores, -1).reshape(2, 4, 96).numpy(),
        atol=1e-5, rtol=1e-5)


def test_flash_variant_table_and_its_key_tiles():
    """Which design runs is decided by (dtype, head_dim) in one table, and
    each design's key tile is what the on-card comparisons hand the plain
    forward (``chip_smoke.py`` and ``tests/test_torch_cuda.py`` call
    ``kernel_block_k``)."""
    import inspect

    from triton_kubernetes_tpu_torch.ops import _kernels

    assert _kernels.FLASH_VARIANTS == {
        "tensor_core": _kernels.FlashVariant(code=1, block_k=128),
        "cuda_core": _kernels.FlashVariant(code=0, block_k=64)}
    want = {(torch.bfloat16, 128): "tensor_core",
            (torch.bfloat16, 64): "tensor_core",
            (torch.bfloat16, 96): "cuda_core",
            (torch.bfloat16, 32): "cuda_core",
            (torch.float32, 128): "cuda_core",
            (torch.float32, 64): "cuda_core"}
    for (dtype, d), name in want.items():
        assert _kernels.flash_variant(dtype, d) == name, (dtype, d)
        assert fa.kernel_block_k(dtype, d) == \
            _kernels.FLASH_VARIANTS[name].block_k
    assert fa.KERNEL_BLOCK_K == {"tensor_core": 128, "cuda_core": 64}
    # The wrappers pass the table's code, and nothing else picks a design.
    for fn in (_kernels.flash_fwd, _kernels.flash_bwd_dkv):
        assert "FLASH_VARIANTS[flash_variant(q.dtype, d)].code" in \
            inspect.getsource(fn)
    # The C sources instantiate the tensor-core kernels for exactly the
    # table's head widths.
    for src in ("flash_fwd.cu", "flash_bwd_dkv.cu"):
        text = (_kernels.CSRC / src).read_text()
        for _, d in _kernels.FLASH_TENSOR_CORE:
            assert f"launch_tc<{d}>" in text, (src, d)
    assert "wgmma.mma_async" in (_kernels.CSRC / "flash_wgmma.cuh"
                                 ).read_text()


@pytest.mark.parametrize("dtype,d", [("bfloat16", 128), ("bfloat16", 64),
                                     ("float32", 64)])
def test_plain_at_kernel_tile_equals_flash_attention_plain(dtype, d):
    """``flash_attention_plain`` picks the key tile of the kernel that
    would run for its operands."""
    arrs = _inputs(1, 160, 4, 2, d, seed=d)
    q, k, v = (torch.from_numpy(a).to(TDT[dtype]) for a in arrs[:3])
    got = fa.flash_attention_plain(q, k, v)
    want, _ = fa._flash_forward_plain(q, k, v, fa.kernel_block_k(TDT[dtype],
                                                                 d))
    assert torch.equal(got, want)


def test_pick_block_is_the_reference_rule():
    from triton_kubernetes_tpu.ops.flash_attention import _pick_block

    for default in (64, 128, 512, 1024):
        for s in (1, 100, 128, 200, 1000, 1280, 2048):
            assert fa._pick_block(default, s) == _pick_block(default, s)


def test_cpu_path_launches_no_kernel():
    fa.reset_launch_counts()
    q = torch.zeros((1, 8, 2, 8), requires_grad=True)
    fa.flash_attention(q, q[:, :, :1].detach(), q[:, :, :1].detach()
                       ).sum().backward()
    assert fa.flash_attention.launches == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_every_kernel_source_is_in_the_build_hash(tmp_path, monkeypatch):
    """Each kernel's library name hashes every source in csrc/, the flash
    kernels and their shared header included, so editing any of them
    rebuilds instead of loading a stale library."""
    import shutil

    from triton_kubernetes_tpu_torch.ops import _kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    assert set(_kernels._SIGNATURES) == set(_kernels.KERNELS)
    for name in _kernels.KERNELS:
        assert (csrc / f"{name}.cu").exists()
    before = {n: _kernels._library_path(n) for n in _kernels.KERNELS}
    for src in ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu",
                "flash_common.cuh", "flash_wgmma.cuh"):
        path = csrc / src
        path.write_text(path.read_text() + "\n// edited\n")
        after = {n: _kernels._library_path(n) for n in _kernels.KERNELS}
        assert all(after[n] != before[n] for n in _kernels.KERNELS), src
        before = after
