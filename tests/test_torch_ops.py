"""Port parity: rms_norm, rotary and causal_attention of
``triton_kubernetes_tpu_torch.ops`` against the JAX package's, on the same
numpy inputs made from a seed. f32 on the CPU: rtol 1e-5 / atol 1e-6 (the
two frameworks sum in different orders; nothing else differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.ops import attention as jattn
from triton_kubernetes_tpu.ops import norms as jnorms
from triton_kubernetes_tpu.ops import rotary as jrot
from triton_kubernetes_tpu_torch.ops import attention as tattn
from triton_kubernetes_tpu_torch.ops import norms as tnorms
from triton_kubernetes_tpu_torch.ops import rotary as trot

RTOL, ATOL = 1e-5, 1e-6


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 16)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    scale = rng.standard_normal(shape[-1:]).astype(np.float32)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(scale)))


def test_rotary_tables_and_apply_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 128, size=(2, 6)).astype(np.int32)
    tc, ts = trot.rotary_tables(16, 128, 500_000.0, device="cpu")
    jc, js = jrot.rotary_tables(16, 128, 500_000.0)
    _close(tc, jc)
    _close(ts, js)
    got = trot.apply_rotary(torch.from_numpy(x), tc, ts,
                            torch.from_numpy(pos).long())
    want = jrot.apply_rotary(jnp.asarray(x), jc, js, jnp.asarray(pos))
    _close(got, want)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
def test_causal_attention_matches_jax_gqa(hq, hkv):
    """GQA grouping h = kv_head * group + g, explicit ragged positions."""
    rng = np.random.default_rng(2)
    b, sq, sk, d = 2, 5, 9, 16
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    qpos = np.array([[4, 5, 6, 7, 8], [0, 1, 2, 3, 4]], np.int32)
    kpos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    got = tattn.causal_attention(*map(torch.from_numpy, (q, k, v, qpos,
                                                         kpos)))
    want = jattn.causal_attention(*map(jnp.asarray, (q, k, v, qpos, kpos)))
    _close(got, want)


def test_causal_attention_fully_masked_rows_match_jax():
    """A row whose position precedes every key is fully masked: both
    frameworks give the same finite (uniform-average) output."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 2, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 4, 1, 8)).astype(np.float32)
    v = rng.standard_normal((1, 4, 1, 8)).astype(np.float32)
    qpos = np.array([[-1, 2]], np.int32)
    kpos = np.arange(4, dtype=np.int32)[None]
    got = tattn.causal_attention(*map(torch.from_numpy, (q, k, v, qpos,
                                                         kpos)))
    want = jattn.causal_attention(*map(jnp.asarray, (q, k, v, qpos, kpos)))
    assert torch.isfinite(got).all()
    _close(got, want)
