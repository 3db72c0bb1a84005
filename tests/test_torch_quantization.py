"""Port parity for quantized KV pools (``kv_dtype`` "int8" and "fp8").

* The KV quantizers (``ops/quantization.py``) are elementwise: the same
  seeded inputs give the JAX package's bytes and scales **bitwise**,
  overflowing amplitudes included (clip before the fp8 cast, round half to
  even for int8). ``kv_quant_error`` is a ratio of two f32 sums, which
  differ from XLA's only in summation order: rtol 1e-5.
* The model layer on quantized pools (whole-prompt prefill, chunked
  prefill, decode) against the JAX package at ``llama-test`` weights, f32,
  logits at 1e-4. Pages agree within one quantum (an element whose
  scaled value lands within f32 rounding of a rounding boundary may round
  the other way) and scales within 1e-6 relative.
* The engine: greedy tokens of the port's int8 engine equal the JAX int8
  engine's, and the quant-error gauge is set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_paged_cache as jinit_cache
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu.models import paged as jpaged
from triton_kubernetes_tpu.ops import quantization as jq
from triton_kubernetes_tpu.serve import ManualClock as JClock
from triton_kubernetes_tpu.serve import Request as JRequest
from triton_kubernetes_tpu.serve import ServeEngine as JServeEngine
from triton_kubernetes_tpu.utils import metrics as jmetrics
from triton_kubernetes_tpu_torch.models import (
    from_numpy_params,
    get_config,
    init_paged_cache,
    paged_decode_step,
    paged_prefill,
    paged_prefill_chunk,
)
from triton_kubernetes_tpu_torch.ops import quantization as tq
from triton_kubernetes_tpu_torch.ops.paged_attention import byte_view
from triton_kubernetes_tpu_torch.serve import ManualClock, Request, ServeEngine
from triton_kubernetes_tpu_torch.utils import metrics

KINDS = {"int8": (torch.int8, jnp.int8),
         "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
TOL = dict(rtol=1e-4, atol=1e-4)
BS, NUM_BLOCKS = 4, 24


def _np(x):
    """Values of a torch or JAX array as f32 numpy (8-bit converted)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return byte_view(x).view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


# --------------------------------------------------------------- quantizers
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_kv_quantizers_bitwise_match_jax(kind):
    tdt, jdt = KINDS[kind]
    rng = np.random.default_rng(0)
    # Per-page amplitudes over four decades, so later slots overflow their
    # slot-0 anchor's range and hit the clip.
    x = (rng.standard_normal((3, 5, 2, 4, 16))
         * rng.uniform(0.01, 50.0, (3, 5, 2, 4, 1))).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    assert tq.qmax_for(tdt) == jq.qmax_for(jdt)
    tqk, tsk = tq.quantize_kv_pages(tx, tdt)
    jqk, jsk = jq.quantize_kv_pages(jx, jdt)
    np.testing.assert_array_equal(_bytes(tqk), _bytes(jqk))
    np.testing.assert_array_equal(tsk.numpy(), np.asarray(jsk))
    assert np.isfinite(_np(tqk)).all()
    clipped = np.abs(_np(tqk)) == tq.qmax_for(tdt)
    assert clipped.any(), "no value reached the clip: the case is vacuous"
    np.testing.assert_array_equal(
        tq.token_kv_scale(tx[:, :, :, 0], tdt).numpy(),
        np.asarray(jq.token_kv_scale(jx[:, :, :, 0], jdt)))
    scale = rng.uniform(1e-3, 0.5, (3, 5, 2, 1, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        _bytes(tq.quantize_with_scale(tx, torch.from_numpy(scale), tdt)),
        _bytes(jq.quantize_with_scale(jx, jnp.asarray(scale), jdt)))
    mask = rng.random(x.shape) < 0.7
    for m in (None, mask):
        got = tq.kv_quant_error(tqk, tsk[..., None, None], tx,
                                None if m is None else torch.from_numpy(m))
        want = jq.kv_quant_error(jqk, jsk[..., None, None], jx,
                                 None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="no quantized range"):
        tq.qmax_for(torch.bfloat16)


# ------------------------------------------------------------- model layer
@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("llama-test")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("llama-test")
    model = from_numpy_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return jcfg, jparams, cfg, model


def _pools_close(jcache, tcache, pages):
    """Quantized pages within one quantum, scales within 1e-6 relative."""
    qmax = tq.qmax_for(tcache.k.dtype)
    for j, t, js, ts in ((jcache.k, tcache.k, jcache.k_scale, tcache.k_scale),
                         (jcache.v, tcache.v, jcache.v_scale,
                          tcache.v_scale)):
        np.testing.assert_allclose(ts[:, pages].numpy(),
                                   np.asarray(js)[:, pages], rtol=1e-6)
        got, want = _np(t[:, pages]), _np(j)[:, pages]
        # One quantum: 1 for int8; for fp8 the spacing at the value, at
        # most 2^-3 of it (3 mantissa bits), and 2^-9 below the normals.
        step = 1.0 if qmax == tq.INT8_MAX else np.maximum(
            np.abs(want) / 8, 2.0 ** -9)
        assert (np.abs(got - want) <= step).all()
        assert (got == want).mean() > 0.99


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_prefill_and_decode_match_jax(models, kind):
    """Whole-prompt prefill of one sequence, two chunked windows of another
    (quant errors included), then two ragged decode steps over both."""
    jcfg, jparams, cfg, model = models
    jcache = jinit_cache(jcfg, NUM_BLOCKS, BS, kv_dtype=kind)
    tcache = init_paged_cache(cfg, NUM_BLOCKS, BS, kv_dtype=kind,
                              device="cpu")
    assert tcache.quantized and tcache.k.dtype == KINDS[kind][0]
    assert tcache.scale_bytes == jcache.scale_bytes
    assert tcache.pool_bytes == jcache.pool_bytes
    tables = np.array([[3, 7, 1, 0], [4, 8, 9, 10]], np.int32)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :10] = _prompt(10, seed=1)
    jl, jcache, jerr = jpaged.paged_prefill(
        jparams, jnp.asarray(toks), jnp.int32(10), jcfg, jcache,
        jnp.asarray(tables[0]), with_quant_error=True)
    tl, terr = paged_prefill(model, torch.from_numpy(toks), 10, cfg, tcache,
                             torch.from_numpy(tables[0]),
                             with_quant_error=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose([float(e) for e in terr],
                               [float(e) for e in jerr], rtol=1e-4)
    prompt = _prompt(13, seed=2)
    for off in (0, 8):
        clen = min(8, 13 - off)
        w = np.zeros((1, 8), np.int32)
        w[0, :clen] = prompt[off:off + clen]
        jl, jcache, jerr = jpaged.paged_prefill_chunk(
            jparams, jnp.asarray(w), jnp.int32(off), jnp.int32(clen), jcfg,
            jcache, jnp.asarray(tables[1]), with_quant_error=True)
        tl, terr = paged_prefill_chunk(
            model, torch.from_numpy(w), off, clen, cfg, tcache,
            torch.from_numpy(tables[1]), with_quant_error=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose([float(e) for e in terr],
                                   [float(e) for e in jerr], rtol=1e-4)
    _pools_close(jcache, tcache, [3, 7, 1, 4, 8, 9, 10])
    lengths = np.array([10, 13], np.int32)
    token = np.array([17, 42], np.int32)
    for _ in range(2):
        jl, jcache = jpaged.paged_decode_step(
            jparams, jnp.asarray(token), jcfg, jcache, jnp.asarray(tables),
            jnp.asarray(lengths))
        tl = paged_decode_step(model, torch.from_numpy(token), cfg, tcache,
                               torch.from_numpy(tables),
                               torch.from_numpy(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        token = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        lengths = lengths + 1
    _pools_close(jcache, tcache, [3, 7, 1, 4, 8, 9, 10])
    with pytest.raises(ValueError, match="quantized"):
        paged_prefill(model, torch.from_numpy(toks), 10, cfg,
                      init_paged_cache(cfg, 8, BS, device="cpu"),
                      torch.from_numpy(tables[0]), with_quant_error=True)


# ------------------------------------------------------------------ engine
def test_int8_engine_greedy_tokens_match_jax_int8_engine(models):
    jcfg, jparams, cfg, model = models
    prompts = [([5, 7, 9, 11, 2, 4, 6, 8], 8), ([3, 1, 4, 1, 5, 9], 6)]
    kw = dict(block_size=4, num_blocks=24, max_batch=2, max_model_len=32,
              kv_dtype="int8", prefill_chunk=8)
    outs = []
    for eng, req in ((JServeEngine(jparams, jcfg, clock=JClock(tick=0.001),
                                   **kw), JRequest),
                     (ServeEngine(model, cfg, clock=ManualClock(tick=0.001),
                                  device="cpu", **kw), Request)):
        metrics.configure()
        jmetrics.configure()
        for i, (p, n) in enumerate(prompts):
            eng.submit(req(f"r{i}", list(p), n))
        outs.append({d.request_id: d.tokens for d in eng.run_until_idle()})
        assert eng.allocator.in_use == 0
    assert outs[1] == outs[0]
    err = metrics.gauge("tk8s_serve_quant_error")
    assert 0 < err.value(tensor="k") < 0.1 and 0 < err.value(tensor="v") < 0.1
    metrics.configure()
    jmetrics.configure()
