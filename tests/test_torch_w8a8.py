"""W8A8 serving in the port against the JAX package, on the CPU.

The same seeded inputs go through the reference's weight quantization and
quantized arithmetic (``triton_kubernetes_tpu/ops/quantization.py``,
``models/llama.quantize_weights``) and the port's, at ``llama-test`` sizes.
Tolerances:

* per-channel weight quantization, the per-token activation quantizer and
  ``quantize_weights``: bitwise (exact amax, one IEEE division, round half
  to even or fp8's round to nearest even, on the same f32 values);
* ``quantized_einsum`` int8: bitwise (an exact integer sum, the same f32
  epilogue in the same order); fp8: relative L2 <= 1e-6 (the f32 sum of
  fp8 products is taken in another order);
* the W8A8 model's logits on the carried-across tree: relative L2 <= 1e-3
  (int8) and 1e-2 (fp8) -- f32 rounding upstream of a quantizer can move
  an activation across a rounding tie, one quantum; measured 7.6e-8 and
  1.1e-7 on this tree.

Then the engine: ``matmul_dtype`` auto is the f32 path off a TPU (bitwise
tokens), W8A8 composes with speculation, the prefix cache and preemption
without leaking pages and deterministically, and its greedy tokens are the
JAX engine's; the refusals; ``generate``/``decode_step`` against the
reference's greedy tokens, and paged decode's tokens against ``generate``'s.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu.models import llama as jllama
from triton_kubernetes_tpu.ops import quantization as jq
from triton_kubernetes_tpu.serve import ManualClock as JClock
from triton_kubernetes_tpu.serve import Request as JRequest
from triton_kubernetes_tpu.serve import ServeEngine as JServeEngine
from triton_kubernetes_tpu.utils import metrics as jmetrics
from triton_kubernetes_tpu_torch.models import (
    QuantizedWeight,
    from_numpy_params,
    generate,
    get_config,
    init_params,
    quantize_weights,
    to_numpy_params,
)
from triton_kubernetes_tpu_torch.models import llama
from triton_kubernetes_tpu_torch.ops import quantization as q
from triton_kubernetes_tpu_torch.serve import ManualClock, Request, ServeEngine
from triton_kubernetes_tpu_torch.train import quantize_for_decode
from triton_kubernetes_tpu_torch.utils import metrics

jgenerate = importlib.import_module("triton_kubernetes_tpu.models.generate")
DTYPES = {"int8": (jnp.int8, torch.int8),
          "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
# The serving matmuls' specs as the models contract them (the reference
# test's _ARITH_SPECS).
ARITH_SPECS = {"wq": "bsd,dhk->bshk", "wo": "bshk,hkd->bsd",
               "w1": "bsd,df->bsf", "w2": "bsf,fd->bsd",
               "lm_head": "bsd,dv->bsv"}


def _bytes(a) -> np.ndarray:
    """An array's bytes, one-byte dtypes (int8, fp8) compared as uint8."""
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(autouse=True)
def fresh_registries():
    metrics.configure()
    jmetrics.configure()
    yield
    metrics.configure()
    jmetrics.configure()


@pytest.fixture(scope="module")
def trees():
    """The reference's llama-test tree (f32) and the port's model of it."""
    jcfg = jget_config("llama-test")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = from_numpy_params(jax.tree.map(np.asarray, jparams),
                              get_config("llama-test"), device="cpu")
    return (jparams, jcfg), model


# ------------------------------------------------------------- op level
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("axis", [0, (0, 1), 2])
def test_quantize_channelwise_is_bitwise_the_reference(dtype, axis):
    jdt, tdt = DTYPES[dtype]
    x = (np.random.default_rng(3).standard_normal((16, 8, 24))
         * np.array([1e-3, 1.0, 30.0] * 8, np.float32)).astype(np.float32)
    x[:, 2, :] = 0.0  # an all-zero channel takes the scale floor
    jq_, js = jq.quantize_channelwise(jnp.asarray(x), axis, jdt)
    tq, ts = q.quantize_channelwise(torch.from_numpy(x), axis, tdt)
    np.testing.assert_array_equal(_bytes(jq_), _bytes(tq.view(torch.uint8)))
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    if dtype == "int8":
        iq, is_ = q.quantize_int8(torch.from_numpy(x), axis)
        assert torch.equal(iq, tq) and torch.equal(is_, ts)
        np.testing.assert_array_equal(
            np.asarray(jq.dequantize_int8(jq_, js, jnp.float32)),
            q.dequantize_int8(tq, ts, torch.float32).numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_rows_plain_is_the_reference_activation_quantizer(dtype):
    """The per-token quantizer (kernel A's plain version) gives the bytes
    and scales ``quantized_einsum`` makes of its activation."""
    jdt, tdt = DTYPES[dtype]
    x = (3 * np.random.default_rng(4).standard_normal((6, 64))
         ).astype(np.float32)
    x[1] = 0.0
    amax = jnp.max(jnp.abs(jnp.asarray(x)), axis=-1, keepdims=True)
    js = jnp.maximum(amax / jq.qmax_for(jdt), jq.MIN_SCALE)
    jxq = jq.quantize_with_scale(jnp.asarray(x), js, jdt)
    txq, ts = q.quantize_rows_plain(torch.from_numpy(x), tdt)
    np.testing.assert_array_equal(_bytes(jxq), _bytes(txq.view(torch.uint8)))
    np.testing.assert_array_equal(np.asarray(js)[:, 0], ts.numpy())
    assert q.quantize_rows(torch.from_numpy(x), tdt)[1].shape == (6,)


def _arith_case(name, dtype, trees):
    """Layer 0's leaf ``name`` of the reference's quantized tree, a seeded
    f32 input for its spec, and both packages' ``quantized_einsum``."""
    (jparams, jcfg), _ = trees
    qparams, _ = jllama.quantize_weights(jparams, jcfg, dtype)
    leaf = (qparams["lm_head"] if name == "lm_head" else
            {k: v[0] for k, v in qparams["layers"][name].items()})
    spec = ARITH_SPECS[name]
    w_sub = spec.split(",")[1].split("->")[0]
    dims = {"b": 2, "s": 8, **dict(zip(w_sub, leaf["q"].shape))}
    x = np.random.default_rng(3).standard_normal(
        tuple(dims[c] for c in spec.split(",")[0])).astype(np.float32)
    want = np.asarray(jq.quantized_einsum(spec, jnp.asarray(x), leaf["q"],
                                          leaf["scale"]))
    tq = torch.from_numpy(_bytes(leaf["q"]).copy()).view(DTYPES[dtype][1])
    got = q.quantized_einsum(spec, torch.from_numpy(x), tq,
                             torch.from_numpy(np.array(leaf["scale"])))
    return got.numpy(), want


@pytest.mark.parametrize("name", sorted(ARITH_SPECS))
def test_quantized_einsum_int8_is_bitwise_the_reference(name, trees):
    got, want = _arith_case(name, "int8", trees)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(ARITH_SPECS))
def test_quantized_einsum_fp8_matches_the_reference(name, trees):
    got, want = _arith_case(name, "fp8", trees)
    assert rel_l2(got, want) <= 1e-6, rel_l2(got, want)


def test_quantized_einsum_epilogue_fold_exact():
    """On inputs whose every intermediate is exact (small-int operands,
    power-of-two scales, the activation scale anchored at 2^-2), the
    W8A8 product is bitwise the dequantize-then-f32 einsum -- and the
    reference's."""
    rng = np.random.default_rng(0)
    d, f = 16, 8
    qw = rng.integers(-8, 8, (d, f)).astype(np.int8)
    scale = (2.0 ** rng.integers(-3, 1, (1, f))).astype(np.float32)
    xi = rng.integers(-127, 128, (2, 4, d))
    xi[:, :, 0] = 127
    x = (xi * 2.0 ** -2).astype(np.float32)
    ref = np.einsum("bsd,df->bsf", x, qw.astype(np.float32) * scale)
    got = q.quantized_einsum("bsd,df->bsf", torch.from_numpy(x),
                             torch.from_numpy(qw), torch.from_numpy(scale))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jq.quantized_einsum("bsd,df->bsf", jnp.asarray(x), jnp.asarray(qw),
                            jnp.asarray(scale))))


def test_quantized_einsum_validates_spec_and_scale():
    x = torch.ones((2, 4))
    qw = torch.ones((4, 8), dtype=torch.int8)
    ok = torch.ones((1, 8))
    with pytest.raises(ValueError, match="contraction"):
        q.quantized_einsum("ab,cd->abcd", x, qw, ok)
    with pytest.raises(ValueError, match="scale"):
        q.quantized_einsum("ab,bc->ac", x, qw, torch.ones((4, 8)))
    with pytest.raises(ValueError, match="weight matmul"):
        q.quantized_einsum("ab,bc->ca", x, qw, ok)
    with pytest.raises(ValueError, match="repeats"):
        q._parse_weight_spec("abb,bc->ac")


def test_resolve_matmul_dtype_table():
    """The reference's table: auto is quantized arithmetic only on a TPU
    over quantized storage; the port runs on "gpu" or "cpu", where auto is
    the f32 path; explicit int8/fp8 need matching storage."""
    r = q.resolve_matmul_dtype
    assert r("f32", "int8", "tpu") == "f32"
    assert r("auto", "int8", "tpu") == "int8"
    assert r("auto", "int8", "cpu") == r("auto", "fp8", "gpu") == "f32"
    assert r("auto", "none", "tpu") == "f32"
    assert r("int8", "int8", "cpu") == "int8"
    assert r("fp8", "fp8", "gpu") == "fp8"
    with pytest.raises(ValueError, match="weight"):
        r("int8", "none", "tpu")
    with pytest.raises(ValueError, match="weight"):
        r("fp8", "int8", "gpu")
    with pytest.raises(ValueError, match="matmul_dtype"):
        r("bf16", "none", "cpu")
    for mode, wq in (("f32", "int8"), ("auto", "fp8"), ("int8", "int8")):
        assert r(mode, wq, "cpu") == jq.resolve_matmul_dtype(mode, wq, "cpu")
    assert q.fp8_supported() and q.fp8_dtype() == torch.float8_e4m3fn


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_w8a8_gemm_group_plain_is_quantized_einsum(dtype):
    """The group's plain version on K-contiguous weights is
    ``quantized_einsum`` of each weight: bitwise."""
    tdt = DTYPES[dtype][1]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    pairs = [q.quantize_channelwise(torch.from_numpy(
        0.02 * rng.standard_normal((64, n)).astype(np.float32)), 0, tdt)
        for n in (32, 48)]
    ys = q.w8a8_rows(x, [w.t().contiguous() for w, _ in pairs],
                     [s.reshape(-1) for _, s in pairs], torch.float32)
    for y, (w, s) in zip(ys, pairs):
        assert torch.equal(y, q.quantized_einsum("md,dn->mn", x, w, s))


# ----------------------------------------------------------- model level
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_weights_is_bitwise_the_reference(dtype, trees):
    """The port's quantize_weights of the same f32 tree gives the
    reference's q and scale leaves bit for bit (to_numpy_params gives
    them back in the reference's layouts); the caller's model is
    untouched, the result is idempotent, and another dtype raises."""
    (jparams, jcfg), model = trees
    before = to_numpy_params(model)
    jtree, jqcfg = jllama.quantize_weights(jparams, jcfg, dtype)
    qmodel = quantize_weights(model, dtype)
    assert qmodel.config.weight_quant == jqcfg.weight_quant == dtype
    got = to_numpy_params(qmodel)
    names = sorted(llama.QUANT_CONTRACT)
    assert sorted(jllama._QUANT_AXES_LAYERS.keys() & got["layers"].keys()
                  ) == names
    for name in names:
        for k in ("q", "scale"):
            np.testing.assert_array_equal(
                _bytes(got["layers"][name][k]),
                _bytes(jtree["layers"][name][k]), err_msg=f"{name}.{k}")
    for k in ("q", "scale"):
        np.testing.assert_array_equal(_bytes(got["lm_head"][k]),
                                      _bytes(jtree["lm_head"][k]))
    np.testing.assert_array_equal(got["embed"], np.asarray(jtree["embed"]))
    after = to_numpy_params(model)
    assert all(np.array_equal(before["layers"][n], after["layers"][n])
               for n in before["layers"])
    assert isinstance(model.layers[0].wq, torch.nn.Parameter)
    assert quantize_weights(qmodel, dtype) is qmodel
    with pytest.raises(ValueError, match="already"):
        quantize_weights(qmodel, "fp8" if dtype == "int8" else "int8")
    with pytest.raises(ValueError, match="int8"):
        quantize_weights(model, "fp16")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_numpy_params_carry_the_reference_quantized_tree(dtype, trees):
    """from_numpy_params takes the reference's quantized tree (fp8 as
    ml_dtypes.float8_e4m3fn, or as its uint8 bytes) into
    QuantizedWeight leaves stored [N, K]; to_numpy_params gives back the
    same bytes in the reference's layouts."""
    (jparams, jcfg), _ = trees
    jtree, _ = jllama.quantize_weights(jparams, jcfg, dtype)
    tree = jax.tree.map(np.asarray, jtree)
    cfg = get_config("llama-test", weight_quant=dtype)
    model = from_numpy_params(tree, cfg, device="cpu")
    wq = model.layers[1].wq
    assert isinstance(wq, QuantizedWeight)
    assert wq.q.shape == (cfg.num_heads * cfg.head_dim, cfg.embed_dim)
    assert wq.q.is_contiguous() and wq.q.dtype == DTYPES[dtype][1]
    back = to_numpy_params(model)
    for name in llama.QUANT_CONTRACT:
        for k in ("q", "scale"):
            np.testing.assert_array_equal(_bytes(back["layers"][name][k]),
                                          _bytes(tree["layers"][name][k]))
    if dtype == "fp8":
        assert tree["lm_head"]["q"].dtype == ml_dtypes.float8_e4m3fn
        as_bytes = dict(tree, lm_head=dict(
            tree["lm_head"], q=tree["lm_head"]["q"].view(np.uint8)))
        again = from_numpy_params(as_bytes, cfg, device="cpu")
        assert torch.equal(again.lm_head.q.view(torch.uint8),
                           model.lm_head.q.view(torch.uint8))
    with pytest.raises(ValueError, match="weight_quant"):
        from_numpy_params(tree, get_config("llama-test"), device="cpu")
    with pytest.raises(ValueError, match="train"):
        from_numpy_params(tree, cfg, device="cpu", trainable=True)


@pytest.mark.parametrize("dtype,bound", [("int8", 1e-3), ("fp8", 1e-2)])
def test_w8a8_logits_match_the_reference(dtype, bound, trees):
    """The W8A8 forward of the carried-across tree against the
    reference's: int8 within 1e-3, fp8 within 1e-2 relative L2 (measured
    7.6e-8 and 1.1e-7); the dequantize path (matmul_dtype f32) within
    1e-5."""
    (jparams, jcfg), _ = trees
    jtree, jqcfg = jllama.quantize_weights(jparams, jcfg, dtype)
    model = from_numpy_params(jax.tree.map(np.asarray, jtree),
                              get_config("llama-test", weight_quant=dtype),
                              device="cpu")
    toks = np.random.default_rng(0).integers(0, 256, (2, 12)).astype(
        np.int32)
    for mode, tol in ((dtype, bound), ("f32", 1e-5)):
        want, _ = jllama.forward(jtree, jnp.asarray(toks),
                                 dataclasses.replace(jqcfg,
                                                     matmul_dtype=mode))
        cfg = get_config("llama-test", weight_quant=dtype, matmul_dtype=mode)
        got, _ = llama.forward(model, torch.from_numpy(toks), cfg)
        assert rel_l2(got.numpy(), want) <= tol, (mode, rel_l2(got, want))


def test_quantized_models_serve_and_do_not_train(trees):
    _, model = trees
    qmodel = quantize_weights(model, "int8")
    with pytest.raises(ValueError, match="train"):
        llama.Llama(qmodel.config, "cpu", trainable=True)
    full = init_params(get_config("llama-test"), seed=1, device="cpu")
    direct = init_params(get_config("llama-test", weight_quant="fp8"),
                         seed=1, device="cpu")
    assert torch.equal(direct.lm_head.q.view(torch.uint8),
                       quantize_weights(full, "fp8").lm_head.q.view(
                           torch.uint8))
    got, want = quantize_for_decode(model, model.config, "auto")
    assert got is model and want is model.config
    qm, qcfg = quantize_for_decode(model, model.config, "int8")
    assert qcfg.weight_quant == qm.config.weight_quant == "int8"
    with pytest.raises(KeyError, match="weight_dtype"):
        quantize_for_decode(model, model.config, "fp4")


# ---------------------------------------------------------------- engine
def _engine(model, **kw):
    base = dict(block_size=4, num_blocks=24, max_batch=3, max_model_len=48,
                device="cpu", clock=ManualClock(tick=0.001))
    return ServeEngine(model, model.config, **dict(base, **kw))


def _solo(model, prompt, n, **kw):
    eng = _engine(model, **kw)
    eng.submit(Request("solo", list(prompt), n))
    (done,) = eng.run_until_idle()
    return done.tokens


def test_matmul_dtype_auto_is_f32_bitwise_on_cpu(trees):
    _, model = trees
    prompt, n = [5, 7, 9, 11, 2, 4], 6
    base = _solo(model, prompt, n, weight_dtype="int8")
    assert base == _solo(model, prompt, n, weight_dtype="int8",
                         matmul_dtype="auto")
    assert base == _solo(model, prompt, n, weight_dtype="int8",
                         matmul_dtype="f32")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_w8a8_engine_composes_with_serving_features(dtype, trees):
    """W8A8 with speculation (spec_k 2), chunked prefill, the prefix cache
    and a pool tight enough to preempt: every request completes, no page
    leaks, two runs give the same tokens, spec-on tokens equal spec-off,
    and the stats report the arithmetic."""
    _, model = trees
    prompts = [([5, 7, 9, 11, 2, 4, 6, 8, 1, 3], 12),
               ([5, 7, 9, 11, 2, 4, 6, 8, 9, 9], 12),
               ([3, 3, 3, 3, 3, 3], 12)]

    def run(spec_k):
        eng = _engine(model, weight_dtype=dtype, matmul_dtype=dtype,
                      spec_k=spec_k, prefill_chunk=4, prefix_cache=True,
                      num_blocks=12)
        for i, (p, n) in enumerate(prompts):
            eng.submit(Request(f"r{i}", list(p), n))
        done = {d.request_id: d for d in eng.run_until_idle()}
        eng.release_prefix_cache()
        assert eng.allocator.in_use == 0, "leaked KV pages"
        return eng, done

    eng, a = run(2)
    _, b = run(2)
    _, off = run(0)
    assert any(d.preemptions for d in a.values()), "no preemption: vacuous"
    for rid, d in a.items():
        assert len(d.tokens) == 12
        assert d.tokens == b[rid].tokens == off[rid].tokens, rid
    st = eng.stats()
    assert st["matmul_dtype"] == st["weight_dtype"] == dtype
    assert eng.config.weight_quant == dtype
    assert isinstance(eng.params.layers[0].wq, QuantizedWeight)
    assert isinstance(model.layers[0].wq, torch.nn.Parameter)  # untouched


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_w8a8_engine_tokens_match_the_jax_engine(dtype, trees):
    (jparams, jcfg), model = trees
    kw = dict(block_size=4, num_blocks=24, max_batch=2, max_model_len=32,
              weight_dtype=dtype, matmul_dtype=dtype, prefill_chunk=8,
              prefix_cache=True)
    jeng = JServeEngine(jparams, jcfg, clock=JClock(tick=0.001), **kw)
    eng = ServeEngine(model, model.config, device="cpu",
                      clock=ManualClock(tick=0.001), **kw)
    for e, req in ((jeng, JRequest), (eng, Request)):
        e.submit(req("a", [5, 7, 9, 11, 2, 4, 6, 8, 1, 3], 10))
        e.submit(req("b", [2, 2, 2], 6))
    want = {d.request_id: d.tokens for d in jeng.run_until_idle()}
    got = {d.request_id: d.tokens for d in eng.run_until_idle()}
    assert got == want


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantizing_seams_keep_the_serving_logits(dtype, monkeypatch):
    """The serving steps hand every W8A8 product but wo's the rows that
    their producer quantized (the norms' quantizing entries, the fused
    SwiGLU). On the CPU (bf16 llama-test, W8A8) a prefill window's, a
    decode step's and a verify step's logits are bitwise those of the
    composition before the seams -- the producers' bf16 rows, then the
    standalone quantizer -- and each seam ran as often as the steps need
    it: the first norm once, the boundaries twice a layer, the SwiGLU once
    a layer, the standalone quantizer once a layer (wo's input)."""
    from triton_kubernetes_tpu_torch.models import paged
    from triton_kubernetes_tpu_torch.ops import norms

    cfg = get_config("llama-test", dtype="bfloat16", weight_quant=dtype,
                     matmul_dtype=dtype)
    model = quantize_weights(init_params(get_config("llama-test",
                                                    dtype="bfloat16"),
                                         seed=3, device="cpu"), dtype)
    table = torch.arange(1, 9, dtype=torch.int32)

    def steps():
        cache = paged.init_paged_cache(cfg, 9, 4, device="cpu")
        toks = torch.tensor([[5, 7, 9, 11, 2, 4, 6, 8, 1, 3] + [0] * 6],
                            dtype=torch.int32)
        window = paged.paged_prefill_chunk(model, toks, 0, 10, cfg, cache,
                                           table)
        lens = torch.tensor([10], dtype=torch.int32)
        decode = paged.paged_decode_step(model, torch.tensor(
            [6], dtype=torch.int32), cfg, cache, table[None], lens)
        verify, _ = paged.paged_verify_step(model, torch.tensor(
            [[6, 2, 9]], dtype=torch.int32), cfg, cache, table[None],
            lens + 1)
        return window, decode, verify

    seams = {"rms_norm_quant_rows": (paged, 0), "add_rms_norm_quant_rows":
             (paged, 0), "swiglu_quantize_rows": (llama, 0),
             "quantize_rows": (q, 0)}
    for name, (mod, _) in seams.items():
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name):
            seams[_name] = (seams[_name][0], seams[_name][1] + 1)
            return _fn(*a)
        monkeypatch.setattr(mod, name, counted)
    fused = steps()
    runs = 3  # a window, a decode step and a verify step
    layers = cfg.num_layers
    assert {k: n for k, (_, n) in seams.items()} == {
        "rms_norm_quant_rows": runs, "add_rms_norm_quant_rows":
        2 * layers * runs, "swiglu_quantize_rows": layers * runs,
        "quantize_rows": layers * runs}
    monkeypatch.setattr(paged, "rms_norm_quant_rows",
                        lambda x, s, eps, dt: norms.rms_norm_rows(x, s, eps))
    monkeypatch.setattr(paged, "add_rms_norm_quant_rows",
                        lambda x, d, s, eps, dt: norms.add_rms_norm_rows(
                            x, d, s, eps))
    monkeypatch.setattr(llama, "swiglu_quantize_rows",
                        lambda g, u, dt: q.swiglu(g, u))
    unfused = steps()
    for a, b in zip(fused, unfused):
        assert torch.equal(a, b)


def test_engine_refuses_mismatched_weights_and_unknown_dtypes(trees):
    _, model = trees
    with pytest.raises(ValueError, match="matmul_dtype"):
        _engine(model, matmul_dtype="int8")
    with pytest.raises(ValueError, match="matmul_dtype"):
        _engine(model, weight_dtype="fp8", matmul_dtype="int8")
    with pytest.raises(ValueError, match="matmul_dtype"):
        _engine(model, matmul_dtype="bf16")
    with pytest.raises(KeyError, match="weight_dtype"):
        _engine(model, weight_dtype="fp4")
    assert _engine(model, matmul_dtype="auto").matmul_dtype == "auto"


# ------------------------------------------------------ generate, decode
def test_generate_matches_the_reference_greedy_tokens(trees):
    (jparams, jcfg), model = trees
    prompt = np.random.default_rng(8).integers(0, 256, (2, 7)).astype(
        np.int32)
    want = jgenerate.generate(jparams, jnp.asarray(prompt), jcfg, 9)
    got = generate(model, torch.from_numpy(prompt), model.config, 9)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert not got["done"].any()


def test_decode_step_logits_match_the_reference(trees):
    from triton_kubernetes_tpu_torch.models import decode_step, init_cache
    from triton_kubernetes_tpu_torch.models import prefill

    (jparams, jcfg), model = trees
    prompt = np.random.default_rng(9).integers(0, 256, (2, 5)).astype(
        np.int32)
    jcache = jgenerate.init_cache(jcfg, 2, 8)
    _, jcache = jgenerate.prefill(jparams, jnp.asarray(prompt), jcfg, jcache)
    cache = init_cache(model.config, 2, 8, device="cpu")
    _, cache = prefill(model, torch.from_numpy(prompt), model.config, cache)
    tok = np.array([3, 17], np.int32)
    for _ in range(3):
        want, jcache = jgenerate.decode_step(jparams, jnp.asarray(tok), jcfg,
                                             jcache)
        got, cache = decode_step(model, torch.from_numpy(tok), model.config,
                                 cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        tok = np.asarray(want).argmax(-1).astype(np.int32)
    assert cache.length == int(jcache.length) == 8
    with pytest.raises(ValueError, match="full"):
        decode_step(model, torch.from_numpy(tok), model.config, cache)


@pytest.mark.parametrize("weights", [None, "int8"])
def test_paged_decode_tokens_equal_generate(weights, trees):
    """The engine's greedy tokens (paged prefill windows, paged decode)
    equal the contiguous-cache loop's, unquantized and under W8A8 int8."""
    _, model = trees
    if weights:
        model = quantize_weights(model, weights)
    cfg = dataclasses.replace(model.config, matmul_dtype=weights or "auto")
    prompt = [int(t) for t in np.random.default_rng(10).integers(0, 256, 11)]
    want = generate(model, torch.tensor([prompt]), cfg, 10)["tokens"][0]
    eng = ServeEngine(model, cfg, block_size=4, num_blocks=16, max_batch=2,
                      max_model_len=32, prefill_chunk=8, device="cpu",
                      matmul_dtype=weights or "auto")
    eng.submit(Request("g", prompt, 10))
    (done,) = eng.run_until_idle()
    assert done.tokens == want.tolist()


def test_generate_eos_sticks_and_length_is_checked(trees):
    _, model = trees
    prompt = torch.tensor([[5, 7, 9]])
    first = generate(model, prompt, model.config, 4)["tokens"][0].tolist()
    out = generate(model, prompt, model.config, 4, eos_id=first[1])
    assert out["tokens"][0].tolist()[1:] == [first[1]] * 3
    assert bool(out["done"][0])
    with pytest.raises(ValueError, match="max_seq_len"):
        generate(model, prompt, model.config, model.config.max_seq_len)
