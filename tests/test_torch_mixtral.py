"""Port parity for the Mixtral MoE family at ``mixtral-test`` (E 4, K 2,
f32) on the CPU.

The JAX package's ``init_params(PRNGKey(0))`` weights carried over by
``from_numpy_params``, then through both packages on the same tokens:
``forward`` logits and aux at the tolerance ``tests/test_torch_models.py``
holds ``llama-test`` to (1e-4; aux 1e-5 relative), with drops (cf 1.25)
and dropless, in both dispatches; two AdamW steps against the reference's
train step (loss, aux, gradient norm, every updated parameter: the
tolerances of ``tests/test_torch_train.py``; the first step's rate is 0,
so the second is the one that moves them) and the remat policies'
gradients bitwise each other's; the paged prefill windows, the
whole-prompt prefill, decode and verify steps with dropless capacity
(logits and pages at 1e-4); quantized MoE leaves, one scale per (expert,
output column), bitwise the reference's, and their logits within 0.2 of
full precision (the reference's own pin). Then the port's own entry
points: the layout round trip, ``generate``'s dropless check, the serving
engine (greedy tokens equal ``generate``'s, speculation on equal off,
unquantized and under W8A8 int8),
the trainer with ``--expert 1`` (and ``--expert 2`` a config error on
one process), and a
checkpoint that restores the MoE leaves by name.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_paged_cache as jinit_cache
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu.models import llama as jllama
from triton_kubernetes_tpu.models import paged as jpaged
from triton_kubernetes_tpu.parallel import MeshConfig, create_mesh
from triton_kubernetes_tpu.train import trainer as jtrainer
from triton_kubernetes_tpu_torch.models import (
    from_numpy_params,
    generate,
    get_config,
    init_paged_cache,
    init_params,
    llama,
    mixtral,
    paged_decode_step,
    paged_prefill,
    paged_prefill_chunk,
    paged_verify_step,
    quantize_weights,
    to_numpy_params,
)
from triton_kubernetes_tpu_torch.train import (
    make_optimizer,
    make_train_step,
    state_for,
    synthetic_batches,
)
from triton_kubernetes_tpu_torch.train.__main__ import main as train_main

TOL = dict(rtol=1e-4, atol=1e-4)
REL = dict(rtol=1e-5, atol=1e-6)
DROPLESS = 2.0  # E / K for mixtral-test
BS, NUM_BLOCKS = 4, 24


def _tree(x):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), x)


@pytest.fixture(scope="module")
def jparams():
    return _tree(jinit_params(jget_config("mixtral-test"),
                              jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def models(jparams):
    jcfg = jget_config("mixtral-test", capacity_factor=DROPLESS)
    cfg = get_config("mixtral-test", capacity_factor=DROPLESS)
    return jcfg, jparams, cfg, from_numpy_params(jparams, cfg, device="cpu")


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _at(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _bytes(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


@pytest.mark.parametrize("overrides", [
    {}, {"moe_dispatch": "sort"}, {"capacity_factor": DROPLESS}])
def test_forward_logits_and_aux_match_jax(jparams, overrides):
    jcfg = jget_config("mixtral-test", **overrides)
    cfg = get_config("mixtral-test", **overrides)
    model = from_numpy_params(jparams, cfg, device="cpu")
    toks = _tokens((2, 16))
    want, jaux = jllama.forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = llama.forward(model, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # Two layers, each at least 0.99 (the reference test's floor).
    assert 1.98 <= float(aux) <= 2 * cfg.num_experts


def test_two_adamw_steps_match_the_reference_train_step():
    jcfg = jget_config("mixtral-test")
    cfg = get_config("mixtral-test")
    mesh = create_mesh(MeshConfig(fsdp=1), devices=jax.devices()[:1])
    jopt = jtrainer.make_optimizer(learning_rate=1e-2, warmup_steps=1,
                                   decay_steps=100)
    jstate = jtrainer.init_state(jcfg, mesh, jopt)
    jstep = jtrainer.make_train_step(jcfg, mesh, jopt)
    model = from_numpy_params(_tree(jstate.params), cfg, device="cpu",
                              trainable=True)
    opt = make_optimizer(learning_rate=1e-2, warmup_steps=1,
                         decay_steps=100)
    state = state_for(model, opt)
    step = make_train_step(cfg, opt)
    batches = synthetic_batches(cfg.vocab_size, 2, 16, seed=3)
    for _ in range(2):
        batch = next(batches)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        state, m = step(state, batch)
        for key in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    got = to_numpy_params(state.model)
    for path, want in jax.tree_util.tree_leaves_with_path(
            _tree(jstate.params)):
        np.testing.assert_allclose(_at(got, path), want, err_msg=str(path),
                                   **REL)


@pytest.mark.parametrize("dispatch", ["dense", "sort"])
def test_remat_policies_give_the_same_gradients(jparams, dispatch):
    """none, full and dots recompute an MoE block differently but compute
    the same function (the routing included): gradients bitwise in f32 on
    the CPU."""
    from triton_kubernetes_tpu_torch.train import loss_fn

    grads = []
    tokens = torch.from_numpy(next(synthetic_batches(256, 2, 16))["tokens"])
    for policy in ("none", "full", "dots"):
        cfg = get_config("mixtral-test", remat=policy != "none",
                         remat_policy=policy, moe_dispatch=dispatch)
        model = from_numpy_params(jparams, cfg, device="cpu", trainable=True)
        total, _ = loss_fn(model, tokens, cfg)
        total.backward()
        grads.append([p.grad for p in model.parameters()])
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def _pools_close(jcache, tcache, pages):
    for j, t in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
        np.testing.assert_allclose(t[:, pages].numpy(),
                                   np.asarray(j)[:, pages], **TOL)


def test_paged_steps_match_jax(models):
    """Two prefill windows of a 13-token prompt (C = 8), a whole-prompt
    prefill of a second sequence, two ragged decode steps over both plus
    an empty slot, then a verify step of 4 tokens a sequence: logits and
    the pages written."""
    jcfg, jparams, cfg, model = models
    jcache = jinit_cache(jcfg, NUM_BLOCKS, BS)
    tcache = init_paged_cache(cfg, NUM_BLOCKS, BS, device="cpu")
    tables = np.array([[5, 2, 9, 11, 0, 0], [3, 7, 1, 0, 0, 0],
                       [0, 0, 0, 0, 0, 0]], np.int32)
    prompt = _tokens(13, seed=4)
    for off in (0, 8):
        clen = min(8, 13 - off)
        toks = np.zeros((1, 8), np.int32)
        toks[0, :clen] = prompt[off:off + clen]
        jl, jcache = jpaged.paged_prefill_chunk(
            jparams, jnp.asarray(toks), jnp.int32(off), jnp.int32(clen),
            jcfg, jcache, jnp.asarray(tables[0, :4]))
        tl = paged_prefill_chunk(model, torch.from_numpy(toks), off, clen,
                                 cfg, tcache, torch.from_numpy(tables[0, :4]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    toks = np.zeros((1, 12), np.int32)
    toks[0, :10] = _tokens(10, seed=5)
    jl, jcache = jpaged.paged_prefill(jparams, jnp.asarray(toks),
                                      jnp.int32(10), jcfg, jcache,
                                      jnp.asarray(tables[1, :3]))
    tl = paged_prefill(model, torch.from_numpy(toks), 10, cfg, tcache,
                       torch.from_numpy(tables[1, :3]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    lengths = np.array([13, 10, 0], np.int32)
    token = np.array([17, 42, 0], np.int32)
    for _ in range(2):
        jl, jcache = jpaged.paged_decode_step(
            jparams, jnp.asarray(token), jcfg, jcache, jnp.asarray(tables),
            jnp.asarray(lengths))
        tl = paged_decode_step(model, torch.from_numpy(token), cfg, tcache,
                               torch.from_numpy(tables),
                               torch.from_numpy(lengths))
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **TOL)
        token = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        token[2] = 0
        lengths = lengths + np.array([1, 1, 0], np.int32)
    vt = np.stack([np.concatenate([token[:1], _tokens(3, seed=6)]),
                   np.concatenate([token[1:2], _tokens(3, seed=7)])])
    jl, jcache, _ = jpaged.paged_verify_step(
        jparams, jnp.asarray(vt), jcfg, jcache, jnp.asarray(tables[:2]),
        jnp.asarray(lengths[:2]))
    tl, _ = paged_verify_step(model, torch.from_numpy(vt), cfg, tcache,
                              torch.from_numpy(tables[:2]),
                              torch.from_numpy(lengths[:2]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _pools_close(jcache, tcache, [5, 2, 9, 11, 3, 7, 1])


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_moe_leaves_match_jax(models, dtype):
    """q bytes and scales of every quantized leaf equal the reference's
    (the expert weights with a scale per expert and output column), the
    router stays full precision, the reference's quantized tree loads
    into the same leaves, and the logits stay within 0.2 of full
    precision (the reference's pin) and within 1e-4 of the reference's
    quantized forward."""
    jcfg, jparams, cfg, model = models
    jtree, jqcfg = jllama.quantize_weights(jparams, jcfg, dtype)
    qmodel = quantize_weights(model, dtype)
    got = to_numpy_params(qmodel)
    names = sorted(llama.quantized_leaves(cfg))
    assert {"moe_w1", "moe_w3", "moe_w2"} <= set(names)
    for name in names:
        for k in ("q", "scale"):
            np.testing.assert_array_equal(
                _bytes(got["layers"][name][k]),
                _bytes(jtree["layers"][name][k]), err_msg=f"{name}.{k}")
    assert got["layers"]["moe_w1"]["scale"].shape == (
        cfg.num_layers, cfg.num_experts, 1, cfg.mlp_dim)
    np.testing.assert_array_equal(got["layers"]["router"],
                                  jparams["layers"]["router"])
    assert isinstance(qmodel.layers[0].router, torch.nn.Parameter)
    loaded = from_numpy_params(jax.tree.map(np.asarray, jtree),
                               get_config("mixtral-test",
                                          capacity_factor=DROPLESS,
                                          weight_quant=dtype), device="cpu")
    back = to_numpy_params(loaded)
    for name in names:
        np.testing.assert_array_equal(_bytes(back["layers"][name]["q"]),
                                      _bytes(got["layers"][name]["q"]))
    toks = _tokens((1, 8), seed=8)
    full, _ = llama.forward(model, torch.from_numpy(toks), cfg)
    quant, _ = llama.forward(qmodel, torch.from_numpy(toks), qmodel.config)
    want, _ = jllama.forward(jtree, jnp.asarray(toks), jqcfg)
    np.testing.assert_allclose(quant.numpy(), full.numpy(), atol=0.2)
    np.testing.assert_allclose(quant.numpy(), np.asarray(want), **TOL)


def test_numpy_params_round_trip_and_layout(jparams):
    cfg = get_config("mixtral-test")
    model = from_numpy_params(jparams, cfg, device="cpu", trainable=True)
    back = to_numpy_params(model)
    for path, want in jax.tree_util.tree_leaves_with_path(jparams):
        np.testing.assert_array_equal(_at(back, path), want)
    layer = model.layers[0]
    assert layer.moe_w1.shape == (4, 64, 128)
    assert layer.moe_w2.shape == (4, 128, 64)
    assert layer.router.shape == (64, 4)
    assert not hasattr(layer, "w1")
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params()
    serving = from_numpy_params(jparams, get_config(
        "mixtral-test", dtype="bfloat16"), device="cpu")
    assert serving.layers[0].moe_w1.dtype == torch.bfloat16
    assert serving.layers[0].router.dtype == torch.float32
    fresh = mixtral.init_params(mixtral.config_8x7b(num_layers=1,
                                                    embed_dim=64,
                                                    mlp_dim=32,
                                                    num_heads=4,
                                                    num_kv_heads=2,
                                                    head_dim=16,
                                                    vocab_size=128),
                                seed=0, device="cpu")
    assert fresh.layers[0].moe_w3.shape == (8, 64, 32)


def test_generate_needs_dropless_routing(jparams):
    cfg = get_config("mixtral-test")  # capacity_factor 1.25 < E / K
    model = from_numpy_params(jparams, cfg, device="cpu")
    with pytest.raises(ValueError, match="dropless"):
        generate(model, torch.zeros((1, 4), dtype=torch.long), cfg, 4)


@pytest.mark.parametrize("weights", ["auto", "int8"])
def test_serve_engine_tokens_equal_generate(models, weights):
    """The paged engine (prefill windows, ragged decode, and with spec_k 2
    the verify step) gives generate's greedy tokens, unquantized and under
    W8A8 int8 (the attention's products W8A8, the experts' dequantized)."""
    from triton_kubernetes_tpu_torch.serve import (ManualClock, Request,
                                                   ServeEngine)

    _, _, cfg, model = models
    if weights != "auto":
        model = quantize_weights(model, weights)
        cfg = dataclasses.replace(model.config, matmul_dtype=weights)
    prompts = [_tokens(n, seed=10 + n).tolist() for n in (5, 11, 17)]
    want = [generate(model, torch.tensor([p]), cfg, 8)["tokens"][0].tolist()
            for p in prompts]
    for spec_k in (0, 2):
        eng = ServeEngine(model, cfg, device="cpu", block_size=BS,
                          num_blocks=32, max_batch=4, prefill_chunk=8,
                          spec_k=spec_k, matmul_dtype=weights,
                          clock=ManualClock(tick=0.001))
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", p, 8))
        done = {d.request_id: d.tokens for d in eng.run_until_idle()}
        assert [done[f"r{i}"] for i in range(3)] == want, spec_k


def test_trainer_runs_mixtral_with_expert_1(tmp_path):
    report = tmp_path / "run.json"
    ckpt = tmp_path / "ckpt"
    rc = train_main([
        "--model", "mixtral-test", "--expert", "1", "--steps", "3",
        "--batch-size", "2", "--seq-len", "32", "--warmup-steps", "1",
        "--log-every", "1", "--device", "cpu", "--model-opt",
        "attention=flash", "--remat-policy", "full",
        "--checkpoint-dir", str(ckpt), "--report-json", str(report)])
    assert rc == 0
    data = json.loads(report.read_text())
    assert data["steps"] == 3 and data["expert"] == 1
    assert data["moe_dispatch"] == "dense"
    assert data["active_params"] < data["num_params"]
    assert all(np.isfinite(data["losses"] + data["grad_norms"]))
    manifest = json.loads((ckpt / "3" / "manifest.json").read_text())
    assert manifest["mesh"]["axes"]["expert"] == 1
    paths = {leaf["path"] for leaf in manifest["tree"]}
    assert ".model.layers.1.moe_w2" in paths
    assert ".opt_state.mu.layers.0.router" in paths
    # One process drives one device: an expert axis of 2 needs a world
    # of two (tests/test_torch_elastic.py trains it there).
    assert train_main(["--model", "mixtral-test", "--expert", "2",
                       "--device", "cpu", "--steps", "1"]) == 2


def test_checkpoint_restores_moe_leaves_by_name(tmp_path):
    from triton_kubernetes_tpu_torch.train import (CheckpointManager,
                                                   init_state)

    cfg = get_config("mixtral-test")
    opt = make_optimizer(learning_rate=1e-2, warmup_steps=1, decay_steps=10)
    state = init_state(cfg, opt, seed=1, device="cpu")
    step = make_train_step(cfg, opt)
    state, _ = step(state, next(synthetic_batches(cfg.vocab_size, 2, 16)))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, wait=True)
    other = init_state(cfg, opt, seed=2, device="cpu")
    restored = mgr.restore(other)
    assert restored.step == 1
    for (name, p), q in zip(state.model.named_parameters(),
                            restored.model.parameters()):
        assert torch.equal(p, q), name
    for a, b in zip(state.opt_state.mu, restored.opt_state.mu):
        assert torch.equal(a, b)


def test_init_params_draws_the_moe_leaves():
    cfg = get_config("mixtral-test")
    model = init_params(cfg, seed=3, device="cpu")
    layer = model.layers[1]
    assert float(layer.moe_w2.std()) < float(layer.moe_w1.std())
    assert torch.equal(layer.mlp_norm, torch.ones(cfg.embed_dim))
    assert layer.router.dtype == torch.float32
