"""The port's training path against the JAX package's, on the CPU.

The same seeded numpy weights and batches go through both packages:
``fused_cross_entropy``, ``forward``/``forward_hidden`` and ``loss_fn`` on
``llama-test``, the optimizer against optax, and three whole train steps
against ``make_train_step`` on a 1-device mesh, leaf by leaf. Tolerances
(f32 throughout, so only the summation order differs): losses and
activations 1e-5 relative; gradients 1e-5 relative plus 1e-6 absolute
(their sums run over B*S tokens); parameters after three AdamW steps 1e-6
absolute plus 1e-5 relative -- an update is ``lr * mu_hat / (sqrt(nu_hat)
+ eps)``, bounded by ``lr`` per step, and its relative error is the
gradient's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import llama as jllama
from triton_kubernetes_tpu.ops.fused_ce import \
    fused_cross_entropy as jfused_ce
from triton_kubernetes_tpu.parallel import MeshConfig, create_mesh
from triton_kubernetes_tpu.train import data as jdata
from triton_kubernetes_tpu.train.mfu import flops_per_token as jflops
from triton_kubernetes_tpu.train.mfu import mfu as jmfu
from triton_kubernetes_tpu.train import precision as jprecision
from triton_kubernetes_tpu.train import trainer as jtrainer
from triton_kubernetes_tpu_torch.models import get_config, llama
from triton_kubernetes_tpu_torch.ops import flash_attention as fa
from triton_kubernetes_tpu_torch.ops.fused_ce import fused_cross_entropy
from triton_kubernetes_tpu_torch.train import (
    apply_policy,
    flops_per_token,
    init_state,
    loss_fn,
    make_eval_step,
    make_optimizer,
    make_train_step,
    mfu,
    policy_of,
    remat_policy_of,
    run_pipelined,
    state_for,
    synthetic_batches,
)
from triton_kubernetes_tpu_torch.train.__main__ import main as train_main

REL = dict(rtol=1e-5, atol=1e-6)
PARAMS_TOL = dict(rtol=1e-5, atol=1e-6)


def _tree(x):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), x)


@pytest.fixture(scope="module")
def jparams():
    return _tree(jllama.init_params(jget_config("llama-test"),
                                    jax.random.PRNGKey(0)))


def _batch(cfg, b=2, s=16, seed=1):
    return next(jdata.synthetic_batches(cfg.vocab_size, b, s, seed=seed))


# ---- fused cross-entropy -------------------------------------------------

@pytest.mark.parametrize("v,chunk", [(300, 128), (256, 128), (256, 256)])
def test_fused_ce_matches_jax(v, chunk):
    rng = np.random.default_rng(v + chunk)
    t, d = 24, 16
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    tg = rng.integers(0, v, t).astype(np.int32)
    tg[:3] = [v - 1, 0, chunk - 1]  # the padded chunk's last real column
    g = rng.standard_normal(t).astype(np.float32)

    loss_j, vjp = jax.vjp(lambda h_, w_: jfused_ce(h_, w_, jnp.asarray(tg),
                                                   chunk),
                          jnp.asarray(h), jnp.asarray(w))
    dh_j, dw_j = vjp(jnp.asarray(g))

    ht = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss_t = fused_cross_entropy(ht, wt, torch.from_numpy(tg), chunk)
    loss_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(loss_t.detach().numpy(), loss_j, **REL)
    np.testing.assert_allclose(ht.grad.numpy(), dh_j, **REL)
    np.testing.assert_allclose(wt.grad.numpy(), dw_j, **REL)


# ---- forward and loss ----------------------------------------------------

@pytest.mark.parametrize("attention,fused", [
    ("dense", False), ("dense", True), ("flash", False), ("flash", True)])
def test_forward_and_loss_match_jax(jparams, attention, fused):
    jcfg = jget_config("llama-test", attention=attention, fused_ce=fused,
                       ce_chunk=100)
    cfg = get_config("llama-test", attention=attention, fused_ce=fused,
                     ce_chunk=100)
    tokens = _batch(cfg)["tokens"]
    model = llama.from_numpy_params(jparams, cfg, device="cpu",
                                    trainable=True)
    tt = torch.from_numpy(tokens)

    hid_j, _ = jllama.forward_hidden(jparams, jnp.asarray(tokens[:, :-1]),
                                     jcfg)
    hid_t, aux_t = llama.forward_hidden(model, tt[:, :-1], cfg)
    np.testing.assert_allclose(hid_t.detach().numpy(), hid_j, **REL)
    assert float(aux_t) == 0.0
    logits_j, _ = jllama.forward(jparams, jnp.asarray(tokens[:, :-1]), jcfg)
    logits_t, _ = llama.forward(model, tt[:, :-1], cfg)
    np.testing.assert_allclose(logits_t.detach().numpy(), logits_j, **REL)

    (total_j, m_j), grads_j = jax.value_and_grad(
        jtrainer.loss_fn, has_aux=True)(jparams, jnp.asarray(tokens), jcfg)
    total_t, m_t = loss_fn(model, tt, cfg)
    total_t.backward()
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(total_t.detach()), float(total_j),
                               rtol=1e-5)
    got = _grad_tree(model)
    for path, want in jax.tree_util.tree_leaves_with_path(_tree(grads_j)):
        np.testing.assert_allclose(_at(got, path), want, err_msg=str(path),
                                   **REL)


def _grad_tree(model):
    """The model's gradients in the JAX parameter tree's layout."""
    names = [n for n, _ in model.layers[0].named_parameters()]

    def g(p):
        return p.grad.detach().float().numpy()

    return {"embed": g(model.embed),
            "layers": {n: np.stack([g(getattr(layer, n))
                                    for layer in model.layers])
                       for n in names},
            "final_norm": g(model.final_norm), "lm_head": g(model.lm_head)}


def _at(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_numpy_params_round_trip(jparams):
    cfg = get_config("llama-test")
    model = llama.from_numpy_params(jparams, cfg, device="cpu",
                                    trainable=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    back = llama.to_numpy_params(model)
    for path, want in jax.tree_util.tree_leaves_with_path(jparams):
        np.testing.assert_array_equal(_at(back, path), want)
    serving = llama.from_numpy_params(jparams, get_config(
        "llama-test", dtype="bfloat16"), device="cpu")
    assert not any(p.requires_grad for p in serving.parameters())
    assert {p.dtype for p in serving.parameters()} == {torch.bfloat16}


# ---- optimizer and the whole step ----------------------------------------

def test_optimizer_matches_optax_three_steps():
    """Clip (both sides of the trigger), schedule (rate 0 at the first
    update), bias correction and decoupled decay, against optax."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (11,), "c": (3, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (3.0, 0.01, 1.0)]
    jopt = jtrainer.make_optimizer(learning_rate=1e-2, warmup_steps=2,
                                   decay_steps=5)
    opt = make_optimizer(learning_rate=1e-2, warmup_steps=2, decay_steps=5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in sorted(shapes)]
    tstate = opt.init(tp)
    for g in grads:
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.update(tp, [torch.from_numpy(g[k]) for k in sorted(g)],
                          tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            {k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
        for k, t in zip(sorted(shapes), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    assert opt.schedule(0) == 0.0


@pytest.mark.parametrize("overrides", [
    dict(attention="dense"),
    dict(attention="flash", fused_ce=True, ce_chunk=100, remat=True,
         remat_policy="full"),
])
def test_three_train_steps_match_make_train_step(overrides):
    jcfg = jget_config("llama-test", **overrides)
    cfg = get_config("llama-test", **overrides)
    mesh = create_mesh(MeshConfig(fsdp=1), devices=jax.devices()[:1])
    jopt = jtrainer.make_optimizer(learning_rate=1e-2, warmup_steps=2,
                                   decay_steps=100)
    jstate = jtrainer.init_state(jcfg, mesh, jopt)
    jstep = jtrainer.make_train_step(jcfg, mesh, jopt)
    model = llama.from_numpy_params(_tree(jstate.params), cfg, device="cpu",
                                    trainable=True)
    opt = make_optimizer(learning_rate=1e-2, warmup_steps=2,
                         decay_steps=100)
    state = state_for(model, opt)
    step = make_train_step(cfg, opt)
    batches = synthetic_batches(cfg.vocab_size, 2, 16, seed=3)
    for _ in range(3):
        batch = next(batches)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert state.step == int(jstate.step) == 3
    got = llama.to_numpy_params(state.model)
    for path, want in jax.tree_util.tree_leaves_with_path(
            _tree(jstate.params)):
        np.testing.assert_allclose(_at(got, path), want, err_msg=str(path),
                                   **PARAMS_TOL)


def test_remat_policies_give_the_same_gradients(jparams):
    """none, full and dots recompute differently but compute the same
    function: gradients agree bitwise in f32 on the CPU."""
    grads = []
    for policy in ("none", "full", "dots"):
        cfg = get_config("llama-test", remat=policy != "none",
                         remat_policy=policy, attention="flash")
        model = llama.from_numpy_params(jparams, cfg, device="cpu",
                                        trainable=True)
        total, _ = loss_fn(model, torch.from_numpy(_batch(cfg)["tokens"]),
                           cfg)
        total.backward()
        grads.append([p.grad for p in model.parameters()])
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_full_remat_runs_the_flash_forward_twice(jparams, monkeypatch):
    """Under remat "full" each layer's attention forward runs in the
    forward and again in the backward's recompute (the count chip_smoke
    asserts for the kernels), here counted through the plain version."""
    calls = {"fwd": 0}
    plain = fa._flash_forward_plain

    def counting(*a, **k):
        calls["fwd"] += 1
        return plain(*a, **k)

    monkeypatch.setattr(fa, "_flash_forward_plain", counting)
    cfg = get_config("llama-test", remat=True, remat_policy="full",
                     attention="flash")
    model = llama.from_numpy_params(jparams, cfg, device="cpu",
                                    trainable=True)
    total, _ = loss_fn(model, torch.from_numpy(_batch(cfg)["tokens"]), cfg)
    assert calls["fwd"] == cfg.num_layers
    total.backward()
    assert calls["fwd"] == 2 * cfg.num_layers


def test_eval_step_matches_loss(jparams):
    cfg = get_config("llama-test")
    model = llama.from_numpy_params(jparams, cfg, device="cpu",
                                    trainable=True)
    batch = _batch(cfg)
    m = make_eval_step(cfg)(model, batch)
    want, _ = loss_fn(model, torch.from_numpy(batch["tokens"]), cfg)
    assert float(m["loss"]) == pytest.approx(float(want.detach()), rel=1e-6)


# ---- loop, data, accounting, entry point ---------------------------------

def test_synthetic_batches_are_the_reference_arrays():
    for args in ((256, 2, 16, 0), (128_256, 3, 33, 7)):
        want = jdata.synthetic_batches(*args[:3], seed=args[3])
        got = synthetic_batches(*args[:3], seed=args[3])
        for _ in range(3):
            np.testing.assert_array_equal(next(got)["tokens"],
                                          next(want)["tokens"])


def test_sync_cadence_does_not_change_losses():
    cfg = get_config("llama-test")
    reports = []
    for sync_every in (1, 3):
        opt = make_optimizer(learning_rate=1e-2, warmup_steps=1,
                             decay_steps=10)
        state = init_state(cfg, opt, seed=0, device="cpu")
        batches = [next(synthetic_batches(cfg.vocab_size, 2, 16))]
        state, report = run_pipelined(make_train_step(cfg, opt), state,
                                      batches, sync_every=sync_every,
                                      max_steps=4, tokens_per_step=32)
        reports.append(report)
        assert state.step == 4 and report.steps == 4
        assert len(report.history) == 4 and "grad_norm" in report.history[0]
    assert reports[0].losses == reports[1].losses
    assert reports[0].sync_points == 4 and reports[1].sync_points == 2


def test_accounting_and_policies_match_the_reference():
    for name, seq in (("llama3-8b", 8192), ("llama-test", 64)):
        assert flops_per_token(get_config(name), seq) == \
            jflops(jget_config(name), seq)
        assert mfu(1e4, get_config(name), seq, 989.0) == pytest.approx(
            jmfu(1e4, jget_config(name), seq, 989.0))
    for policy in ("auto", "f32", "bf16"):
        for remat in (dict(), dict(remat=False), dict(remat_policy="dots")):
            ours = apply_policy(get_config("llama-test", **remat), policy)
            ref = jprecision.apply_policy(jget_config("llama-test", **remat),
                                          policy)
            assert (ours.dtype, ours.param_dtype) == (ref.dtype,
                                                      ref.param_dtype)
            assert policy_of(ours) == jprecision.policy_of(ref)
            assert remat_policy_of(ours) == jprecision.remat_policy_of(ref)


def test_entry_point_trains_on_cpu_and_needs_the_card_by_default(tmp_path):
    report = tmp_path / "run.json"
    rc = train_main([
        "--model", "llama-test", "--model-opt", "attention=flash",
        "--model-opt", "fused_ce=true", "--model-opt", "ce_chunk=100",
        "--precision", "bf16", "--remat-policy", "full", "--steps", "3",
        "--batch-size", "2", "--seq-len", "32", "--warmup-steps", "1",
        "--log-every", "1", "--device", "cpu",
        "--report-json", str(report)])
    assert rc == 0
    import json

    data = json.loads(report.read_text())
    assert data["steps"] == 3 and len(data["losses"]) == 3
    assert all(np.isfinite(data["losses"] + data["grad_norms"]))
    assert data["precision"] == "bf16" and data["remat"] == "full"
    assert data["mfu"] is None  # not measured off the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_main(["--model", "llama-test", "--steps", "1"])


def test_measure_throughput_times_the_window_difference():
    from triton_kubernetes_tpu_torch.train import measure_throughput, \
        measure_tokens_per_sec

    cfg = get_config("llama-test")
    opt = make_optimizer(learning_rate=1e-2, warmup_steps=1, decay_steps=10)
    state = init_state(cfg, opt, seed=0, device="cpu")
    batches = [next(synthetic_batches(cfg.vocab_size, 2, 16))]
    report, state = measure_throughput(make_train_step(cfg, opt), state,
                                       batches, tokens_per_step=32,
                                       warmup=1, n_short=1, n_long=3)
    assert state.step == 5
    assert report.steps_timed == 2 and report.n_processes == 1
    assert report.tokens_per_sec == pytest.approx(
        32 * report.steps_per_sec)
    assert np.isfinite(report.loss)
    tps, loss, state = measure_tokens_per_sec(
        make_train_step(cfg, opt), state, batches, 32, 0, 1, 2)
    assert state.step == 8 and tps > 0 and np.isfinite(loss)
    with pytest.raises(ValueError, match="must exceed"):
        measure_throughput(make_train_step(cfg, opt), state, batches, 32,
                           0, 2, 2)
