"""The port's workload fault arms against the reference's, on the CPU.

* **reference tokens** -- on ``llama-test`` in f32 with the JAX parameters
  carried over (``from_numpy_params``), every solo reference the arms
  compare against -- the preempt pools at ``spec_k`` 0 and 3 with the
  prefix cache on and off, and the replica/migration shape -- is the JAX
  arm's token for token;
* **verdicts** -- ``workload-prefill-gap`` checks the same invariants with
  the same verdict and the same preemption count as the JAX
  ``run_scenario``'s workload part;
* **the arms** -- the reference's arm tests through the port: preemption
  holds every invariant (also under the prefix cache at ``spec_k`` 3), an
  abort flushes every lifecycle, the mutations are caught and the
  leaked-pages one shrinks minimal, every checkpoint corruption falls
  back;
* **the trainer's crash hook** -- ``TK8S_TEST_CRASH_STEP`` kills the rank
  at its step with exit code 3 through ``launch_trainers`` (gloo), and the
  resumed run lands on the uninterrupted run's loss;
* the ``slow`` lane: the forced shrink of ``dropped-reland`` over router
  fleets, the SIGTERM arm, and the simulated-hours soak.
"""

from __future__ import annotations

import copy
import os

import jax
import numpy as np
import pytest

from triton_kubernetes_tpu.chaos import workload as jwl
from triton_kubernetes_tpu.chaos.generator import \
    generate_spec as jgenerate_spec
from triton_kubernetes_tpu.chaos.runner import run_scenario as jrun_scenario
from triton_kubernetes_tpu.utils import metrics as jmetrics
from triton_kubernetes_tpu_torch.chaos import corpus
from triton_kubernetes_tpu_torch.chaos import workload as wl
from triton_kubernetes_tpu_torch.chaos.generator import generate_spec
from triton_kubernetes_tpu_torch.chaos.runner import (
    INVARIANTS,
    run_scenario,
)
from triton_kubernetes_tpu_torch.chaos.shrink import (
    shrink_spec,
    workload_fault_fields,
)
from triton_kubernetes_tpu_torch.models import from_numpy_params, get_config
from triton_kubernetes_tpu_torch.utils import metrics

_CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chaos_corpus")
_ENTRIES = {e["name"]: e for _, e in corpus.load_entries(_CORPUS)}


@pytest.fixture(autouse=True)
def fresh_registries():
    metrics.configure()
    jmetrics.configure()
    yield
    metrics.configure()
    jmetrics.configure()


@pytest.fixture(scope="module", autouse=True)
def carried_model():
    """The JAX arms' model, carried into the port's arms (CPU, f32)."""
    jcfg, jparams = jwl._model()
    cfg = get_config("llama-test")
    assert cfg.dtype == jcfg.dtype == "float32"
    wl.use_model(cfg, from_numpy_params(jax.tree.map(np.asarray, jparams),
                                        cfg, device="cpu"))
    yield
    wl.use_model()


def _spec(seed, kind, **fields):
    """A generated workload spec with its fault pinned (the reference
    test's ``_workload_spec``)."""
    spec = generate_spec(seed, "workload")
    spec["workload"] = dict({"kind": kind}, **fields)
    return spec


# ------------------------------------------------------ reference tokens
_LONG = {w: [(7 * i + 3) % 29 for i in range(w * 8)] for w in (4, 5)}
_PREEMPT_REQUESTS = [([3, 1, 4, 7], 12, 11), (_LONG[4], 4, 12),
                     (_LONG[5], 4, 12), (_LONG[5], 4, 13)]
_SOLO_REQUESTS = ([([(5 * i + 7) % 29 for i in range(n)], m, 21)
                   for n, m in ((4, 6), (4, 8), (8, 10))]
                  + [([(11 * i + 5) % 29 for i in range(12)], 6, 31),
                     ([3, 1, 4, 1, 5, 9, 2, 6], 4, 32)])


@pytest.mark.parametrize("key", [("preempt", False, 0),
                                 ("preempt", True, 0),
                                 ("preempt", False, 3),
                                 ("preempt", True, 3), ("solo",)],
                         ids=["preempt", "preempt-prefix", "preempt-spec3",
                              "preempt-prefix-spec3", "solo"])
def test_reference_tokens_equal_the_jax_arms(key):
    requests = _SOLO_REQUESTS if key == ("solo",) else _PREEMPT_REQUESTS
    for toks, max_new, seed in requests:
        want = jwl._reference_tokens(key, toks, max_new, seed)
        got = wl._reference_tokens(key, toks, max_new, seed, "cpu")
        assert got == want, (key, toks, max_new, seed)
        assert len(got) == max_new


# -------------------------------------------------------------- verdicts
def test_prefill_gap_verdict_equals_the_jax_run_scenario():
    entry = _ENTRIES["workload-prefill-gap"]
    jres = jrun_scenario(copy.deepcopy(entry["spec"]), ns="wl-parity")
    res = run_scenario(copy.deepcopy(entry["spec"]), device="cpu")
    assert res.checked == [c for c in jres.checked if c in INVARIANTS]
    assert res.passed == jres.passed is True
    assert res.stats["workload_preemptions"] == \
        jres.stats["workload_preemptions"] >= 1
    assert res.stats["workload_kind"] == jres.stats["workload_kind"]


def test_generated_infra_is_carried_unchanged_into_the_result():
    spec = _spec(11, "engine-preempt", long_windows=5, requests=3)
    assert spec == dict(jgenerate_spec(11, "workload"),
                        workload=spec["workload"])
    res = run_scenario(spec, device="cpu")
    assert res.spec is spec and res.passed, res.violations
    assert res.stats["simulated_seconds"] > 0


# ------------------------------------------------------------------ arms
@pytest.mark.parametrize("fields", [
    dict(long_windows=5, requests=3),
    dict(long_windows=5, requests=3, prefix_cache=True, spec_k=3)],
    ids=["plain", "prefix-spec3"])
def test_engine_preempt_arm_preempts_and_holds_every_invariant(fields):
    res = run_scenario(_spec(11, "engine-preempt", **fields), device="cpu")
    assert res.passed, res.violations
    assert res.stats["workload_kind"] == "engine-preempt"
    assert res.stats.get("workload_preemptions", 0) >= 1
    for inv in ("engine-parity", "pool-convergence", "trace-valid"):
        assert inv in res.checked


def test_engine_preempt_arm_preempts_in_a_pool_of_16_token_pages():
    """A workload ``block_size`` of 16: the arm in a pool of 16-token pages
    (the paged kernels' tensor-core designs on the card) -- 4 usable
    pages, 48-token prompts whose first decode token needs a fourth page
    -- preempts and keeps every invariant (tokens those of the solo runs
    in the same pool); the default pool is untouched, and a block size
    with no pool raises."""
    pool = dict(block_size=16, num_blocks=5, max_batch=3, max_model_len=64,
                prefill_chunk=16)
    assert wl.preempt_pool(16) == pool
    assert wl.preempt_pool()["block_size"] == 4
    res = run_scenario(_spec(11, "engine-preempt", long_windows=6,
                             requests=3, block_size=16), device="cpu")
    engine, _ = wl._engine(("preempt", False, 0, 16), "cpu")
    assert engine.block_size == 16
    assert res.passed, res.violations
    assert res.stats.get("workload_preemptions", 0) >= 1
    assert "engine-parity" in res.checked
    default, _ = wl._engine(("preempt", False, 0, 4), "cpu")
    assert default.block_size == 4
    with pytest.raises(ValueError, match="no preempt pool of block size 8"):
        wl.preempt_pool(8)


def test_engine_preempt_abort_flushes_every_lifecycle():
    res = run_scenario(_spec(12, "engine-preempt", long_windows=5,
                             abort_after_steps=3), device="cpu")
    assert res.passed, res.violations


def test_swallowed_abort_mutation_is_caught_by_the_trace_oracle():
    spec = _spec(13, "engine-preempt", long_windows=5, abort_after_steps=3)
    spec["mutation"] = "swallowed-abort"
    res = run_scenario(spec, device="cpu")
    assert res.violated("trace-valid"), res.to_dict()
    assert any("no terminal" in v["detail"] for v in res.violations)


def test_forced_shrink_leaked_pages_lands_minimal():
    spec = _spec(14, "engine-preempt", prefix_cache=True, long_windows=5,
                 requests=3)
    spec["mutation"] = "leaked-pages"
    res = run_scenario(spec, device="cpu")
    assert res.violated("pool-convergence"), res.to_dict()
    minimal, mres = shrink_spec(spec, result=res, device="cpu")
    assert mres.violated("pool-convergence")
    assert minimal["workload"]["kind"] == "engine-preempt"
    assert minimal["workload"].get("prefix_cache") is True
    assert workload_fault_fields(minimal) <= 2, minimal["workload"]


@pytest.mark.parametrize("corruption", ["truncate", "bitflip",
                                        "torn-manifest"])
def test_torn_checkpoint_arm_every_corruption(corruption):
    for torn_step, keep in ((1, 2), (2, 3)):
        spec = _spec(15, "torn-checkpoint", corruption=corruption,
                     torn_step=torn_step, keep_steps=keep)
        res = run_scenario(spec, device="cpu")
        # The infra arms first, as the reference's runner checks them.
        infra = jrun_scenario(dict(copy.deepcopy(spec), workload=None),
                              ns="wl-infra").checked
        assert res.checked == infra + ["ckpt-fallback"]
        assert res.passed, (corruption, res.violations)


def test_reshard_torn_checkpoint_at_every_offset():
    for frac in (0.0, 0.3, 0.5, 0.949):
        for torn_step in (1, 2):
            spec = _spec(19, "reshard-torn-checkpoint", offset_frac=frac,
                         torn_step=torn_step)
            res = run_scenario(spec, device="cpu")
            assert res.passed, (frac, torn_step, res.violations)
            spec["mutation"] = "adopt-torn-step"
            res = run_scenario(spec, device="cpu")
            assert [v["invariant"] for v in res.violations] == \
                ["reshard-fallback"]


def test_kv_migration_torn_at_every_cut():
    for cut in ("truncate", "bitflip"):
        for frac in (0.0, 0.2, 0.5, 0.999):
            res = run_scenario(_spec(20, "kv-migration-torn", cut=cut,
                                     offset_frac=frac), device="cpu")
            assert res.passed, (cut, frac, res.violations)


# ----------------------------------------------- the trainer's crash hook
def test_crash_step_hook_exits_3_and_the_resume_lands_on_the_reference():
    """A world of one (gloo), the arm's trainer args: the rank dies with
    exit code 3 at the sync window of its step -- after that step's
    checkpoint, which is what the resume starts from -- and the resumed
    run's final loss is the uninterrupted run's."""
    got = wl.train_crash_resume(4, 2, 0, device="cpu", n_processes=1)
    assert got["died"] and got["rcs"] == [3], got
    assert got["resume_ok"] and got["ok"], got
    assert got["final"] == got["reference"]
    assert got["traces"] == 2 and got["trace_problems"] == []


# ------------------------------------------------------------------ slow
@pytest.mark.slow
def test_forced_shrink_dropped_reland_lands_minimal():
    spec = _spec(17, "replica-death", replicas=3, die_after_tokens=3,
                 max_new_tokens=8)
    spec["mutation"] = "dropped-reland"
    res = run_scenario(spec, device="cpu")
    assert res.violated("reland-parity"), res.to_dict()
    minimal, mres = shrink_spec(spec, result=res, device="cpu")
    assert mres.violated("reland-parity")
    assert minimal["workload"]["kind"] == "replica-death"
    assert workload_fault_fields(minimal) <= 2, minimal["workload"]


@pytest.mark.slow
def test_sigterm_flush_arm_lands_every_placement():
    res = run_scenario(_spec(18, "sigterm-flush", after_requests=2),
                       device="cpu")
    assert res.passed, res.violations
    assert "flush-clean" in res.checked


@pytest.mark.slow
def test_soak_runs_simulated_hours_of_engine_chaos():
    old = wl.ENGINE_CLOCK_TICK
    wl.ENGINE_CLOCK_TICK = 30.0
    simulated = 0.0
    try:
        for seed in (21, 22, 23, 24):
            res = run_scenario(_spec(seed, "engine-preempt", long_windows=5,
                                     requests=3), device="cpu")
            assert res.passed, res.violations
            simulated += res.stats["simulated_seconds"]
    finally:
        wl.ENGINE_CLOCK_TICK = old
    assert simulated >= 2 * 3600, simulated
