"""Port parity for the serving layer.

* The page allocator and prefix cache are host bookkeeping: the same
  seeded op stream through the JAX package's and the port's gives
  identical pages, refcounts and evictions.
* The engines: the churn scenario of ``tests/test_serve.py`` (staggered
  arrivals, a pool tight enough to preempt, the pool draining) through the
  JAX engine and the port's at the same ``llama-test`` weights gives
  identical greedy streams, with whole-prompt prefill and with chunked
  prefill plus the prefix cache. The logits agree to f32 rounding, so only
  a near-tie (top-2 gap < 1e-4) could flip an argmax; these prompts at
  seed 0 have none -- a changed prompt that hits one needs another seed.
* Seeded sampling is keyed on (seed, position) inside the port: a sampled
  request's tokens do not depend on what else is in the batch.
"""

import jax
import numpy as np
import pytest

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu.serve import BlockAllocator as JAllocator
from triton_kubernetes_tpu.serve import ManualClock as JClock
from triton_kubernetes_tpu.serve import OutOfBlocksError as JOutOfBlocks
from triton_kubernetes_tpu.serve import PrefixCache as JPrefixCache
from triton_kubernetes_tpu.serve import Request as JRequest
from triton_kubernetes_tpu.serve import ServeEngine as JServeEngine
from triton_kubernetes_tpu.utils import metrics as jmetrics
from triton_kubernetes_tpu_torch.models import from_numpy_params, get_config
from triton_kubernetes_tpu_torch.serve import (
    BlockAllocator,
    ManualClock,
    OutOfBlocksError,
    PrefixCache,
    Request,
    ServeEngine,
)
from triton_kubernetes_tpu_torch.utils import metrics
from triton_kubernetes_tpu_torch.utils.trace import FlightRecorder

CHURN = [
    ([5, 7, 9, 11, 2, 4, 6, 8], 16),
    ([3, 1, 4, 1, 5, 9, 2, 6], 16),
    ([2, 2, 2], 5),
    ([9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 1, 2, 3], 7),
]
ARRIVALS = {0: [0], 1: [1, 2], 3: [3]}


@pytest.fixture(autouse=True)
def fresh_registries():
    metrics.configure()
    jmetrics.configure()
    yield
    metrics.configure()
    jmetrics.configure()


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("llama-test")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("llama-test")
    model = from_numpy_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return (jparams, jcfg), (model, cfg)


def _run(engine, request_cls, prompts, arrivals, **req):
    results, step = {}, 0
    while engine.has_work or step <= max(arrivals):
        for idx in arrivals.get(step, []):
            p, n = prompts[idx]
            engine.submit(request_cls(f"r{idx}", list(p), n, **req))
        for d in engine.step():
            results[d.request_id] = d
        step += 1
        assert step < 500, "engine failed to drain"
    return results


# ------------------------------------------------------------- allocator
def test_allocator_and_prefix_cache_match_jax_op_stream():
    rng = np.random.default_rng(0)
    ja, ta = JAllocator(24), BlockAllocator(24)
    jc, tc = JPrefixCache(ja, 4), PrefixCache(ta, 4)
    held = []
    for _ in range(300):
        op = rng.integers(0, 5)
        if op == 0:
            n = int(rng.integers(1, 5))
            try:
                got = ta.alloc(n)
            except OutOfBlocksError:
                with pytest.raises(JOutOfBlocks):
                    ja.alloc(n)
                continue
            assert got == ja.alloc(n)
            held.append(got)
        elif op == 1 and held:
            pages = held.pop(int(rng.integers(0, len(held))))
            ta.free(pages)
            ja.free(pages)
        elif op == 2 and held:
            pages = held[int(rng.integers(0, len(held)))]
            toks = rng.integers(0, 3, len(pages) * 4).tolist()
            assert tc.insert(toks, pages) == jc.insert(toks, pages)
        elif op == 3:
            toks = rng.integers(0, 3, 12).tolist()
            assert tc.lookup(toks) == jc.lookup(toks)
        elif op == 4:
            n = int(rng.integers(1, 3))
            assert tc.evictable() == jc.evictable()
            assert tc.evict(n) == jc.evict(n)
        assert ta.available == ja.available and ta.in_use == ja.in_use
        assert sorted(tc.indexed_pages()) == sorted(jc.indexed_pages())
        assert all(ta.refcount(p) == ja.refcount(p) for p in range(24))
    assert tc.clear() == jc.clear()


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("engine_kw", [
    {},
    {"prefill_chunk": 8, "prefix_cache": True},
], ids=["whole-prompt", "chunked-prefix"])
def test_churn_streams_match_jax_engine(models, engine_kw):
    (jparams, jcfg), (model, cfg) = models
    kw = dict(block_size=4, num_blocks=10, max_batch=3, max_model_len=32,
              **engine_kw)
    jeng = JServeEngine(jparams, jcfg, clock=JClock(tick=0.001), **kw)
    teng = ServeEngine(model, cfg, clock=ManualClock(tick=0.001),
                       device="cpu", **kw)
    want = _run(jeng, JRequest, CHURN, ARRIVALS)
    got = _run(teng, Request, CHURN, ARRIVALS)
    assert metrics.counter("tk8s_serve_preemptions_total").value() >= 1
    assert (metrics.counter("tk8s_serve_preemptions_total").value()
            == jmetrics.counter("tk8s_serve_preemptions_total").value())
    for rid, d in want.items():
        assert got[rid].tokens == d.tokens, f"{rid} diverged"
        assert got[rid].preemptions == d.preemptions
        assert got[rid].finish_reason == d.finish_reason
    teng.release_prefix_cache()
    assert teng.allocator.in_use == 0, "leaked KV pages"
    assert teng.allocator.available == teng.allocator.capacity


def test_prefix_cache_hits_match_jax_engine(models):
    """Requests sharing a 16-token prefix, arriving after the first one's
    prefill landed: both engines skip the same windows and agree on every
    stream."""
    (jparams, jcfg), (model, cfg) = models
    shared = list(range(40, 56))
    prompts = [(shared + [1, 2, 3], 4), (shared + [7, 8], 4),
               (shared + [9, 9, 9, 9, 9], 3), ([3, 4, 5], 4)]
    arrivals = {0: [0], 4: [1, 2, 3]}
    kw = dict(block_size=4, num_blocks=40, max_batch=4, max_model_len=32,
              prefill_chunk=8, prefix_cache=True)
    want = _run(JServeEngine(jparams, jcfg, clock=JClock(tick=0.001), **kw),
                JRequest, prompts, arrivals)
    teng = ServeEngine(model, cfg, clock=ManualClock(tick=0.001),
                       device="cpu", **kw)
    got = _run(teng, Request, prompts, arrivals)
    hits = metrics.counter("tk8s_serve_prefix_hit_tokens_total").value()
    assert hits == 32  # two requests x two reused 8-token windows
    assert hits == jmetrics.counter(
        "tk8s_serve_prefix_hit_tokens_total").value()
    assert teng.stats()["prefill_windows"] == 3 + 1 + 1 + 1
    for rid, d in want.items():
        assert got[rid].tokens == d.tokens, f"{rid} diverged"


def test_seeded_sampling_independent_of_batch(models):
    _, (model, cfg) = models
    kw = dict(block_size=4, num_blocks=40, max_batch=4, max_model_len=64,
              device="cpu")
    sampled = dict(temperature=0.8, top_p=0.9, top_k=50, seed=7)

    solo = ServeEngine(model, cfg, clock=ManualClock(tick=0.001), **kw)
    solo.submit(Request("s", [5, 6, 7, 8, 9], 10, **sampled))
    alone = solo.run_until_idle()[0].tokens

    busy = ServeEngine(model, cfg, clock=ManualClock(tick=0.001), **kw)
    busy.submit(Request("a", [1, 2, 3], 12))
    busy.submit(Request("b", list(range(20)), 6, temperature=1.0, seed=3))
    busy.step()
    busy.submit(Request("s", [5, 6, 7, 8, 9], 10, **sampled))
    done = {d.request_id: d.tokens for d in busy.run_until_idle()}
    assert done["s"] == alone
    # A different seed draws a different stream (the key is live).
    other = ServeEngine(model, cfg, clock=ManualClock(tick=0.001), **kw)
    other.submit(Request("s", [5, 6, 7, 8, 9], 10,
                         **dict(sampled, seed=8)))
    assert other.run_until_idle()[0].tokens != alone


def test_engine_validates_and_refuses_later_slices(models):
    _, (model, cfg) = models
    eng = ServeEngine(model, cfg, block_size=4, num_blocks=8,
                      max_model_len=32, device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request("r", [], 4))
    with pytest.raises(ValueError, match="vocabulary"):
        eng.submit(Request("r", [1, 999999], 4))
    with pytest.raises(ValueError, match="max_model_len"):
        eng.submit(Request("r", [1] * 30, 10))
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit(Request("r", [1] * 20, 10))
    # Handoff and the flight recorder are ported: a handoff request
    # finishes after its first token with its pages parked, and a
    # FlightRecorder is accepted and records the lifecycle.
    eng.submit(Request("r", [1, 2], 2, handoff=True))
    done = eng.run_until_idle()
    assert [d.finish_reason for d in done] == ["handoff"]
    assert list(eng.parked) == ["r"] and eng.parked["r"].pages
    assert eng.allocator.in_use == len(eng.parked["r"].pages)
    flight = FlightRecorder()
    traced = ServeEngine(model, cfg, block_size=4, num_blocks=8,
                         max_model_len=32, device="cpu", flight=flight,
                         clock=ManualClock(tick=0.001))
    traced.submit(Request("t", [1, 2, 3], 2))
    (fin,) = traced.run_until_idle()
    assert fin.trace_id == "t" and fin.phases is not None
    assert abs(sum(fin.phases.values()) - (fin.finished_at
                                           - fin.submitted_at)) < 1e-9
    assert [r.outcome for r in flight.finished] == ["length"]
    with pytest.raises(KeyError, match="weight_dtype"):
        ServeEngine(model, cfg, device="cpu", weight_dtype="fp4")
