"""Port parity for tracing: ``utils/trace.py``, the engine's flight recorder
and goodput ledger, the trainer loop's goodput, and the ``trace merge`` /
``goodput report`` entry points.

* The module: the same seeded event scripts through the JAX package's and
  the port's ``FlightRecorder`` / ``TraceWriter`` / ``GoodputRecorder``
  give equal ``to_dict()``, snapshots, counters and JSONL lines (the meta
  anchor's clock, wall and pid are fixed, so every line compares); the
  merge and every validator give equal results on the same files,
  malformed ones included; the closed vocabularies equal the reference's
  constants.
* The engine: under ``ManualClock(tick=0.001)`` on the churn scenario (and
  with chunked prefill + prefix cache, and speculation), the port's
  ``FinishedRequest`` timestamps, ``phases``, ``spec`` and the JSONL lines
  of a ``FlightRecorder`` with a writer and a serve ``GoodputRecorder``
  equal the JAX engine's: the port reads the clock at the same points in
  the same order. With the recorder off, tokens, model calls and clock
  reads are those of the untraced engine.
* The trainer's ``run_pipelined`` with a ``GoodputRecorder`` partitions the
  loop's wall time in the reference's category order.
* The two tools print what the reference CLI verbs print.
"""

import io
import json
import random
import re
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.cli.main import main as jcli
from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu.serve import ManualClock as JClock
from triton_kubernetes_tpu.serve import Request as JRequest
from triton_kubernetes_tpu.serve import ServeEngine as JServeEngine
from triton_kubernetes_tpu.train.pipeline import run_pipelined as jrun
from triton_kubernetes_tpu.utils import metrics as jmetrics
from triton_kubernetes_tpu.utils import trace as jtrace
from triton_kubernetes_tpu_torch.models import from_numpy_params, get_config
from triton_kubernetes_tpu_torch.serve import (
    ManualClock,
    Request,
    ServeEngine,
)
from triton_kubernetes_tpu_torch.serve import engine as engine_mod
from triton_kubernetes_tpu_torch.tools import goodput as goodput_tool
from triton_kubernetes_tpu_torch.tools import trace as trace_tool
from triton_kubernetes_tpu_torch.train.pipeline import run_pipelined
from triton_kubernetes_tpu_torch.utils import metrics
from triton_kubernetes_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def fresh_registries():
    metrics.configure()
    jmetrics.configure()
    yield
    metrics.configure()
    jmetrics.configure()


def lines(path):
    with open(path) as f:
        return f.read().splitlines()


def writer(mod, path, role="replica-0"):
    return mod.TraceWriter(str(path), role, clock=lambda: 0.0,
                           wall=lambda: 0.0, pid=7)


# ------------------------------------------------------------ vocabulary
@pytest.mark.parametrize("name", [
    "TRACE_HEADER", "SPAN_CATALOG", "PHASE_STATES", "GOODPUT_FAMILY",
    "GOODPUT_CATEGORIES", "GOODPUT_USEFUL", "GOODPUT_WASTE"])
def test_constants_equal_the_reference(name):
    assert getattr(trace, name) == getattr(jtrace, name)


def test_trace_ids_match_the_reference():
    for seed in range(5):
        assert trace.mint_trace_id(random.Random(seed)) == \
            jtrace.mint_trace_id(random.Random(seed))
    for s in ("abc", 'a"b', "", "x" * 129, "café", None, 7, "a.b_c-d"):
        assert trace.valid_trace_id(s) == jtrace.valid_trace_id(s)


# ----------------------------------------------------- recorder scripts
EVENTS = ["serve.admitted", "serve.prefill", "serve.prefill_yield",
          "serve.first_token", "serve.grow", "serve.preempt", "serve.resume",
          "serve.verify", "serve.migrate_out", "serve.migrate_in"]


def flight_script(seed):
    """A seeded stream of recorder calls: (method, args, kwargs)."""
    rng = random.Random(seed)
    live, t, calls, n = [], 0.0, [], 0
    for _ in range(120):
        t += rng.choice([0.0, 0.001, 0.25, 1.5])
        op = rng.random()
        if op < 0.2 or not live:
            rid = f"r{n}"
            n += 1
            live.append(rid)
            calls.append(("begin", (rid, rng.choice([None, f"t{n}"]), t),
                          {}))
        elif op < 0.8:
            rid = rng.choice(live)
            name = rng.choice(EVENTS)
            fields = {"admitted": dict(slot=1, reused_pages=0,
                                       recompute=rng.random() < 0.3,
                                       deferred=rng.random() < 0.5),
                      "verify": dict(proposed=3, accepted=rng.randrange(4)),
                      "grow": dict(pages=2)}.get(name.split(".")[1], {})
            calls.append(("event", (rid, name, t), fields))
        elif op < 0.95:
            rid = live.pop(rng.randrange(len(live)))
            calls.append(("finish", (rid, t, rng.choice(["eos", "length"])),
                          {}))
        else:
            calls.append(("step", (t, 0.5, 2), {}))
            calls.append(("migration", ("serve.migrate_out", t, 0.25),
                          dict(trace="x", request="gone", bytes=10)))
    calls.append(("flush_aborted", (t + 1.0, "RuntimeError: died"), {}))
    return calls


@pytest.mark.parametrize("seed", range(4))
def test_flight_recorder_script_matches_reference(tmp_path, seed):
    recs = {}
    for tag, mod in (("port", trace), ("ref", jtrace)):
        fr = mod.FlightRecorder(limit=16, events_per_request=12,
                                writer=writer(mod, tmp_path / tag))
        for method, args, kwargs in flight_script(seed):
            getattr(fr, method)(*args, **kwargs)
        fr.writer.close()
        recs[tag] = fr
    port, ref = recs["port"], recs["ref"]
    assert lines(tmp_path / "port") == lines(tmp_path / "ref")
    assert [r.to_dict() for r in port.finished] == \
        [r.to_dict() for r in ref.finished]
    assert [r.segments for r in port.finished] == \
        [r.segments for r in ref.finished]
    assert port.snapshot(limit=8) == ref.snapshot(limit=8)
    assert port.in_flight == ref.in_flight == 0
    for r in ref.finished:
        assert port.lookup(r.trace_id).to_dict() == r.to_dict()
        assert sum(r.phases.values()) == pytest.approx(r.e2e_s)


def goodput_script(seed, source):
    rng = random.Random(seed)
    cats = jtrace.GOODPUT_CATEGORIES[source]
    calls, t = [], 10.0
    for _ in range(80):
        t += rng.choice([0.0, 0.002, 0.5])
        op = rng.random()
        if op < 0.7:
            calls.append(("transition", (rng.choice(cats), t)))
        elif op < 0.85:
            calls.append(("enter", (rng.choice(cats), t)))
        else:
            calls.append(("exit_idle", (t,)))
    calls.append(("close", (t + 1.0,)))
    calls.append(("transition", (cats[0], t + 2.0)))  # after close: no-op
    return calls


@pytest.mark.parametrize("source", ["serve", "train", "route"])
def test_goodput_recorder_script_matches_reference(tmp_path, source):
    recs = {}
    for tag, mod in (("port", trace), ("ref", jtrace)):
        clock = iter(np.arange(0.0, 100.0, 0.125)).__next__
        g = mod.GoodputRecorder(source, clock=clock,
                                writer=writer(mod, tmp_path / tag),
                                start_at=10.0)
        for method, args in goodput_script(3, source):
            getattr(g, method)(*args)
        recs[tag] = g
    port, ref = recs["port"], recs["ref"]
    assert lines(tmp_path / "port") == lines(tmp_path / "ref")
    assert port.snapshot() == ref.snapshot()
    assert port.seconds == ref.seconds
    assert port.wall_seconds() == ref.wall_seconds()
    assert port.accounted_seconds() == pytest.approx(port.wall_seconds())
    for cat in jtrace.GOODPUT_CATEGORIES[source]:
        labels = dict(source=source, category=cat)
        assert metrics.counter(trace.GOODPUT_FAMILY).value(**labels) == \
            jmetrics.counter(jtrace.GOODPUT_FAMILY).value(**labels)
    for mod in (trace, jtrace):
        with pytest.raises(ValueError, match="unknown goodput source"):
            mod.GoodputRecorder("gpu")
        with pytest.raises(ValueError, match="vocabulary"):
            mod.GoodputRecorder(source).transition("lunch")


# ---------------------------------------------------- merge + validators
def _files(tmp_path):
    """Valid, gapped, overlapping, foreign-vocabulary and malformed trace
    files, each written once and read by both packages."""
    out = {}
    w = writer(trace, tmp_path / "replica.jsonl")
    fr = trace.FlightRecorder(writer=w)
    g = trace.GoodputRecorder("serve", clock=lambda: 0.0, writer=w,
                              start_at=0.0)
    for method, args, kwargs in flight_script(9):
        getattr(fr, method)(*args, **kwargs)
    for method, args in goodput_script(9, "serve"):
        getattr(g, method)(*args)
    w.close()
    out["replica"] = w.path
    w = trace.TraceWriter(str(tmp_path / "router.jsonl"), "router",
                          clock=lambda: 1000.0, wall=lambda: 500.0, pid=3)
    w.event("route.place", 1003.0, trace="t1", replica="a", reason="affine")
    w.event("route.place", 1004.0, trace="t-lost", replica="a")
    w.close()
    out["router"] = w.path
    for name, segs in (("gap", [("step", 0.0, 1.0), ("idle", 1.5, 2.0)]),
                       ("overlap", [("step", 0.0, 1.0), ("idle", 0.5, 2.0)]),
                       ("foreign", [("lunch", 0.0, 1.0)])):
        w = writer(trace, tmp_path / f"{name}.jsonl", role="trainer")
        for cat, t0, t1 in segs:
            w.event("train.goodput", t0, t1 - t0, category=cat)
        w.event("serve.bogus", 3.0)
        w.close()
        out[name] = w.path
    (tmp_path / "no-meta.jsonl").write_text(json.dumps(
        {"type": "event", "name": "serve.step", "at": 1.0}) + "\n")
    (tmp_path / "bad.jsonl").write_text("{not json\n")
    (tmp_path / "empty.jsonl").write_text("")
    (tmp_path / "dup.jsonl").write_text(
        lines(out["router"])[0] + "\n" + lines(out["router"])[0] + "\n")
    (tmp_path / "odd.jsonl").write_text(
        lines(out["router"])[0] + "\n" + json.dumps({"type": "x"}) + "\n")
    for name in ("no-meta", "bad", "empty", "dup", "odd"):
        out[name] = str(tmp_path / f"{name}.jsonl")
    return out


def _same(fn_port, fn_ref, *args):
    """Both calls return equal values, or raise with equal messages."""
    try:
        want = fn_ref(*args)
    except jtrace.TraceMergeError as e:
        with pytest.raises(trace.TraceMergeError) as got:
            fn_port(*args)
        assert str(got.value) == str(e)
        return None
    assert fn_port(*args) == want
    return want


@pytest.mark.parametrize("fn", ["merge_trace_files", "validate_goodput_trace",
                                "summarize_goodput", "validate_chaos_trace"])
def test_merge_and_validators_match_reference(tmp_path, fn):
    f = _files(tmp_path)
    sets = [[f["replica"]], [f["replica"], f["router"]], [f["gap"]],
            [f["overlap"]], [f["foreign"]], [f["router"], f["gap"]]]
    sets += [[f[k]] for k in ("no-meta", "bad", "empty", "dup", "odd")]
    for paths in sets:
        got = _same(getattr(trace, fn), getattr(jtrace, fn), paths)
        if fn == "merge_trace_files" and got is not None:
            assert trace.validate_chrome_trace(got) == []
    assert trace.validate_goodput_trace([f["replica"]]) == []
    assert len(trace.validate_goodput_trace([f["gap"]])) == 1


def test_validate_chrome_trace_and_events_match_reference(tmp_path):
    docs = [[], {}, {"traceEvents": 3}, {"traceEvents": [
        {"ph": "X", "name": "x", "pid": 0, "tid": 0, "ts": 1.0},
        {"ph": "i", "name": "y", "pid": 0, "tid": 0, "ts": 1.0},
        {"ph": "Q", "name": "z", "pid": 0, "tid": 0, "ts": 1.0},
        {"ph": "X", "name": "", "pid": "a", "tid": 0, "ts": "t", "dur": -1},
        7]}]
    for doc in docs:
        assert trace.validate_chrome_trace(doc) == \
            jtrace.validate_chrome_trace(doc)
    evs = [{"name": "serve.goodput", "at": 0.0, "dur_s": 1.0,
            "fields": {"category": "decode"}},
           {"name": "serve.goodput", "at": 1.2, "dur_s": 1.0,
            "fields": {"category": "idle"}},
           {"name": "route.goodput", "at": 0.0, "dur_s": 1.0,
            "fields": {"category": "decode"}}]
    assert trace.validate_goodput_events("x", evs) == \
        jtrace.validate_goodput_events("x", evs)
    assert len(trace.validate_goodput_events("x", evs)) == 2


# ------------------------------------------------------- engine parity
CHURN = [
    ([5, 7, 9, 11, 2, 4, 6, 8], 16),
    ([3, 1, 4, 1, 5, 9, 2, 6], 16),
    ([2, 2, 2], 5),
    ([9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 1, 2, 3], 7),
]
ARRIVALS = {0: [0], 1: [1, 2], 3: [3]}
REPETITIVE = [([5, 7, 5, 7, 5, 7, 5, 7, 9], 12), ([2, 3] * 5, 10),
              ([1, 1, 1, 1, 1, 1], 8)]


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("llama-test")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("llama-test")
    model = from_numpy_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return (jparams, jcfg), (model, cfg)


def _run(engine, request_cls, prompts, arrivals):
    results, step = {}, 0
    while engine.has_work or step <= max(arrivals):
        for idx in arrivals.get(step, []):
            p, n = prompts[idx]
            engine.submit(request_cls(
                f"r{idx}", list(p), n,
                trace_id=f"trace{idx}" if idx % 2 else None))
        for d in engine.step():
            results[d.request_id] = d
        step += 1
        assert step < 500, "engine failed to drain"
    return results


SCENARIOS = {
    "whole-prompt": (dict(num_blocks=10, max_batch=3), CHURN, ARRIVALS),
    "chunked-prefix": (dict(num_blocks=10, max_batch=3, prefill_chunk=8,
                            prefix_cache=True), CHURN, ARRIVALS),
    "speculative": (dict(num_blocks=40, max_batch=3, spec_k=2),
                    REPETITIVE, {0: [0], 1: [1], 2: [2]}),
}


def _traced_run(mod, engine_cls, request_cls, clock_cls, params, cfg,
                path, engine_kw, prompts, arrivals, **extra):
    clock = clock_cls(tick=0.001)
    flight = mod.FlightRecorder(writer=writer(mod, path))
    eng = engine_cls(params, cfg, clock=clock, flight=flight,
                     block_size=4, max_model_len=32, **engine_kw, **extra)
    eng.goodput = mod.GoodputRecorder("serve", clock=clock,
                                      writer=flight.writer)
    done = _run(eng, request_cls, prompts, arrivals)
    eng.goodput.close()
    flight.writer.close()
    return eng, done


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_flight_records_match_jax_engine(models, tmp_path, scenario):
    (jparams, jcfg), (model, cfg) = models
    engine_kw, prompts, arrivals = SCENARIOS[scenario]
    jeng, want = _traced_run(jtrace, JServeEngine, JRequest, JClock,
                             jparams, jcfg, tmp_path / "ref", engine_kw,
                             prompts, arrivals)
    teng, got = _traced_run(trace, ServeEngine, Request, ManualClock,
                            model, cfg, tmp_path / "port", engine_kw,
                            prompts, arrivals, device="cpu")
    assert sorted(got) == sorted(want)
    for rid, d in want.items():
        g = got[rid]
        for attr in ("tokens", "finish_reason", "submitted_at",
                     "first_token_at", "finished_at", "preemptions",
                     "trace_id", "phases", "spec"):
            assert getattr(g, attr) == getattr(d, attr), (rid, attr)
        assert sum(g.phases.values()) == pytest.approx(
            g.finished_at - g.submitted_at, abs=1e-9)
    assert lines(tmp_path / "port") == lines(tmp_path / "ref")
    assert teng.goodput.snapshot() == jeng.goodput.snapshot()
    assert teng.stats()["tracing"] == jeng.stats()["tracing"]
    assert trace.validate_chaos_trace([str(tmp_path / "port")]) == []
    assert trace.validate_goodput_trace([str(tmp_path / "port")]) == []
    if scenario == "speculative":
        assert any(d.spec for d in got.values())
    else:
        assert any(d.preemptions for d in got.values())


def test_flight_off_changes_no_token_call_or_clock_read(models,
                                                        monkeypatch):
    (jparams, jcfg), (model, cfg) = models
    calls = {}
    for name in ("paged_decode_step", "paged_prefill_chunk",
                 "paged_verify_step", "paged_rewind"):
        fn = getattr(engine_mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(engine_mod, name, counted)
    kw = dict(block_size=4, max_model_len=32, num_blocks=10, max_batch=3,
              prefill_chunk=8, prefix_cache=True, spec_k=2)
    runs = []
    for flight in (None, trace.FlightRecorder()):
        calls.clear()
        clock = ManualClock(tick=0.001)
        eng = ServeEngine(model, cfg, clock=clock, flight=flight,
                          device="cpu", **kw)
        done = _run(eng, Request, CHURN + REPETITIVE,
                    {0: [0, 4], 1: [1, 2, 5], 3: [3, 6]})
        runs.append(({k: d.tokens for k, d in done.items()}, dict(calls),
                     clock.now))
    untraced, traced = runs
    assert untraced[0] == traced[0]
    assert untraced[1] == traced[1] and untraced[1]["paged_verify_step"]
    # The untraced port engine reads the clock exactly as often as the
    # untraced JAX engine (ManualClock advances once a read).
    jclock = JClock(tick=0.001)
    jeng = JServeEngine(jparams, jcfg, clock=jclock, **kw)
    _run(jeng, JRequest, CHURN + REPETITIVE,
         {0: [0, 4], 1: [1, 2, 5], 3: [3, 6]})
    assert untraced[2] == pytest.approx(jclock.now, abs=1e-12)
    assert traced[2] > untraced[2]


def test_abort_inflight_flushes_live_lifecycles(models, tmp_path):
    _, (model, cfg) = models
    flight = trace.FlightRecorder(writer=writer(trace, tmp_path / "t"))
    eng = ServeEngine(model, cfg, clock=ManualClock(tick=0.001),
                      flight=flight, block_size=4, num_blocks=10,
                      max_model_len=32, device="cpu")
    assert ServeEngine(model, cfg, device="cpu").abort_inflight("x") == 0
    eng.submit(Request("a", [1, 2, 3], 4))
    eng.submit(Request("b", [4, 5, 6], 4))
    eng.step()
    assert eng.abort_inflight("RuntimeError: died") == 2
    assert [r.outcome for r in flight.finished] == ["aborted", "aborted"]
    flight.writer.close()
    assert trace.validate_chaos_trace([str(tmp_path / "t")]) == []


# ------------------------------------------------------------- trainer
class TickClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        self.now += 0.01
        return self.now


def _categories(path):
    _, events = trace.read_trace_jsonl(str(path))
    return [e["fields"]["category"] for e in events
            if e["name"] == "train.goodput"]


def test_run_pipelined_goodput_partitions_the_loop(tmp_path):
    def step_fn(state, batch):
        state = state + batch
        return state, {"loss": state.sum(), "grad_norm": state.abs().sum()}

    w = writer(trace, tmp_path / "port", role="trainer")
    g = trace.GoodputRecorder("train", clock=TickClock(), writer=w)
    batches = [torch.full((2,), float(i)) for i in range(3)]
    state, report = run_pipelined(
        step_fn, torch.zeros(2), batches, sync_every=2, max_steps=5,
        goodput=g,
        goodput_step_category=lambda n: "compile" if n == 1 else "step")
    g.close()
    w.close()
    assert report.steps == 5 and report.sync_points == 3
    _, events = trace.read_trace_jsonl(str(tmp_path / "port"))
    assert trace.validate_goodput_events("loop", events) == []
    assert g.accounted_seconds() == pytest.approx(g.wall_seconds(),
                                                  abs=1e-9)
    windows = [e for e in events if e["name"] == "train.window"]
    assert [e["fields"]["steps"] for e in windows] == [2, 2, 1]
    assert [e["fields"]["loss"] for e in windows] == [
        report.losses[1], report.losses[3], report.losses[4]]
    # The reference loop books the same categories in the same order.
    jw = writer(jtrace, tmp_path / "ref", role="trainer")
    jclock = TickClock()
    jg = jtrace.GoodputRecorder("train", clock=jclock, writer=jw)

    def jstep(state, batch):
        state = state + batch
        return state, {"loss": state.sum(), "grad_norm": jnp.abs(
            state).sum()}

    jrun(jstep, jnp.zeros(2), [jnp.full((2,), float(i)) for i in range(3)],
         sync_every=2, max_steps=5, clock=jclock, goodput=jg,
         goodput_step_category=lambda n: "compile" if n == 1 else "step")
    jg.close()
    jw.close()
    assert _categories(tmp_path / "port") == _categories(tmp_path / "ref")
    assert _categories(tmp_path / "port")[:4] == [
        "idle", "data_wait", "compile", "data_wait"]


def test_trainer_trace_jsonl(tmp_path):
    from triton_kubernetes_tpu_torch.train import __main__ as train_main

    path = tmp_path / "train.jsonl"
    report = tmp_path / "report.json"
    assert train_main.main([
        "--device", "cpu", "--model", "llama-test", "--steps", "3",
        "--seq-len", "16", "--batch-size", "2", "--log-every", "2",
        "--trace-jsonl", str(path), "--report-json", str(report)]) == 0
    assert trace.validate_goodput_trace([str(path)]) == []
    _, events = trace.read_trace_jsonl(str(path))
    names = [e["name"] for e in events]
    assert names.count("train.compile") == 1
    assert names.count("train.window") == 2
    snap = json.loads(report.read_text())["goodput"]
    assert set(snap["seconds"]) <= {"step", "compile", "data_wait",
                                    "host_sync", "idle"}
    assert {"compile", "step"} <= set(snap["seconds"])
    assert sum(snap["seconds"].values()) == pytest.approx(snap["wall_s"],
                                                          abs=1e-6)


# --------------------------------------------------------- entry points
def _call(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = fn(argv)
    # The JSON error lines carry a wall-clock ts.
    return rc, out.getvalue(), re.sub(r'"ts": [0-9.]+', '"ts": 0',
                                      err.getvalue())


def test_tools_print_what_the_reference_verbs_print(tmp_path):
    f = _files(tmp_path)
    scrape = tmp_path / "metrics.txt"
    metrics.counter(trace.GOODPUT_FAMILY).inc(1.25, source="serve",
                                              category="decode")
    scrape.write_text(metrics.get_registry().render_prometheus())
    (tmp_path / "garbage.txt").write_text("not a {metric\n")
    out_port, out_ref = tmp_path / "p.json", tmp_path / "r.json"
    cases = [
        (["merge", f["replica"], f["router"], "-o", str(out_port)],
         ["trace", "merge", f["replica"], f["router"], "-o", str(out_ref)]),
        (["merge", str(tmp_path / "absent.jsonl"), "-o", str(out_port)],
         ["trace", "merge", str(tmp_path / "absent.jsonl"), "-o",
          str(out_ref)]),
        (["merge", f["bad"], "-o", str(out_port)],
         ["trace", "merge", f["bad"], "-o", str(out_ref)]),
    ]
    for p_args, r_args in cases:
        got = _call(trace_tool.main, p_args)
        want = _call(jcli, r_args)
        assert got[0] == want[0]
        assert got[1].replace(str(out_port), "OUT") == \
            want[1].replace(str(out_ref), "OUT")
        assert got[2] == want[2]
    assert json.loads(out_port.read_text()) == json.loads(
        out_ref.read_text())
    for args in ([f["replica"]], [f["replica"], f["router"]], [f["gap"]],
                 [f["empty"]], ["--metrics", str(scrape), f["replica"]],
                 ["--metrics", str(tmp_path / "garbage.txt"), f["replica"]]):
        for json_mode in ([], ["--json"]):
            got = _call(goodput_tool.main, ["report"] + json_mode + args)
            want = _call(jcli, json_mode + ["goodput", "report"] + args)
            assert got == want, args + json_mode
