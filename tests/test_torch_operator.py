"""Port parity for the reconcile operator (``operator/``) and the pieces
it drives: the state document, the executor on the simulated cloud, and
the pool repair.

The reference operates TPU slices (``gcp-tpu-nodepool`` modules keyed
``node_gcp-tpu_<cluster>_<pool>``); its port operates GPU pools
(``gcp-gpu-nodepool``, ``node_gcp-gpu_<cluster>_<pool>``). Every test
here runs the same inputs through both and compares after mapping
``gcp-tpu`` to ``gcp-gpu``. The operator is host code, so decisions are
compared exactly:

* ``MetricsWatcher`` on one sequence of Prometheus texts (baseline,
  partial scrape, counter reset, blind source);
* ``plan_rebalance``, ``TrainFleetPolicy`` and ``apply_decision`` on
  seeded inputs and the reference's cases;
* ``diff_states`` and ``compute_delta`` on equivalent documents;
* the whole ``Reconciler``: the reference over a TPU document and its
  cloud simulator, the port over the GPU twin, with one clock schedule,
  the same scrape callables and one preemption schedule. Per tick the
  journals agree (outcome, observation, decision, delta, rules run).
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json

import numpy as np
import pytest

from triton_kubernetes_tpu import operator as jop
from triton_kubernetes_tpu.backends import MemoryBackend as JMemoryBackend
from triton_kubernetes_tpu.executor import LocalExecutor as JLocalExecutor
from triton_kubernetes_tpu.executor import RetryPolicy as JRetryPolicy
from triton_kubernetes_tpu.executor import engine as jengine
from triton_kubernetes_tpu.executor import plan as jplan
from triton_kubernetes_tpu.executor.cloudsim import \
    CloudSimulator as JCloudSimulator
from triton_kubernetes_tpu.executor.dagspec import \
    document_from_spec as jdocument_from_spec
from triton_kubernetes_tpu.executor.engine import \
    load_executor_state as jload_state
from triton_kubernetes_tpu.executor.engine import \
    save_executor_state as jsave_state
from triton_kubernetes_tpu.operator import autoscaler as jautoscaler
from triton_kubernetes_tpu.operator import reconcile as jreconcile
from triton_kubernetes_tpu.utils import metrics as jmetrics
from triton_kubernetes_tpu.utils.logging import Logger as JLogger
from triton_kubernetes_tpu_torch import operator as pop
from triton_kubernetes_tpu_torch.backends import MemoryBackend
from triton_kubernetes_tpu_torch.executor import LocalExecutor, RetryPolicy
from triton_kubernetes_tpu_torch.executor import engine as pengine
from triton_kubernetes_tpu_torch.executor import plan as pplan
from triton_kubernetes_tpu_torch.executor.cloudsim import CloudSimulator
from triton_kubernetes_tpu_torch.executor.dagspec import document_from_spec
from triton_kubernetes_tpu_torch.executor.engine import (
    load_executor_state,
    save_executor_state,
)
from triton_kubernetes_tpu_torch.operator import autoscaler as pautoscaler
from triton_kubernetes_tpu_torch.operator import reconcile as preconcile
from triton_kubernetes_tpu_torch.utils import metrics
from triton_kubernetes_tpu_torch.utils.logging import Logger

# The observe modules (the packages export an ``observe`` function too).
jobserve = importlib.import_module("triton_kubernetes_tpu.operator.observe")
pobserve = importlib.import_module(
    "triton_kubernetes_tpu_torch.operator.observe")

TOPO = {"manager": {"provider": "bare-metal", "name": "m1"},
        "clusters": [{"provider": "gcp-tpu", "name": "ml",
                      "pools": [{"name": "pool0",
                                 "accelerator": "v5e-16"}]}]}
ASC = dict(ttft_slo_p99_s=0.5, queue_high=4.0, queue_low=1.0, min_pools=1,
           max_pools=3, scale_up_after=2, scale_down_after=3,
           cooldown_s=15.0)


@pytest.fixture(autouse=True)
def fresh_registries():
    """Fresh metrics registries, and both executors' in-process state
    stores emptied for the test and given back after it: the reference's
    own tests name their documents as these do."""
    saved = [dict(m._MEMORY_STATES) for m in (jengine, pengine)]
    for m in (jengine, pengine):
        m._MEMORY_STATES.clear()
    metrics.configure()
    jmetrics.configure()
    yield
    metrics.configure()
    jmetrics.configure()
    for m, kept in zip((jengine, pengine), saved):
        m._MEMORY_STATES.clear()
        m._MEMORY_STATES.update(kept)


def gpu_topo(topo):
    """The GPU twin of a reference topology spec: ``gcp-gpu`` clusters of
    ``h100-16`` pools (and jobsets) of the same names."""
    out = json.loads(json.dumps(topo))
    for cl in out.get("clusters", []):
        cl["provider"] = "gcp-gpu"
        for pool in cl.get("pools", []):
            pool["accelerator"] = "h100-16"
    return out


def twin(value):
    """A reference value (journal record, key list) in the port's key
    scheme: every ``gcp-tpu`` becomes ``gcp-gpu``."""
    if isinstance(value, str):
        return value.replace("gcp-tpu", "gcp-gpu")
    if isinstance(value, dict):
        return {twin(k): twin(v) for k, v in value.items()}
    if isinstance(value, tuple):
        return tuple(twin(v) for v in value)
    if isinstance(value, list):
        return [twin(v) for v in value]
    return value


class TickClock:
    """Deterministic reconcile clock: +dt per read."""

    def __init__(self, dt: float = 10.0):
        self.t = 0.0
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def quiet(executor_cls, logger_cls):
    return executor_cls(log=lambda m: None,
                        logger=logger_cls(stream=io.StringIO()))


def dead_source():
    raise ConnectionError("down")


class Side:
    """One package's world: document, backend, executor, reconciler."""

    def __init__(self, port, name, topo, autoscale, kw):
        self.port = port
        if port:
            doc = document_from_spec(gpu_topo(topo), name)
            self.backend = MemoryBackend()
            self.ex = quiet(LocalExecutor, Logger)
            op = pop
        else:
            doc = jdocument_from_spec(topo, name)
            self.backend = JMemoryBackend()
            self.ex = quiet(JLocalExecutor, JLogger)
            op = jop
        self.name = name
        self.backend.persist(doc)
        kw = dict(kw)
        kw.setdefault("clock", TickClock())
        kw.setdefault("sleep", lambda s: None)
        kw.setdefault("log", lambda m: None)
        if autoscale is not None:
            kw["autoscaler"] = op.Autoscaler(op.AutoscalerConfig(**autoscale))
            kw.setdefault("autoscale_cluster", "ml")
        self.rec = op.Reconciler(self.backend, self.ex, name, **kw)

    def key(self, key):
        return key.replace("gcp-tpu", "gcp-gpu") if self.port else key

    def doc(self):
        return self.backend.state(self.name)

    def pools(self):
        mod = pobserve if self.port else jobserve
        fn = (mod.gpu_pool_modules if self.port else mod.tpu_pool_modules)
        return fn(self.rec._load_doc()).get("ml", [])

    def preempt(self, slice_id):
        doc = self.rec._load_doc()
        if self.port:
            est = load_executor_state(doc)
            sim = CloudSimulator(est.cloud)
            sim.preempt_slice(slice_id)
            est.cloud = sim.to_dict()
            save_executor_state(doc, est)
        else:
            est = jload_state(doc)
            sim = JCloudSimulator(est.cloud)
            sim.preempt_slice(slice_id)
            est.cloud = sim.to_dict()
            jsave_state(doc, est)

    def edit(self, fn):
        """``fn(doc, key)`` edits the persisted document; ``key`` maps a
        reference key onto this side's."""
        doc = self.doc()
        fn(doc, self.key)
        self.backend.persist(doc)


def comparable(record):
    """A journal record without its error text (the pool repair's
    messages name their own labels)."""
    out = dict(record)
    out.pop("error", None)
    out["actions"] = [{k: v for k, v in a.items() if k != "error"}
                      for a in out["actions"]]
    return out


class Twin:
    """The reference's reconciler and the port's, ticked in lockstep on
    the same scrape callables. ``reg`` is the fleet registry the default
    source renders."""

    def __init__(self, name, topo=TOPO, autoscale=None, sources=None,
                 per_side=None, **kw):
        self.reg = metrics.MetricsRegistry()
        if sources is None:
            sources = [self.reg.render_prometheus]
        self.sides = []
        for port in (False, True):
            side_kw = dict(kw, metrics_sources=list(sources))
            if per_side is not None:
                side_kw.update(per_side(port))
            self.sides.append(Side(port, name, topo, autoscale, side_kw))
        self.ref, self.port = self.sides
        self.ticks = []

    def tick(self):
        r = self.ref.rec.tick()
        p = self.port.rec.tick()
        assert comparable(p.to_dict()) == comparable(twin(r.to_dict())), \
            f"tick {r.tick}"
        assert bool(p.error) == bool(r.error)
        self.ticks.append((r, p))
        return p

    def run(self, n):
        return [self.tick() for _ in range(n)]

    def preempt(self, slice_id):
        for s in self.sides:
            s.preempt(slice_id)

    def edit(self, fn):
        for s in self.sides:
            s.edit(fn)

    def pools(self):
        ref, port = self.ref.pools(), self.port.pools()
        assert port == twin(ref)
        return port


# -------------------------------------------------- the whole reconciler


def test_reconciler_converges_fresh_doc_then_noops():
    w = Twin("op-fresh")
    t1, t2 = w.run(2)
    assert t1.outcome == "acted"
    assert [a["rule"] for a in t1.actions] == ["converge-drift"]
    assert "node_gcp-gpu_ml_pool0" in t1.delta["to_apply"]
    assert t2.outcome == "noop" and w.port.rec.converged
    assert metrics.counter("tk8s_operator_reconciles_total").value(
        outcome="acted") == 1
    assert metrics.histogram(
        "tk8s_operator_reconcile_duration_seconds").count() == 2


def test_reconciler_repairs_preempted_pool_exactly_once():
    w = Twin("op-repair")
    w.run(2)
    w.preempt("ml-pool0")
    t = w.tick()
    assert t.delta["to_repair"] == [{"slice_id": "ml-pool0",
                                     "cluster": "ml", "pool": "pool0"}]
    assert t.actions == [{"rule": "replace-preempted-slice",
                          "targets": ["ml-pool0"], "ok": True}]
    assert w.tick().outcome == "noop"
    doc = w.port.rec._load_doc()
    assert w.port.ex.cloud_view(doc).preempted_slices() == {}
    assert load_executor_state(doc).cloud["preempt_history"] == {
        "ml-pool0": 1}
    assert metrics.counter("tk8s_repairs_total").value(
        kind="slice", outcome="ok") == 1


def test_reconciler_drains_orphans_and_dead_drained_pools():
    w = Twin("op-orphan")
    w.run(2)
    w.edit(lambda doc, k: doc.delete(f"module.{k('node_gcp-tpu_ml_pool0')}"))
    t = w.tick()
    assert [a["rule"] for a in t.actions] == ["drain-orphans"]
    assert w.tick().outcome == "noop"
    # A preempted pool whose module was drained is an orphan, not drift.
    w2 = Twin("op-dead-drain")
    w2.run(2)
    w2.preempt("ml-pool0")
    w2.edit(lambda doc, k: doc.delete(
        f"module.{k('node_gcp-tpu_ml_pool0')}"))
    t = w2.tick()
    assert t.delta["to_repair"] == []
    assert [a["rule"] for a in t.actions] == ["drain-orphans"]
    assert w2.tick().outcome == "noop"


def test_preempt_between_observe_and_act_converges_next_tick():
    fired = {False: [], True: []}

    def per_side(port):
        def hook(observed):
            side = w.sides[port]
            if not fired[port] and side.rec.journal:
                side.preempt("ml-pool0")
                fired[port].append(True)
        return {"between_observe_and_act": hook}

    w = Twin("op-midtick", per_side=per_side)
    w.tick()
    t2 = w.tick()
    assert t2.delta["to_repair"] == [] and t2.outcome == "noop"
    t3 = w.tick()
    assert [a["rule"] for a in t3.actions] == ["replace-preempted-slice"]
    assert w.tick().outcome == "noop"


def test_preempted_hand_keyed_pool_fails_loudly_in_both():
    def hand_key(doc, k):
        cfg = dict(doc.get(f"module.{k('node_gcp-tpu_ml_pool0')}"))
        cfg["pool_name"] = "aux"
        doc.set("module.mypool", cfg)

    w = Twin("op-handkey")
    w.edit(hand_key)
    w.run(2)
    w.preempt("ml-aux")
    t = w.tick()
    assert t.delta["to_repair"] == [{"slice_id": "ml-aux",
                                     "cluster": "ml", "pool": "aux"}]
    assert t.outcome == "failed" and "ml-aux" in t.error


def test_autoscaler_grows_after_hysteresis_and_respects_max():
    w = Twin("as-grow", autoscale=ASC)
    w.tick()
    q = w.reg.gauge("tk8s_serve_queue_depth")
    q.set(10.0)
    directions = [t.decision["direction"] for t in w.run(8)]
    assert directions.count("grow") == 2 and directions[0] == "hold"
    assert w.pools() == ["node_gcp-gpu_ml_pool0", "node_gcp-gpu_ml_pool1",
                         "node_gcp-gpu_ml_pool2"]
    doc = w.port.rec._load_doc()
    assert "node_gcp-gpu_ml_pool2" in load_executor_state(doc).modules
    cfg = doc.get("module.node_gcp-gpu_ml_pool2")
    assert (cfg["gpu_accelerator"], cfg["pool_name"]) == ("h100-16",
                                                          "pool2")
    assert metrics.gauge("tk8s_operator_pools").value(cluster="ml") == 3


def test_autoscaler_ttft_breach_uses_windowed_p99():
    w = Twin("as-ttft", autoscale=ASC)
    w.tick()
    h = w.reg.histogram("tk8s_serve_ttft_seconds")
    for _ in range(50):
        h.observe(3.0)
    w.tick()
    for _ in range(50):
        h.observe(0.05)
    t = w.tick()
    assert t.observed["ttft_p99_s"] <= 0.5
    for _ in range(10):
        h.observe(3.0)
    t = w.tick()
    assert t.observed["ttft_p99_s"] > 0.5


def test_autoscaler_drains_on_calm_and_risk_floor_blocks_after_preempts():
    w = Twin("as-drain", autoscale=ASC)
    w.tick()
    q = w.reg.gauge("tk8s_serve_queue_depth")
    q.set(10.0)
    w.run(3)
    assert len(w.pools()) == 2
    q.set(0.0)
    assert "drain" in [t.decision["direction"] for t in w.run(6)]
    assert w.pools() == ["node_gcp-gpu_ml_pool0"]
    q.set(10.0)
    w.run(3)
    w.preempt("ml-pool0")
    assert w.tick().decision["reason"] == "repair-first"
    q.set(0.0)
    assert "risk-floor" in [t.decision["reason"] for t in w.run(3)]
    w.run(6)
    assert w.pools() == ["node_gcp-gpu_ml_pool0"]


def test_autoscaler_holds_blind_and_repair_first():
    w = Twin("as-blind", autoscale={}, sources=[dead_source])
    w.tick()
    assert w.tick().decision == {"direction": "hold", "reason": "no-signal",
                                 "pools": 1, "cluster": "ml",
                                 "detail": "0/1 sources answered",
                                 "risk": 0.0}
    w2 = Twin("as-first", autoscale={})
    w2.reg.gauge("tk8s_serve_queue_depth").set(50.0)
    w2.tick()
    w2.preempt("ml-pool0")
    assert w2.tick().decision["reason"] == "repair-first"


def _flaky_apply(side, fail):
    real = side.ex.apply

    def apply(doc, targets=None, parallelism=None):
        if fail(targets):
            raise RuntimeError("control plane 500")
        return real(doc, targets=targets, parallelism=parallelism)

    side.ex.apply = apply
    return real


def test_failed_scale_actuation_does_not_consume_cooldown():
    w = Twin("as-fail", autoscale=dict(ASC, scale_up_after=1,
                                       cooldown_s=1000.0))
    w.tick()
    w.reg.gauge("tk8s_serve_queue_depth").set(50.0)
    armed = {False: [True], True: [True]}
    for side in w.sides:
        flags = armed[side.port]
        _flaky_apply(side, lambda t, f=flags: bool(f) and f.pop())
    t = w.tick()
    assert t.decision["direction"] == "grow" and t.outcome == "failed"
    assert metrics.gauge("tk8s_operator_pools").value(cluster="ml") == 1
    t = w.tick()
    assert t.decision["direction"] == "grow" and t.outcome == "acted"
    assert w.tick().decision["reason"] == "cooldown"


def test_calm_with_no_drainable_clone_holds():
    topo = {"manager": {"provider": "bare-metal", "name": "m1"},
            "clusters": [{"provider": "gcp-tpu", "name": "ml",
                          "pools": [{"name": "alpha",
                                     "accelerator": "v5e-16"},
                                    {"name": "beta",
                                     "accelerator": "v5e-16"}]}]}
    w = Twin("as-nodrain", topo=topo,
             autoscale=dict(min_pools=1, max_pools=3, scale_down_after=1))
    w.reg.gauge("tk8s_serve_queue_depth").set(0.0)
    w.tick()
    for t in w.run(3):
        assert t.decision["reason"] == "nothing-drainable"


def test_drain_persisted_by_converge_still_arms_cooldown():
    topo = {"manager": {"provider": "bare-metal", "name": "m1"},
            "clusters": [{"provider": "gcp-tpu", "name": "ml",
                          "pools": [{"name": f"pool{i}",
                                     "accelerator": "v5e-16"}
                                    for i in range(3)]}]}
    w = Twin("as-drain-persist", topo=topo,
             autoscale=dict(ASC, scale_up_after=99, scale_down_after=1,
                            cooldown_s=1000.0))
    q = w.reg.gauge("tk8s_serve_queue_depth")
    q.set(10.0)
    w.tick()

    def drift(doc, k):
        key = f"module.{k('node_gcp-tpu_ml_pool0')}"
        cfg = dict(doc.get(key))
        cfg["auto_repair"] = False
        doc.set(key, cfg)

    w.edit(drift)
    reals = [_flaky_apply(s, lambda t: bool(t) and any("pool2" in x
                                                       for x in t))
             for s in w.sides]
    q.set(0.0)
    t = w.tick()
    assert t.decision["direction"] == "drain" and t.outcome == "failed"
    assert {a["rule"]: a["ok"] for a in t.actions} == {
        "converge-drift": True, "drain-orphans": False}
    for side, real in zip(w.sides, reals):
        side.ex.apply = real
    t = w.tick()
    assert t.decision["reason"] == "cooldown"
    assert [a["rule"] for a in t.actions] == ["drain-orphans"]


def test_rebalance_and_train_fleet_legs_journal_alike():
    """Two replicas' KV utilization drives one migration a tick through
    an injected rebalancer, and a train-fleet status sequence drives
    replace, shrink, regrow and hold through an injected actuator."""
    regs = [metrics.MetricsRegistry(), metrics.MetricsRegistry()]
    statuses = iter([])
    current = {}

    def per_side(port):
        op = pop if port else jop

        def status():
            s = current.get("status")
            return None if s is None else op.TrainFleetStatus.from_dict(s)

        return {"rebalancer": lambda d: {"status": "ok",
                                         "request_id": f"r{d.source}"},
                "train_policy": op.TrainFleetPolicy(op.TrainFleetConfig(
                    desired_workers=2, min_workers=1,
                    regrow_cooldown_s=15.0, serve_queue_high=8.0,
                    ttft_slo_p99_s=0.5)),
                "train_status": status,
                "train_actuator": lambda d: {"status": "ok"}}

    w = Twin("op-legs", sources=[r.render_prometheus for r in regs],
             rebalance_gap=0.2, rebalance_high=0.5, per_side=per_side)
    del statuses
    plan = [
        ((0.1, 0.1), 0, None),
        ((0.9, 0.1), 0, dict(running_workers=0, capacity_workers=2)),
        ((0.9, 0.6), 0, dict(running_workers=0, capacity_workers=1)),
        ((0.3, 0.95), 0, dict(running_workers=1, capacity_workers=2)),
        ((0.3, 0.95), 12, dict(running_workers=1, capacity_workers=2)),
        ((0.3, 0.3), 0, dict(running_workers=1, capacity_workers=2)),
        ((0.3, 0.3), 0, dict(running_workers=2, capacity_workers=2)),
        ((0.3, 0.3), 0, dict(running_workers=2, capacity_workers=2,
                             done=True)),
    ]
    for (u0, u1), queue, status in plan:
        regs[0].gauge("tk8s_serve_kv_block_utilization").set(u0)
        regs[1].gauge("tk8s_serve_kv_block_utilization").set(u1)
        regs[0].gauge("tk8s_serve_queue_depth").set(queue)
        current["status"] = status
        w.tick()
    moves = [(a["source"], a["target"]) for _, t in w.ticks
             for a in t.actions if a["rule"] == "rebalance"]
    assert (0, 1) in moves and (1, 0) in moves
    dirs = [t.train_decision["direction"] for _, t in w.ticks]
    assert {"replace", "shrink", "regrow", "hold"} <= set(dirs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reconciler_journals_agree_over_a_seeded_schedule(seed, tmp_path):
    """Forty ticks of seeded traffic (queue depth, TTFT observations, KV
    pressure), preemptions and out-of-band pool deletions, with the
    autoscaler, the rebalancer and the train fleet all wired: the two
    journals (and their JSONL files) agree tick by tick."""
    rng = np.random.default_rng(seed)
    regs = [metrics.MetricsRegistry(), metrics.MetricsRegistry()]
    current = {}

    def per_side(port):
        op = pop if port else jop
        journal = tmp_path / f"{'port' if port else 'ref'}.jsonl"

        def status():
            s = current.get("status")
            return None if s is None else op.TrainFleetStatus.from_dict(s)

        return {"rebalancer": lambda d: {"status": "ok"},
                "train_policy": op.TrainFleetPolicy(op.TrainFleetConfig(
                    desired_workers=2, regrow_cooldown_s=25.0)),
                "train_status": status,
                "train_actuator": lambda d: {"status": "ok"},
                "journal_path": str(journal)}

    w = Twin(f"op-seed{seed}", autoscale=dict(ASC, scale_up_after=1,
                                               scale_down_after=2,
                                               cooldown_s=25.0),
             sources=[r.render_prometheus for r in regs],
             rebalance_gap=0.3, per_side=per_side)
    for _ in range(40):
        for reg in regs:
            reg.gauge("tk8s_serve_queue_depth").set(
                float(rng.choice([0, 0, 2, 6, 12])))
            reg.gauge("tk8s_serve_kv_block_utilization").set(
                float(rng.uniform(0, 1)))
            for _ in range(int(rng.integers(0, 6))):
                reg.histogram("tk8s_serve_ttft_seconds").observe(
                    float(rng.choice([0.01, 0.2, 0.7, 2.0])))
        current["status"] = (None if rng.uniform() < 0.2 else dict(
            running_workers=int(rng.integers(0, 3)),
            capacity_workers=int(rng.integers(0, 3))))
        pools = w.pools()
        if pools and rng.uniform() < 0.15:
            pool = w.port.rec._load_doc().get(
                f"module.{pools[int(rng.integers(len(pools)))]}")
            applied = load_executor_state(w.port.rec._load_doc()).modules
            if any(k.endswith(pool["pool_name"]) for k in applied):
                try:
                    w.port.preempt(f"ml-{pool['pool_name']}")
                except Exception:
                    pass
                else:
                    w.ref.preempt(f"ml-{pool['pool_name']}")
        if len(pools) > 1 and rng.uniform() < 0.05:
            victim = pools[-1].replace("gcp-gpu", "gcp-tpu")
            w.edit(lambda doc, k, v=victim: doc.delete(f"module.{k(v)}"))
        w.tick()
    ref = [comparable(json.loads(line)) for line in
           (tmp_path / "ref.jsonl").read_text().splitlines()]
    port = [comparable(json.loads(line)) for line in
            (tmp_path / "port.jsonl").read_text().splitlines()]
    assert port == twin(ref) and len(port) == 40
    outcomes = {t.outcome for _, t in w.ticks}
    assert "acted" in outcomes
    assert any(t.delta["to_repair"] for _, t in w.ticks)


# ------------------------------------------------------------- the parts


def test_watcher_samples_agree_on_one_sequence_of_texts():
    """Baseline, a partial scrape, the source's return, a counter reset
    (a restarted replica), goodput counters and KV gauges, and a blind
    source: every ServingSample field is the reference's."""
    regs = [metrics.MetricsRegistry(), metrics.MetricsRegistry()]
    flaky = {"down": False}

    def src0():
        return regs[0].render_prometheus()

    def src1():
        if flaky["down"]:
            raise ConnectionError("scrape timeout")
        return regs[1].render_prometheus()

    watchers = (jop.MetricsWatcher([src0, src1, dead_source]),
                pop.MetricsWatcher([src0, src1, dead_source]))
    samples = []

    def sample():
        j, p = (w.sample() for w in watchers)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        for prop in ("blind", "has_signal", "goodput_accounted_s",
                     "goodput_useful_fraction", "goodput_waste_fraction"):
            assert getattr(p, prop) == getattr(j, prop)
        samples.append(p)
        return p

    def observe(i, values):
        for v in values:
            regs[i].histogram("tk8s_serve_ttft_seconds").observe(v)

    for i in range(2):
        observe(i, [3.0] * 20)
    assert sample().window_requests == 0
    flaky["down"] = True
    observe(0, [0.01] * 5)
    regs[0].gauge("tk8s_serve_queue_depth").set(3.0)
    s = sample()
    assert (s.sources_ok, s.window_requests) == (1, 5)
    flaky["down"] = False
    observe(1, [0.02, 0.9, 4.0])
    regs[1].gauge("tk8s_serve_kv_block_utilization").set(0.8)
    regs[1].gauge("tk8s_serve_kv_bytes").set(1e6, component="pages")
    regs[1].counter("tk8s_goodput_seconds_total").inc(
        2.0, source="serve", category="decode")
    regs[1].counter("tk8s_goodput_seconds_total").inc(
        1.0, source="serve", category="idle")
    assert sample().window_requests == 3
    regs[1].counter("tk8s_goodput_seconds_total").inc(
        3.0, source="serve", category="decode")
    regs[0] = metrics.MetricsRegistry()
    observe(0, [0.03])
    s = sample()
    assert s.goodput_accounted_s == 3.0
    observe(0, [0.04, 0.05])
    assert sample().window_requests == 2
    blind = [w.sample() for w in (jop.MetricsWatcher([dead_source]),
                                  pop.MetricsWatcher([dead_source]))]
    assert blind[1].blind and dataclasses.asdict(blind[1]) == \
        dataclasses.asdict(blind[0])


def test_ttft_buckets_of_both_registries_are_pinned_equal():
    """The autoscaler's windowed TTFT p99 is quantiled over bucket deltas:
    a change to the port's serving buckets would shift its decisions."""
    assert metrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    for name in ("tk8s_serve_ttft_seconds",
                 "tk8s_operator_reconcile_duration_seconds"):
        assert metrics.CATALOG[name][3] == jmetrics.CATALOG[name][3]
        assert metrics.CATALOG[name][:3] == jmetrics.CATALOG[name][:3] \
            or name != "tk8s_serve_ttft_seconds"
    for name, entry in jmetrics.CATALOG.items():
        if name.startswith("tk8s_operator_"):
            assert metrics.CATALOG[name][0] == entry[0]
            assert metrics.CATALOG[name][2] == entry[2]


@pytest.mark.parametrize("seed", range(4))
def test_plan_rebalance_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(0, 5))
        util = {int(i): float(rng.choice([rng.uniform(), 0.5, 0.9]))
                for i in rng.permutation(6)[:n]}
        kw = dict(gap_threshold=float(rng.choice([0.0, 0.1, 0.3, -1.0])),
                  high_watermark=float(rng.choice([0.5, 0.75])))
        j = jop.plan_rebalance(util, **kw)
        p = pop.plan_rebalance(util, **kw)
        assert (p is None) == (j is None)
        if p is not None:
            assert p.to_dict() == j.to_dict()


@pytest.mark.parametrize("seed", range(4))
def test_train_fleet_policy_matches_reference(seed):
    """Replace, shrink, regrow and hold (every reason) over seeded
    statuses, serving samples and landed or failed actuations."""
    rng = np.random.default_rng(seed)
    cfg = dict(desired_workers=int(rng.integers(1, 4)),
               min_workers=1, regrow_cooldown_s=20.0,
               serve_queue_high=8.0,
               ttft_slo_p99_s=float(rng.choice([0.0, 0.5])))
    pols = (jop.TrainFleetPolicy(jop.TrainFleetConfig(**cfg)),
            pop.TrainFleetPolicy(pop.TrainFleetConfig(**cfg)))
    seen = set()
    now = 0.0
    for _ in range(300):
        now += float(rng.uniform(0, 10))
        status = None if rng.uniform() < 0.1 else dict(
            running_workers=int(rng.integers(0, 4)),
            capacity_workers=int(rng.integers(0, 4)),
            step=int(rng.integers(0, 100)), done=bool(rng.uniform() < 0.05))
        serving = dict(sources_total=int(rng.integers(0, 3)),
                       queue_depth=float(rng.choice([0, 4, 9])),
                       ttft_p99_s=float(rng.choice([0.1, 0.9])),
                       window_requests=int(rng.integers(0, 3)))
        serving["sources_ok"] = int(rng.integers(0, serving[
            "sources_total"] + 1))
        out = []
        for op, pol in zip((jop, pop), pols):
            st = (None if status is None
                  else op.TrainFleetStatus.from_dict(status))
            if st is not None:
                assert st.to_dict() == op.TrainFleetStatus.from_dict(
                    st.to_dict()).to_dict()
            out.append(pol.decide(st, op.ServingSample(**serving),
                                  now).to_dict())
        assert out[1] == out[0]
        seen.add((out[1]["direction"], out[1]["reason"]))
        if out[1]["direction"] != "hold":
            ok = bool(rng.uniform() < 0.8)
            for pol in pols:
                pol.record_actuation(ok, now)
    assert {d for d, _ in seen} == {"replace", "shrink", "regrow", "hold"}


def test_apply_decision_matches_reference_cases():
    """Grow clones the template under the next free pool<N>; drain is
    LIFO by numeric N and never takes the template, a hand-named pool or
    a hand-keyed module."""
    def both(topo, name):
        return jdocument_from_spec(topo, name), document_from_spec(
            gpu_topo(topo), name)

    def step(docs, direction, pools=2):
        jdoc, pdoc = docs
        jkeys = jobserve.tpu_pool_modules(jdoc).get("ml", [])
        pkeys = pobserve.gpu_pool_modules(pdoc).get("ml", [])
        assert pkeys == twin(jkeys)
        out = [mod.apply_decision(doc, mod.ScaleDecision(
            direction, "x", pools, "ml"), keys) for mod, doc, keys in
            ((jautoscaler, jdoc, jkeys), (pautoscaler, pdoc, pkeys))]
        assert out[1] == twin(out[0])
        assert pautoscaler.drain_candidates(pkeys, "ml") == twin(
            jautoscaler.drain_candidates(jkeys, "ml"))
        return out[1]

    docs = both(TOPO, "ad")
    assert step(docs, "grow") == "node_gcp-gpu_ml_pool1"
    assert step(docs, "grow") == "node_gcp-gpu_ml_pool2"
    assert step(docs, "hold") is None
    assert step(docs, "drain") == "node_gcp-gpu_ml_pool2"
    assert step(docs, "drain") == "node_gcp-gpu_ml_pool1"
    assert step(docs, "drain") is None
    human = {"manager": TOPO["manager"], "clusters": [
        {"provider": "gcp-tpu", "name": "ml",
         "pools": [{"name": "serving", "accelerator": "v5e-16"}]}]}
    docs = both(human, "ad-human")
    assert step(docs, "grow") == "node_gcp-gpu_ml_pool1"
    assert step(docs, "drain") == "node_gcp-gpu_ml_pool1"
    docs = both(TOPO, "ad-num")
    for jdoc, k in zip(docs, ("gcp-tpu", "gcp-gpu")):
        for name in ("pool2", "pool10"):
            cfg = dict(jdoc.get(f"module.node_{k}_ml_pool0"))
            cfg["pool_name"] = name
            jdoc.set(f"module.node_{k}_ml_{name}", cfg)
    assert step(docs, "drain") == "node_gcp-gpu_ml_pool10"
    docs = both(TOPO, "ad-handkey")
    for jdoc, k in zip(docs, ("gcp-tpu", "gcp-gpu")):
        cfg = dict(jdoc.get(f"module.node_{k}_ml_pool0"))
        cfg["pool_name"] = "aux"
        jdoc.set("module.mypool", cfg)
    assert step(docs, "drain") == "node_gcp-gpu_ml_pool0"


def test_autoscaler_config_validation_matches_reference():
    for bad in (dict(min_pools=0), dict(min_pools=3, max_pools=2),
                dict(risk_decay=1.0), dict(scale_up_after=0)):
        msgs = []
        for op in (jop, pop):
            with pytest.raises(ValueError) as err:
                op.Autoscaler(op.AutoscalerConfig(**bad))
            msgs.append(str(err.value))
        assert msgs[1] == msgs[0]


@pytest.mark.parametrize("seed", range(3))
def test_diff_states_matches_reference_on_twin_documents(seed):
    rng = np.random.default_rng(seed)
    names = ["cluster-manager", "cluster_gcp-tpu_ml", "node_gcp-tpu_ml_p0",
             "node_gcp-tpu_ml_p1", "job_ml_j0"]
    for _ in range(50):
        desired = {n: {"source": n, "v": int(rng.integers(0, 2))}
                   for n in names if rng.uniform() < 0.7}
        applied = {n: {"config": {"source": n, "v": int(rng.integers(0, 2))}}
                   for n in names if rng.uniform() < 0.7}
        targets = (None if rng.uniform() < 0.5
                   else [n for n in names if rng.uniform() < 0.5])
        j = jplan.diff_states(desired, applied, targets)
        p = pplan.diff_states(twin(desired), twin(applied), twin(targets))
        assert {k: a.value for k, a in p.actions.items()} == twin(
            {k: a.value for k, a in j.actions.items()})
        assert p.summary() == j.summary()


def test_observe_and_compute_delta_match_reference():
    topo = {"manager": TOPO["manager"], "clusters": [
        {"provider": "gcp-tpu", "name": "ml",
         "pools": [{"name": "pool0", "accelerator": "v5e-16"},
                   {"name": "pool1", "accelerator": "v5e-16"}],
         "jobsets": [{"name": "j0", "pool": "pool0"}]}]}
    w = Twin("obs", topo=topo)

    def delta(side):
        mod = preconcile if side.port else jreconcile
        obs_mod = pobserve if side.port else jobserve
        obs = obs_mod.observe(side.rec._load_doc(), side.ex, None)
        return obs, mod.compute_delta(obs).to_dict()

    (jo, jd), (po, pd) = delta(w.ref), delta(w.port)
    assert pd == twin(jd) and "job_ml_j0" in pd["to_apply"]
    assert po.to_apply == twin(jo.to_apply)
    w.run(2)
    w.preempt("ml-pool1")
    w.edit(lambda doc, k: doc.delete(f"module.{k('node_gcp-tpu_ml_pool0')}"))
    (jo, jd), (po, pd) = delta(w.ref), delta(w.port)
    assert pd == twin(jd)
    assert pd["to_repair"] == [{"slice_id": "ml-pool1", "cluster": "ml",
                                "pool": "pool1"}]
    assert po.to_prune == twin(jo.to_prune) == ["node_gcp-gpu_ml_pool0"]
    assert po.preempt_history == jo.preempt_history == {"ml-pool1": 1}


# ------------------------------------------- the executor: faults, width

FAN_TOPO = {"manager": TOPO["manager"], "clusters": [
    {"provider": "gcp-tpu", "name": name,
     "pools": [{"name": f"pool{i}", "accelerator": "v5e-16"}
               for i in range(3)],
     "jobsets": [{"name": f"j{i}", "pool": f"pool{i}"} for i in range(2)]}
    for name in ("ml", "ed")]}

# The journal's fields that do not depend on wall time or interleaving.
JOURNAL_FIELDS = ("version", "kind", "order", "parallelism", "wave",
                  "waves", "completed", "retries", "backoff_total",
                  "failed", "status")


def applied(port, topo, name, parallelism, driver=None, max_retries=3):
    """Apply the twin of ``topo`` (or ``topo`` itself on the reference)
    once; returns (error text or None, journal fields, executor state,
    backoff sleeps)."""
    sleeps = []
    if port:
        doc = document_from_spec(gpu_topo(topo), name, driver=driver)
        ex = LocalExecutor(log=lambda m: None,
                           logger=Logger(stream=io.StringIO()),
                           retry=RetryPolicy(max_retries=max_retries),
                           sleep=sleeps.append, parallelism=parallelism)
        load = load_executor_state
    else:
        doc = jdocument_from_spec(topo, name, driver=driver)
        ex = JLocalExecutor(log=lambda m: None,
                            logger=JLogger(stream=io.StringIO()),
                            retry=JRetryPolicy(max_retries=max_retries),
                            sleep=sleeps.append, parallelism=parallelism)
        load = jload_state
    err = None
    try:
        ex.apply(doc)
    except Exception as e:  # the journal records what failed
        err = type(e).__name__
    est = load(doc)
    journal = {k: est.journal.get(k) for k in JOURNAL_FIELDS}
    if journal["failed"] is not None:
        journal["failed"] = {k: v for k, v in journal["failed"].items()
                             if k != "error"}
    return err, journal, est, sleeps


@pytest.mark.parametrize("case", ["retried", "fatal", "exhausted"])
def test_fault_plan_firings_and_retry_journal_match_reference(case):
    """One fault plan (a boot flake on the first ``pool1``, a quota
    refusal on the first ``pool2``, ``ml-pool0`` preempted at mutation
    40) through the reference's executor on the TPU
    document and the port's on its GPU twin, serially: the same error
    class, the same journal (completed modules, retries, backoff, the
    failed module and its kind), the same backoff sleeps, the same fired
    counts and the same preemption history."""
    faults = [{"op": "create_node_pool", "match": {"pool": "pool1"},
               "times": 2, "error": "instance boot failed"},
              {"op": "preempt", "slice_id": "ml-pool0", "at_op": 40}]
    if case == "fatal":
        faults.append({"op": "create_node_pool", "match": {"pool": "pool2"},
                       "kind": "fatal", "error": "quota exceeded"})
    driver = {"name": "sim", "fault_plan": {"faults": faults}}
    retries = 1 if case == "exhausted" else 3
    ref = applied(False, FAN_TOPO, f"faults-{case}", 1, driver, retries)
    port = applied(True, FAN_TOPO, f"faults-{case}", 1, driver, retries)
    assert port[0] == ref[0]
    assert port[1] == twin(ref[1])
    assert port[3] == ref[3]
    fired = [[r["fired"] for r in est.cloud["fault_plan"]["faults"]]
             for est in (ref[2], port[2])]
    assert fired[1] == fired[0]
    assert (port[2].cloud.get("preempt_history")
            == ref[2].cloud.get("preempt_history"))
    assert sorted(port[2].modules) == sorted(twin(list(ref[2].modules)))
    want = {"retried": (None, {"node_gcp-tpu_ed_pool1": 2}),
            "fatal": ("FatalApplyError", {"node_gcp-tpu_ed_pool1": 2}),
            "exhausted": ("TransientApplyError",
                          {"node_gcp-tpu_ed_pool1": 1})}[case]
    assert (ref[0], ref[1]["retries"]) == want
    if case == "retried":
        assert ref[2].cloud["preempt_history"] == {"ml-pool0": 1}


def test_wavefront_at_width_four_matches_reference_and_serial():
    """The width ``tools.operate`` applies at: a fan-out document of two
    clusters, six pools and four jobsets, with a transient fault on one
    pool, applied at parallelism 4 by the reference on the TPU document
    and by the port on its twin. Their journals agree (order, waves,
    completed, retries, backoff), and the port's applied modules and
    cloud are byte-identical to its own serial apply's."""
    driver = {"name": "sim", "fault_plan": {"faults": [
        {"op": "create_node_pool", "match": {"cluster": "ml",
                                             "pool": "pool2"},
         "times": 1, "error": "503 service unavailable"}]}}
    ref = applied(False, FAN_TOPO, "fan-4", 4, driver)
    port = applied(True, FAN_TOPO, "fan-4", 4, driver)
    serial = applied(True, FAN_TOPO, "fan-1", 1, driver)
    assert ref[0] is None and port[0] is None
    assert port[1] == twin(ref[1])
    assert port[1]["parallelism"] == 4 and port[1]["waves"] == 4
    assert port[1]["retries"] == {"node_gcp-gpu_ml_pool2": 1}
    assert port[3] == ref[3] == [0.5]
    assert sorted(port[2].modules) == sorted(twin(list(ref[2].modules)))
    assert json.dumps(port[2].modules, sort_keys=True) == json.dumps(
        serial[2].modules, sort_keys=True)
    assert json.dumps(port[2].cloud, sort_keys=True) == json.dumps(
        serial[2].cloud, sort_keys=True)
    assert dict(port[1], parallelism=1) == serial[1]
