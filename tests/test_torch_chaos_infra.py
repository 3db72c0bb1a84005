"""The infra half of the port's chaos harness against the reference's, on
the CPU.

The port runs each spec's GPU twin (``chaos.generator.twin_spec``:
``gcp-gpu`` clusters of ``h100-16`` pools) where the reference runs the
TPU spec, so every comparison here is made on the same spec:

* **the twin** -- what ``twin_spec`` rewrites, that it is idempotent and
  that it refuses a TPU accelerator with no twin;
* **the corpus** -- the 11 infra-only entries replay with the reference's
  verdict, ``checked`` list, violations and stats; ``ref_ops``,
  ``kill_at_op`` and ``simulated_seconds`` differ by the TPU pool's three
  fixed-name DaemonSet deletes, which the GPU pool does not issue
  (``_assert_same_verdict`` holds each to that cause);
* **sweeps** -- 20 seeds of each infra profile, verdict, ``checked`` and
  stats as for the corpus;
* **the executor seams** -- ``FaultPlan``'s new keys refused as the
  reference refuses them, module anchors at widths 1, 2 and 8, a
  graceful-warning reclaim that signals a child process, the kill hook
  through retry and resume at widths 1 and 8, ``op_latency`` accounting,
  the fingerprints;
* **the provider modules** -- each family's applied modules and cloud
  byte-equal to the reference's;
* **shrinking** -- ``mutation-unfaulted-reference`` shrinks to the
  reference's minimal spec;
* **the command line** -- ``tools.chaos`` defaults to ``default``;
* **the soak round** -- apply, train, preempt, repair, resume at
  ``llama-test``, the four losses held to four JAX steps on carried-over
  parameters and bitwise the port's uninterrupted run's.

Cost: about 30 s in one worker.
"""

from __future__ import annotations

import copy
import io
import json
import os
import subprocess
import sys

import pytest

from triton_kubernetes_tpu.chaos import corpus as jcorpus
from triton_kubernetes_tpu.chaos import runner as jrunner
from triton_kubernetes_tpu.chaos import shrink as jshrink
from triton_kubernetes_tpu.executor import LocalExecutor as JLocalExecutor
from triton_kubernetes_tpu.executor import RetryPolicy as JRetryPolicy
from triton_kubernetes_tpu.executor import engine as jengine
from triton_kubernetes_tpu.executor.cloudsim import \
    CloudSimulator as JCloudSimulator
from triton_kubernetes_tpu.executor.cloudsim import \
    FaultPlanError as JFaultPlanError
from triton_kubernetes_tpu.executor.cloudsim import \
    SimulatedKillError as JSimulatedKillError
from triton_kubernetes_tpu.executor.dagspec import \
    document_from_spec as jdocument_from_spec
from triton_kubernetes_tpu.executor.drivers import \
    driver_config as jdriver_config
from triton_kubernetes_tpu.modules import REGISTRY as JREGISTRY
from triton_kubernetes_tpu.utils import metrics as jmetrics
from triton_kubernetes_tpu.utils.logging import Logger as JLogger
from triton_kubernetes_tpu_torch.chaos import corpus, generator, runner, shrink
from triton_kubernetes_tpu_torch.executor import (
    DagSpecError,
    LocalExecutor,
    RetryPolicy,
    SimulatedKillError,
    document_from_spec,
    driver_config,
    load_executor_state,
    modules_fingerprint,
    state_fingerprint,
)
from triton_kubernetes_tpu_torch.executor import engine as pengine
from triton_kubernetes_tpu_torch.executor.cloudsim import (
    CloudSimulator,
    FaultPlan,
    FaultPlanError,
)
from triton_kubernetes_tpu_torch.modules import REGISTRY
from triton_kubernetes_tpu_torch.utils import metrics
from triton_kubernetes_tpu_torch.utils.logging import Logger

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CORPUS = os.path.join(_ROOT, "tests", "chaos_corpus")
_ENTRIES = corpus.load_entries(_CORPUS)
_INFRA = {e["name"]: e for _, e in _ENTRIES if not e["spec"].get("workload")}


@pytest.fixture(autouse=True)
def fresh_stores():
    """Fresh metrics registries, and both executors' in-process state
    stores emptied for the test and given back after it: the reference's
    own tests name their documents as these may."""
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


def _quiet(cls, logger_cls, **kw):
    return cls(log=lambda m: None, logger=logger_cls(stream=io.StringIO()),
               **kw)


def _both(spec, ns):
    """(port result, reference result) of one spec, each on its own copy."""
    mine = runner.run_scenario(copy.deepcopy(spec), ns=f"p{ns}",
                               device="cpu")
    theirs = jrunner.run_scenario(copy.deepcopy(spec), ns=f"j{ns}")
    return mine, theirs


def _tpu_pools(spec):
    return sum(len(cl.get("pools", []))
               for cl in spec["topology"]["clusters"]
               if cl["provider"] == "gcp-tpu")


def _delete_latency(spec):
    lat = spec.get("op_latency") or 0.0
    if isinstance(lat, dict):
        return lat.get("delete_manifest", lat.get("*", 0.0))
    return lat


def _assert_same_verdict(mine, theirs, spec):
    assert mine.checked == theirs.checked
    assert mine.violations == theirs.violations
    # Three stats differ where the spec has TPU pools, each for one cause:
    # GcpGpuNodePool issues TPU_POOL_EXTRA_OPS mutations fewer than
    # GcpTpuNodePool, whose apply ends by deleting three fixed-name
    # DaemonSets the GPU pool never had. So the ref arm counts that many
    # ops fewer a pool (ref_ops), the kill lands at kill_fraction of the
    # smaller count (kill_at_op), and the deletes' latency is not booked
    # (simulated_seconds). Every other stat is equal.
    pools = _tpu_pools(spec)
    differ = {"ref_ops", "kill_at_op", "simulated_seconds"} if pools else ()
    assert set(mine.stats) == set(theirs.stats)
    assert {k: v for k, v in mine.stats.items() if k not in differ} == \
        {k: v for k, v in theirs.stats.items() if k not in differ}
    if not pools:
        return
    extra = generator.TPU_POOL_EXTRA_OPS
    assert mine.stats["ref_ops"] == theirs.stats["ref_ops"] - extra * pools
    if spec.get("kill_fraction"):
        for res in (mine, theirs):
            assert res.stats["kill_at_op"] == max(1, int(round(
                spec["kill_fraction"] * res.stats["ref_ops"])))
    delete_s = _delete_latency(spec)
    gap = theirs.stats["simulated_seconds"] - mine.stats["simulated_seconds"]
    if not delete_s:
        assert gap == 0
    elif not spec.get("kill_fraction"):
        # Each pool apply, in any arm or repair, books that many deletes
        # fewer. With a kill the resumed arm also retries other operations
        # than the reference's, so the gap is not a multiple there.
        applies = gap / (extra * delete_s)
        assert applies >= 1 - 1e-6
        assert abs(applies - round(applies)) < 1e-3


# ------------------------------------------------------------------ twin
TPU_SPEC = {
    "topology": {
        "manager": {"provider": "bare-metal", "name": "m1"},
        "clusters": [
            {"provider": "aws", "name": "c0", "nodes": ["c0-w0"]},
            {"provider": "gcp-tpu", "name": "tpu1",
             "pools": [{"name": "pool0", "accelerator": "v5e-16"},
                       {"name": "pool1", "accelerator": "v5e-16"}],
             "jobsets": [{"name": "job1", "pool": "pool1"}]}]},
    "faults": [
        {"op": "preempt", "slice_id": "tpu1-pool1", "module": "job_tpu1_job1",
         "at_module_op": 1},
        {"op": "*", "module": "node_gcp-tpu_tpu1_pool0", "at_module_op": 2,
         "times": 1, "error": "x"},
        {"op": "create_hosted_cluster", "module": "cluster_gcp-tpu_tpu1",
         "kind": "fatal", "times": 1, "error": "quota exceeded"},
        {"op": "register_node", "module": "node_aws_c0_c0-w0", "times": 1}],
    "operator_preempt": {"slice_id": "tpu1-pool0", "at_tick": 2},
}


def test_twin_spec_rewrites_the_tpu_fields():
    twin = generator.twin_spec(TPU_SPEC)
    assert TPU_SPEC["topology"]["clusters"][1]["provider"] == "gcp-tpu"
    aws, gpu = twin["topology"]["clusters"]
    assert aws == TPU_SPEC["topology"]["clusters"][0]
    assert gpu == {"provider": "gcp-gpu", "name": "tpu1",
                   "pools": [{"name": "pool0", "accelerator": "h100-16"},
                             {"name": "pool1", "accelerator": "h100-16"}],
                   "jobsets": [{"name": "job1", "pool": "pool1"}]}
    assert [r.get("module") for r in twin["faults"]] == [
        "job_tpu1_job1", "node_gcp-gpu_tpu1_pool0", "cluster_gcp-gpu_tpu1",
        "node_aws_c0_c0-w0"]
    assert [r.get("slice_id") for r in twin["faults"]] == [
        "tpu1-pool1", None, None, None]
    assert twin["operator_preempt"] == TPU_SPEC["operator_preempt"]
    # The twin materializes to the reference's module keys in the twin's
    # provider slot.
    keys = set(document_from_spec(twin["topology"], "tw").to_dict()["module"])
    jkeys = set(jdocument_from_spec(TPU_SPEC["topology"],
                                    "tw").to_dict()["module"])
    assert keys == {k.replace("gcp-tpu", "gcp-gpu") for k in jkeys}


def test_twin_spec_is_idempotent_and_the_result_keeps_the_given_spec():
    twin = generator.twin_spec(TPU_SPEC)
    assert generator.twin_spec(twin) == twin
    entry = _INFRA["tpu-preempt-repair"]
    spec = copy.deepcopy(entry["spec"])
    res = runner.run_scenario(spec, ns="keep", device="cpu")
    assert res.spec is spec and spec == entry["spec"]
    assert corpus.entry_for_failure(spec, res)["spec"] == entry["spec"]


def _serial_ops(port, topology):
    """(op, module, module_op) of each mutation of a fault-free serial
    apply, in order."""
    issued = []

    def factory(doc, state):
        sim = (CloudSimulator if port else JCloudSimulator)(state or {})
        sim.kill_hook = lambda *op: issued.append(op)
        return sim

    if port:
        doc = document_from_spec(topology, "serial-ops")
        ex = _quiet(LocalExecutor, Logger, driver_factory=factory)
    else:
        doc = jdocument_from_spec(topology, "serial-ops")
        ex = _quiet(JLocalExecutor, JLogger, driver_factory=factory)
    ex.apply(doc)
    return issued


def test_twin_spec_moves_a_global_anchor_onto_the_same_operation():
    """Every ``at_op`` of the reference's serial apply lands, on the twin,
    on the operation the reference's tick names (same module, same module
    op), or on the next one where the tick is a TPU pool's fixed-name
    DaemonSet delete, which the GPU pool does not issue."""
    theirs = _serial_ops(False, TPU_SPEC["topology"])
    mine = _serial_ops(True, generator.twin_spec(TPU_SPEC)["topology"])
    pool_deletes = [op == "delete_manifest" and module.startswith(
        "node_gcp-tpu_") for op, module, _ in theirs]
    assert sum(pool_deletes) == 2 * generator.TPU_POOL_EXTRA_OPS
    assert len(mine) == len(theirs) - sum(pool_deletes)
    for at_op in range(1, len(theirs) + 1):
        spec = dict(TPU_SPEC, faults=[
            {"op": "preempt", "slice_id": "tpu1-pool0", "at_op": at_op}])
        got = generator.twin_spec(spec)["faults"][0]["at_op"]
        same = [i for i in range(at_op - 1, len(theirs))
                if not pool_deletes[i]]
        if not same:
            # The last pool's deletes: the next operation follows the apply.
            assert got == len(mine) + 1, at_op
            continue
        _, module, module_op = theirs[same[0]]
        assert mine[got - 1][1:] == (module.replace("gcp-tpu", "gcp-gpu"),
                                     module_op), at_op
    spec = dict(TPU_SPEC, faults=[
        {"op": "preempt", "slice_id": "tpu1-pool0",
         "at_op": len(theirs) + 4}])
    assert generator.twin_spec(spec)["faults"][0]["at_op"] == len(mine) + 4
    assert generator.twin_spec(generator.twin_spec(spec)) == \
        generator.twin_spec(spec)


@pytest.mark.parametrize("accel", ["v5p-64", "v6e-8"])
def test_twin_spec_refuses_a_tpu_accelerator_without_a_twin(accel):
    spec = copy.deepcopy(TPU_SPEC)
    spec["topology"]["clusters"][1]["pools"][0]["accelerator"] = accel
    with pytest.raises(DagSpecError, match=accel):
        generator.twin_spec(spec)


# ---------------------------------------------------------------- corpus
def test_the_infra_corpus_is_the_reference_ones_eleven():
    assert sorted(_INFRA) == [
        "kill-mid-wave-resume", "mutation-unfaulted-reference",
        "operator-preempt-mid-reconcile", "provider-aws", "provider-azure",
        "provider-bare-metal", "provider-triton", "provider-vsphere",
        "tpu-at-op-preempt-serial", "tpu-graceful-warning",
        "tpu-preempt-repair"]


@pytest.mark.parametrize("name", sorted(_INFRA))
def test_infra_entry_replays_to_the_reference_verdict(name):
    entry = _INFRA[name]
    mine = corpus.replay(copy.deepcopy(entry), device="cpu")
    theirs = jcorpus.replay(copy.deepcopy(entry))
    _assert_same_verdict(mine, theirs, entry["spec"])
    if entry["expect"] == "pass":
        assert mine.passed, mine.violations
    else:
        assert [v["invariant"] for v in mine.violations] == \
            [entry["invariant"]]
        assert shrink.spec_size(entry["spec"]) <= (3, 2)
    assert mine.checked[0] == "parity"
    assert mine.checked.count("destroy-clean") == 2


# ---------------------------------------------------------------- sweeps
@pytest.mark.parametrize("profile", ["quick", "default", "tpu", "soak"])
def test_infra_profile_sweep_equals_the_reference(profile):
    for i in range(20):
        spec = generator.generate_spec(generator.scenario_seed(0, i),
                                       profile)
        mine, theirs = _both(spec, f"sw-{profile}")
        assert mine.passed == theirs.passed is True, (i, mine.violations)
        _assert_same_verdict(mine, theirs, spec)


# ----------------------------------------------------- the executor seams
_BAD_RULES = [
    {"op": "*", "at_module_op": 2},
    {"op": "*", "module": "m", "at_module_op": 0},
    {"op": "*", "module": "m", "at_module_op": "2"},
    {"op": "preempt", "slice_id": "s", "mode": "abrupt"},
    {"op": "preempt", "slice_id": "s", "grace_ops": -1},
    {"op": "preempt", "slice_id": "s", "notify_pid": "1"},
    {"op": "register_node", "grace_ops": 1},
    {"op": "register_node", "mode": "graceful-warning"},
    {"op": "preempt", "slice_id": "s", "warned": 1.5},
]


@pytest.mark.parametrize("rule", _BAD_RULES,
                         ids=[str(i) for i in range(len(_BAD_RULES))])
def test_fault_plan_refuses_the_new_keys_as_the_reference(rule):
    from triton_kubernetes_tpu.executor.cloudsim import FaultPlan as JPlan

    with pytest.raises(JFaultPlanError) as want:
        JPlan({"faults": [rule]})
    with pytest.raises(FaultPlanError) as got:
        FaultPlan({"faults": [rule]})
    assert str(got.value) == str(want.value)


def test_fault_plan_accepts_the_anchors_and_round_trips():
    rules = [r for r in TPU_SPEC["faults"]] + [
        {"op": "preempt", "slice_id": "s", "at_op": 3,
         "mode": "graceful-warning", "grace_ops": 2, "notify_pid": 0,
         "signal": "SIGTERM"}]
    plan = FaultPlan({"faults": rules})
    assert FaultPlan(plan.to_dict()).to_dict() == plan.to_dict()
    from triton_kubernetes_tpu.executor.cloudsim import FaultPlan as JPlan

    assert plan.to_dict() == JPlan({"faults": rules}).to_dict()


ANCHOR_TOPO = {"manager": {"provider": "bare-metal", "name": "m1"},
               "clusters": [
                   {"provider": "gcp-tpu", "name": "ml",
                    "pools": [{"name": f"pool{i}", "accelerator": "v5e-16"}
                              for i in range(3)],
                    "jobsets": [{"name": "j0", "pool": "pool0"},
                                {"name": "j1", "pool": "pool2"}]},
                   {"provider": "aws", "name": "c1",
                    "nodes": ["c1-w0", "c1-w1"]}]}
ANCHOR_FAULTS = [
    {"op": "*", "module": "node_gcp-tpu_ml_pool1", "at_module_op": 2,
     "times": 1, "error": "503 service unavailable"},
    {"op": "preempt", "slice_id": "ml-pool0", "module": "job_ml_j0",
     "at_module_op": 1},
    {"op": "register_node", "module": "node_aws_c1_c1-w1", "times": 2,
     "error": "instance boot failed"},
    {"op": "preempt", "slice_id": "ml-pool2", "module": "job_ml_j1",
     "at_module_op": 2, "mode": "graceful-warning", "grace_ops": 0,
     "notify_pid": 0}]


def _applied(port, width, name):
    spec = {"topology": ANCHOR_TOPO, "faults": ANCHOR_FAULTS}
    driver = {"name": "sim", "fault_plan": {"faults": (
        generator.twin_spec(spec)["faults"] if port else ANCHOR_FAULTS)}}
    if port:
        doc = document_from_spec(generator.twin_spec(spec)["topology"],
                                 name, driver=driver)
        ex = _quiet(LocalExecutor, Logger, parallelism=width,
                    sleep=lambda s: None, retry=RetryPolicy(max_retries=3))
    else:
        doc = jdocument_from_spec(ANCHOR_TOPO, name, driver=driver)
        ex = _quiet(JLocalExecutor, JLogger, parallelism=width,
                    sleep=lambda s: None, retry=JRetryPolicy(max_retries=3))
    ex.apply(doc)
    return doc, (load_executor_state if port else jengine.load_executor_state
                 )(doc)


@pytest.mark.parametrize("width", [1, 2, 8])
def test_module_anchors_fire_alike_at_every_width(width):
    """Per-module anchors fire on each module's own op counter, so the
    port at any width fires what the reference fires serially, and its
    applied state is byte-identical to its own serial apply's."""
    _, ref = _applied(False, 1, "anchor-ref")
    doc, est = _applied(True, width, f"anchor-{width}")
    serial, _ = _applied(True, 1, "anchor-serial")
    fired = [[r["fired"] for r in e.cloud["fault_plan"]["faults"]]
             for e in (ref, est)]
    assert fired[1] == fired[0] == [1, 1, 2, 1]
    assert [r.get("warned") for r in est.cloud["fault_plan"]["faults"]] \
        == [None, None, None, 1]
    assert est.cloud["preempt_history"] == ref.cloud["preempt_history"] == \
        {"ml-pool0": 1, "ml-pool2": 1}
    # Each GPU pool issues TPU_POOL_EXTRA_OPS mutations fewer than its TPU
    # original: the deletes of the TPU pool's fixed-name DaemonSets.
    extra = generator.TPU_POOL_EXTRA_OPS
    assert est.cloud["module_ops"] == {
        k.replace("gcp-tpu", "gcp-gpu"):
            n - (extra if k.startswith("node_gcp-tpu_") else 0)
        for k, n in ref.cloud["module_ops"].items()}
    assert est.cloud["ops"] == ref.cloud["ops"] - 3 * extra
    assert est.journal["retries"] == {
        k.replace("gcp-tpu", "gcp-gpu"): n
        for k, n in ref.journal["retries"].items()}
    assert state_fingerprint(doc, with_journal=False) == state_fingerprint(
        serial, with_journal=False)
    assert modules_fingerprint(doc) == modules_fingerprint(serial)


def test_graceful_warning_signals_a_child_then_reclaims_after_grace():
    """The warning tick marks the pool and sends SIGTERM to ``notify_pid``
    (a child process here, never the test runner); the pool is reclaimed
    ``grace_ops`` mutations later, as in the reference."""
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import signal, sys, time\n"
         "signal.signal(signal.SIGTERM, lambda *a: sys.exit(7))\n"
         "print('ready', flush=True)\n"
         "time.sleep(60)\n"], stdout=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == "ready"
        sims = []
        for port in (True, False):
            topo = ({"manager": ANCHOR_TOPO["manager"],
                     "clusters": [ANCHOR_TOPO["clusters"][0]]})
            if port:
                doc = document_from_spec(generator.twin_spec(
                    {"topology": topo})["topology"], "gw")
                _quiet(LocalExecutor, Logger).apply(doc)
                cloud, cls = load_executor_state(doc).cloud, CloudSimulator
            else:
                doc = jdocument_from_spec(topo, "gw")
                _quiet(JLocalExecutor, JLogger).apply(doc)
                cloud = jengine.load_executor_state(doc).cloud
                cls = JCloudSimulator
            at = cloud["ops"] + 1
            sim = cls(cloud, fault_plan={"faults": [
                {"op": "preempt", "slice_id": "ml-pool1", "at_op": at,
                 "mode": "graceful-warning", "grace_ops": 2,
                 "notify_pid": child.pid if port else 0}]})
            sim.create_resource("probe", "a")
            pool = sim.get_resource("gke_cluster", "ml")["node_pools"]["pool1"]
            warned = (bool(pool.get("preempt_warning")),
                      sorted(sim.preempted_slices()))
            sim.create_resource("probe", "b")
            mid = sorted(sim.preempted_slices())
            sim.create_resource("probe", "c")
            sims.append((warned, mid, sorted(sim.preempted_slices()),
                         sim.to_dict()["fault_plan"]))
        assert sims[0][:3] == sims[1][:3] == (
            (True, []), [], ["ml-pool1"])
        for plan in (sims[0][3], sims[1][3]):
            assert (plan["faults"][0]["warned"],
                    plan["faults"][0]["fired"]) == (1, 1)
        assert child.wait(timeout=30) == 7
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        child.stdout.close()


def _kill_factory(cls, kill_at, kill_error):
    def factory(doc, state):
        sim = cls(state or {})

        def hook(op, module, module_op):
            if sim.ops >= kill_at:
                raise kill_error(f"die at op {sim.ops}")
        sim.kill_hook = hook
        return sim
    return factory


@pytest.mark.parametrize("width,kill_at", [(1, 4), (8, 6)])
def test_kill_hook_rides_past_retry_and_resume_converges(width, kill_at):
    """A SimulatedKillError is a BaseException: the engine's retry does
    not consume it -- through the worker pool at width 8 too -- the
    completed modules stay committed, the journal is the reference's, and
    the resumed apply converges to the uninterrupted modules."""
    topo = {"manager": {"provider": "bare-metal", "name": "m1"},
            "clusters": [{"provider": "bare-metal", "name": "c0",
                          "nodes": ["w0", "w1", "w2"]}]}
    journals = []
    for port in (True, False):
        mk = document_from_spec if port else jdocument_from_spec
        ex_cls, log_cls = ((LocalExecutor, Logger) if port
                           else (JLocalExecutor, JLogger))
        sim_cls = CloudSimulator if port else JCloudSimulator
        kill = SimulatedKillError if port else JSimulatedKillError
        load = load_executor_state if port else jengine.load_executor_state
        ref = mk(topo, "kh-ref")
        _quiet(ex_cls, log_cls).apply(ref)
        doc = mk(topo, "kh")
        ex = _quiet(ex_cls, log_cls, parallelism=width,
                    driver_factory=_kill_factory(sim_cls, kill_at, kill))
        with pytest.raises(kill):
            ex.apply(doc)
        j = load(doc).journal
        journals.append({k: j.get(k) for k in ("status", "retries",
                                               "completed")})
        _quiet(ex_cls, log_cls, parallelism=width).apply(doc)
        fp = (modules_fingerprint if port else jengine.modules_fingerprint)
        assert fp(doc) == fp(ref)
    assert journals[0] == journals[1]
    assert journals[0]["status"] == "failed"
    assert journals[0]["retries"] == {}
    assert 0 < len(journals[0]["completed"]) < 5


def test_apply_to_success_lets_a_kill_through():
    entry = _INFRA["provider-bare-metal"]
    doc = document_from_spec(generator.twin_spec(entry["spec"])["topology"],
                             "kill-through")
    ex = runner._executor(lambda s: None, parallelism=2, kill_at_op=3)
    with pytest.raises(SimulatedKillError):
        runner._apply_to_success(ex, doc)


def test_op_latency_books_the_reference_virtual_seconds():
    latency = {"register_node": 2.0, "create_node_pool": 30.0, "*": 0.5}
    slept = {True: [], False: []}
    for port in (True, False):
        topo = ANCHOR_TOPO
        driver = {"name": "sim", "op_latency": latency}
        if port:
            doc = document_from_spec(generator.twin_spec(
                {"topology": topo})["topology"], "lat", driver=driver)
            ex = _quiet(LocalExecutor, Logger, parallelism=8,
                        driver_factory=runner._sim_factory(
                            slept[port].append))
        else:
            doc = jdocument_from_spec(topo, "lat", driver=driver)
            ex = _quiet(JLocalExecutor, JLogger, parallelism=8,
                        driver_factory=jrunner._sim_factory(
                            slept[port].append))
        ex.apply(doc)
        assert (driver_config(doc) if port else jdriver_config(doc)) == \
            driver
    # The reference's three pools also book their fixed-name DaemonSet
    # deletes, which the GPU pools do not issue (TPU_POOL_EXTRA_OPS each).
    assert sorted(slept[True] + [0.5] * 3 * generator.TPU_POOL_EXTRA_OPS) \
        == sorted(slept[False])
    assert sum(slept[True]) == 2 * 2.0 + 4 * 30.0 + (
        len(slept[True]) - 6) * 0.5


def test_fingerprints_equal_for_the_same_applied_spec():
    """Two applies of one spec (serial and at width 8) give one state and
    one modules fingerprint; an infra spec with no GPU pool fingerprints
    byte for byte as the reference's."""
    spec = _INFRA["provider-aws"]["spec"]
    fps = []
    for width, name in ((1, "fp-a"), (8, "fp-b")):
        doc = document_from_spec(spec["topology"], "fp")
        doc.set_backend_config({"memory": {"name": name}})
        _quiet(LocalExecutor, Logger, parallelism=width).apply(doc)
        fps.append((state_fingerprint(doc, with_journal=False),
                    modules_fingerprint(doc)))
    assert fps[0] == fps[1]
    jdoc = jdocument_from_spec(spec["topology"], "fp")
    jdoc.set_backend_config({"memory": {"name": "fp-j"}})
    _quiet(JLocalExecutor, JLogger).apply(jdoc)
    assert fps[0] == (jengine.state_fingerprint(jdoc, with_journal=False),
                      jengine.modules_fingerprint(jdoc))


# -------------------------------------------------- the provider modules
def test_registry_is_the_references_but_the_twins_and_backups():
    theirs = {n for n in JREGISTRY if "tpu" not in n
              and not n.startswith("k8s-backup")}
    mine = {n for n in REGISTRY if "gpu" not in n}
    assert mine == theirs
    for name in mine:
        assert REGISTRY[name].__name__ == JREGISTRY[name].__name__
        assert [(v.name, v.default, v.required)
                for v in REGISTRY[name].VARIABLES] == [
            (v.name, v.default, v.required)
            for v in JREGISTRY[name].VARIABLES]
        assert REGISTRY[name].OUTPUTS == JREGISTRY[name].OUTPUTS


@pytest.mark.parametrize("provider", ["aws", "azure", "triton", "vsphere",
                                      "bare-metal", "gcp", "gke", "aks"])
def test_provider_family_applies_as_the_reference(provider):
    """The provider's manager (where it has one), cluster and two hosts
    (hosted clusters: none) applied through both executors: the applied
    modules, their outputs and resources, and the whole simulated cloud
    byte for byte."""
    from triton_kubernetes_tpu_torch.executor.dagspec import PROVIDER_SHAPES

    manager = provider if PROVIDER_SHAPES[provider]["manager"] \
        else "bare-metal"
    topo = {"manager": {"provider": manager, "name": "m1"},
            "clusters": [{"provider": provider, "name": "c0",
                          "nodes": ["c0-w0", "c0-w1"], "node_count": 2}]}
    out = []
    for port in (True, False):
        doc = (document_from_spec if port else jdocument_from_spec)(
            topo, f"fam-{provider}")
        assert doc.to_bytes() == jdocument_from_spec(
            topo, f"fam-{provider}").to_bytes()
        ex = _quiet(LocalExecutor, Logger) if port else _quiet(
            JLocalExecutor, JLogger)
        ex.apply(doc)
        est = (load_executor_state if port
               else jengine.load_executor_state)(doc)
        out.append(json.dumps({"modules": est.modules, "cloud": est.cloud},
                              sort_keys=True))
        ex.destroy(doc)
    assert out[0] == out[1]


def test_host_disks_and_the_ha_manager_apply_as_the_reference():
    """The optional blocks the spec matrix does not draw: each host
    family's disk (aws EBS, azure managed disk, gcp disk) and the azure
    HA manager with its in-cluster Deployment and Ingress."""
    from triton_kubernetes_tpu.state import StateDocument as JDoc
    from triton_kubernetes_tpu_torch.state import StateDocument

    azure = {"azure_subscription_id": "s", "azure_client_id": "c",
             "azure_client_secret": "x", "azure_tenant_id": "t"}
    disks = {
        "aws": {"aws_access_key": "a", "aws_secret_key": "b",
                "ebs_volume_device_name": "/dev/xvdb",
                "ebs_volume_mount_path": "/data", "ebs_volume_size": 10},
        "azure": dict(azure, managed_disk_type="Premium_LRS",
                      managed_disk_size=64,
                      managed_disk_mount_path="/data"),
        "gcp": {"gcp_path_to_credentials": "/c", "gcp_project_id": "p",
                "gcp_disk_type": "pd-ssd", "gcp_disk_size": 100,
                "gcp_disk_mount_path": "/data"}}
    out = []
    for cls, ex_cls, log_cls in ((StateDocument, LocalExecutor, Logger),
                                 (JDoc, JLocalExecutor, JLogger)):
        doc = cls("ha")
        doc.set_backend_config({"memory": {"name": "ha"}})
        doc.set_manager({"source": "modules/azure-rke-manager", "name": "ha",
                         "fqdn": "mgr.example.com",
                         "tls_cert_path": "/c.pem",
                         "tls_private_key_path": "/k.pem", **azure})
        refs = {"manager_url": "${module.cluster-manager.manager_url}",
                "manager_access_key":
                    "${module.cluster-manager.manager_access_key}",
                "manager_secret_key":
                    "${module.cluster-manager.manager_secret_key}"}
        for prov, extra in disks.items():
            creds = {k: v for k, v in extra.items()
                     if not k.startswith(("ebs_", "managed_disk", "gcp_disk"))}
            ckey = doc.add_cluster(prov, f"d-{prov}", {
                "source": f"modules/{prov}-k8s", "name": f"d-{prov}",
                **refs, **creds})
            doc.add_node(ckey, f"d-{prov}-w0", {
                "source": f"modules/{prov}-k8s-host",
                "hostname": f"d-{prov}-w0",
                "rancher_cluster_registration_token":
                    f"${{module.{ckey}.registration_token}}",
                "rancher_cluster_ca_checksum":
                    f"${{module.{ckey}.ca_checksum}}", **extra})
        ex = _quiet(ex_cls, log_cls)
        ex.apply(doc)
        est = (load_executor_state if ex_cls is LocalExecutor
               else jengine.load_executor_state)(doc)
        out.append(json.dumps({"modules": est.modules, "cloud": est.cloud},
                              sort_keys=True))
        ex.destroy(doc)
    assert out[0] == out[1]
    assert '"azure_managed_disk:d-azure-w0-disk"' in out[0]
    assert '"kind": "Ingress"' in out[0]


def _untwin(value):
    """A port document's value in the reference's vocabulary: the twin's
    fields (provider slot, module sources, the accelerator key and name)
    mapped back."""
    if isinstance(value, dict):
        return {("tpu_accelerator" if k == "gpu_accelerator"
                 else _untwin(k)): _untwin(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_untwin(v) for v in value]
    if isinstance(value, str):
        return (value.replace("gcp-gpu", "gcp-tpu")
                .replace("gpu-jobset", "tpu-jobset")
                .replace("h100-16", "v5e-16"))
    return value


def test_dagspec_gives_the_reference_document_but_the_twins_fields():
    """Same spec, same document: the port's document of a twin is the
    reference's of the TPU spec once the twin's fields are mapped back,
    and a spec with no GPU pool gives the reference's bytes."""
    for seed in range(10):
        for profile in ("default", "tpu"):
            spec = generator.generate_spec(seed, profile)
            mine = document_from_spec(generator.twin_spec(spec)["topology"],
                                      "same")
            theirs = jdocument_from_spec(spec["topology"], "same")
            assert _untwin(json.loads(mine.to_bytes())) == json.loads(
                theirs.to_bytes()), (seed, profile)
            if not any(c["provider"] == "gcp-tpu"
                       for c in spec["topology"]["clusters"]):
                assert mine.to_bytes() == theirs.to_bytes()


# ------------------------------------------------------------- shrinking
def test_unfaulted_reference_shrinks_to_the_reference_minimal_spec():
    """The corpus entry's seed with the mutation forced on: the port's
    shrinker, running its own scenarios, lands where the reference's
    does -- on the committed entry's spec."""
    spec = generator.generate_spec(3, "default")
    spec["mutation"] = "unfaulted-reference"
    minimal, result = shrink.shrink_spec(copy.deepcopy(spec), device="cpu")
    jminimal, jresult = jshrink.shrink_spec(copy.deepcopy(spec))
    assert minimal == jminimal
    assert [v["invariant"] for v in result.violations] == \
        [v["invariant"] for v in jresult.violations] == ["parity"]
    assert shrink.spec_size(minimal) == jshrink.spec_size(jminimal)
    mods, rules = shrink.spec_size(minimal)
    assert mods <= 3 and rules <= 2
    # The committed entry predates the operator and workload draws.
    assert minimal["operator_preempt"] is minimal["workload"] is None
    assert {k: v for k, v in minimal.items()
            if k not in ("operator_preempt", "workload")} == \
        _INFRA["mutation-unfaulted-reference"]["spec"]


# ------------------------------------------------------- the runner's edges
def test_run_scenario_drops_its_documents_pass_or_fail(monkeypatch):
    spec = copy.deepcopy(_INFRA["provider-aws"]["spec"])
    runner.run_scenario(spec, ns="drop", device="cpu")
    assert not [n for n in pengine._MEMORY_STATES if n.startswith("drop-")]

    def boom(*a, **k):
        raise RuntimeError("mid-scenario")

    monkeypatch.setattr(runner, "_check_repair", boom)
    spec = copy.deepcopy(_INFRA["tpu-preempt-repair"]["spec"])
    with pytest.raises(RuntimeError, match="mid-scenario"):
        runner.run_scenario(spec, ns="drop", device="cpu")
    assert not [n for n in pengine._MEMORY_STATES if n.startswith("drop-")]


def test_infra_only_specs_need_no_device():
    """An infra-only spec touches no device, so ``device="cuda"`` runs it
    on a machine without a card; the workload spec beside it raises."""
    import torch

    entry = _INFRA["operator-preempt-mid-reconcile"]
    res = runner.run_scenario(copy.deepcopy(entry["spec"]), device="cuda")
    assert res.passed and "operator-converge" in res.checked
    if not torch.cuda.is_available():
        spec = dict(copy.deepcopy(entry["spec"]),
                    workload={"kind": "torn-checkpoint"})
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.run_scenario(spec, device="cuda")


def test_tools_chaos_defaults_to_the_default_profile(capsys):
    from triton_kubernetes_tpu_torch.tools import chaos as chaos_tool

    rc = chaos_tool.main(["--runs", "3", "--seed", "0"])
    out = capsys.readouterr().out
    assert rc == 0, out
    report = jrunner.run_sweep(seed=0, runs=3, shrink=False)
    assert out.startswith(
        f"chaos sweep: 3/3 scenarios passed (profile=default, seed=0, "
        f"simulated {report.simulated_seconds:.1f}s)"), out


def test_chip_smoke_pins_the_reference_infra_checked_lists():
    """``chip_smoke.py`` holds the card's runs to the reference's infra
    ``checked`` lists, pinned as data there (the script imports no JAX):
    the pins are what the reference's runner gives each spec."""
    sys.path.insert(0, _ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(_ROOT)
    entries = {e["name"]: e for _, e in _ENTRIES}
    assert sorted(chip_smoke.CHAOS_INFRA_ENTRIES) == sorted(_INFRA)
    for name, checked in chip_smoke.CHAOS_INFRA_ENTRIES.items():
        assert jcorpus.replay(copy.deepcopy(entries[name])).checked == \
            list(checked), name
    for label, spec, *_ in chip_smoke.chaos_cases(entries):
        infra = dict(copy.deepcopy(spec), workload=None)
        assert jrunner.run_scenario(infra, ns=f"pin-{label}").checked == \
            list(chip_smoke.CHAOS_INFRA_CHECKED[label]), label


# -------------------------------------------------------- the soak round
def test_soak_round_on_the_cpu(tmp_path):
    """The reference's soak loop, one round at ``llama-test`` in f32: the
    JAX step's parameters carried over, the four losses of apply -> train
    -> checkpoint -> preempt -> repair -> restore -> train matched to four
    JAX steps within ``tests/test_torch_train.py``'s tolerance, and
    bitwise the port's uninterrupted run's."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from triton_kubernetes_tpu.models import get_config as jget_config
    from triton_kubernetes_tpu.parallel import MeshConfig, create_mesh
    from triton_kubernetes_tpu.train import trainer as jtrainer
    from triton_kubernetes_tpu_torch.chaos.soak import (soak_round,
                                                        train_losses)
    from triton_kubernetes_tpu_torch.models import get_config, llama
    from triton_kubernetes_tpu_torch.train import (make_optimizer,
                                                   make_train_step, state_for,
                                                   synthetic_batches)

    jcfg, cfg = jget_config("llama-test"), get_config("llama-test")
    mesh = create_mesh(MeshConfig(fsdp=1), devices=jax.devices()[:1])
    opt_kw = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=100)
    jopt = jtrainer.make_optimizer(**opt_kw)
    jstate = jtrainer.init_state(jcfg, mesh, jopt)
    params = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32),
                          jstate.params)
    batch = next(synthetic_batches(cfg.vocab_size, 8, 32))
    jstep = jtrainer.make_train_step(jcfg, mesh, jopt)
    jlosses = []
    for _ in range(4):
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        jlosses.append(float(m["loss"]))

    opt = make_optimizer(**opt_kw)
    step = make_train_step(cfg, opt)

    def fresh():
        return state_for(llama.from_numpy_params(
            params, cfg, device="cpu", trainable=True), opt)

    _, want = train_losses(step, fresh(), batch, 4)
    rnd = soak_round(50_000, step, fresh, batch, str(tmp_path / "ckpt"),
                     ns="soak-cpu", device="cpu")
    assert rnd["result"].passed and rnd["restored_step"] == 2
    pool = rnd["pool"]
    assert pool["accelerator"] == "h100-16"
    assert rnd["repaired"] == f"node_gcp-gpu_{pool['cluster']}_{pool['pool']}"
    np.testing.assert_allclose([float(x) for x in rnd["losses"]], jlosses,
                               rtol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(rnd["losses"], want))
    assert not [n for n in pengine._MEMORY_STATES if n.startswith("soak-")]
