"""Scenario execution + the pinned invariant suite -- the port of
``triton_kubernetes_tpu/chaos/runner.py``, both halves.

A scenario spec keeps the reference's vocabulary; :func:`run_scenario`
runs its GPU twin (:func:`~.generator.twin_spec`: ``gcp-gpu`` clusters of
``h100-16`` pools) as up to three executor arms over the same generated
document, all against the in-process simulator with an injected
*recording* sleeper (latency models advance a virtual clock, never the
wall clock):

* **ref** -- serial apply (parallelism 1), driven to success;
* **par** -- the spec's parallelism, driven to success; compared to ref;
* **kill** -- only when ``kill_fraction`` is set: the apply is killed
  mid-wave (cloudsim kill hook -> ``SimulatedKillError``) at a
  deterministic fraction of the ref arm's mutation count, then resumed
  to success and compared to ref.

Infra invariants (each reported independently; ids are the corpus
vocabulary):

* ``parity`` -- ref and par fingerprints byte-equal
  (:func:`~..executor.engine.state_fingerprint`; journal fields included
  when both arms succeeded first try, convergence-only when a fatal
  fault made either arm take multiple applies);
* ``kill-resume`` -- killed+resumed modules == ref modules
  (:func:`~..executor.engine.modules_fingerprint`);
* ``trace-journal`` -- exported module spans bit-match journal durations;
* ``metrics-journal`` -- the apply-duration histogram moved by at least
  the final journal's duration for every module;
* ``repair`` -- every GPU pool the fault plan preempted is replaced via
  :func:`~..workflows.repair.repair_slice_auto` and comes back with the
  labels of its real shape (``topology/labels.verify_pool_labels``) and
  an empty preempted set;
* ``operator-converge`` -- a pool preempted between a reconcile tick's
  observe and act is converged by the next tick, exactly once, with no
  orphans (:class:`~..operator.loop.Reconciler`);
* ``destroy-clean`` -- a targeted destroy of every module leaves zero
  simulator resources/managers/clusters/manifests, and a whole-graph
  destroy deletes the executor state outright.

The infra arms are host code: they touch no device and run under any
``device``. A spec carrying a ``workload`` fault then runs one workload
arm (chaos/workload.py) on ``device`` -- replica death, engine preemption
mid-chunked-prefill, torn KV migrations and checkpoints, rank or
coordinator death, SIGTERM against the route process -- each checked by
the workload invariants (``engine-parity``, ``reland-parity``,
``pool-convergence``, ``trace-valid``, ``ckpt-fallback``,
``train-resume``, ``flush-clean``, ``migration-integrity``,
``reshard-fallback``).
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..backends import MemoryBackend
from ..executor.cloudsim import CloudSimulator, SimulatedKillError
from ..executor.dagspec import document_from_spec, gpu_pools
from ..executor.engine import (
    _MEMORY_STATES,
    LocalExecutor,
    RetryPolicy,
    load_executor_state,
    modules_fingerprint,
    save_executor_state,
    state_fingerprint,
)
from ..utils import metrics
from ..utils.logging import Logger
from ..utils.trace import TraceCollector

INVARIANTS = ("parity", "kill-resume", "trace-journal", "metrics-journal",
              "repair", "destroy-clean", "operator-converge",
              # Workload fault arms (chaos/workload.py):
              "engine-parity", "reland-parity", "pool-convergence",
              "trace-valid", "ckpt-fallback", "train-resume",
              "flush-clean", "migration-integrity", "reshard-fallback")

#: Deliberate invariant breakages (mutation testing of the harness
#: itself): each key names a way run_scenario corrupts its own checking
#: so the catch -> shrink -> corpus pipeline can be exercised end to end.
#: ``unfaulted-reference`` builds the ref arm WITHOUT the fault plan --
#: a world where fault handling changed final state invisibly.
#: The workload mutations (chaos/workload.py) break one workload
#: invariant each: ``dropped-reland`` truncates the re-landed response
#: before the parity compare, ``leaked-pages`` skips the page-pool
#: release before the convergence check, ``swallowed-abort`` drops the
#: abort flush so lifecycles end terminal-less, ``accepted-torn``
#: pretends the destination imported a torn KV payload so
#: migration-integrity must catch the phantom acceptance,
#: ``adopt-torn-step`` pretends restore landed the half-committed
#: reshard step so reshard-fallback must catch the adoption.
MUTATIONS = ("unfaulted-reference", "dropped-reland", "leaked-pages",
             "swallowed-abort", "accepted-torn", "adopt-torn-step")

_MAX_APPLY_ATTEMPTS = 6


class ChaosHarnessError(RuntimeError):
    """The harness itself could not run a scenario to a verdict (as
    opposed to a scenario that ran and violated an invariant)."""


@dataclass
class ScenarioResult:
    spec: Dict[str, Any]
    violations: List[Dict[str, str]] = field(default_factory=list)
    checked: List[str] = field(default_factory=list)
    stats: Dict[str, Any] = field(default_factory=dict)

    @property
    def passed(self) -> bool:
        return not self.violations

    def violated(self, invariant: str) -> bool:
        return any(v["invariant"] == invariant for v in self.violations)

    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.spec.get("seed"), "passed": self.passed,
                "checked": self.checked, "violations": self.violations,
                "stats": self.stats}


@dataclass
class SweepReport:
    profile: str
    seed: int
    runs: int = 0
    passed: int = 0
    results: List[ScenarioResult] = field(default_factory=list)
    corpus_written: List[str] = field(default_factory=list)
    simulated_seconds: float = 0.0

    @property
    def failed(self) -> int:
        return self.runs - self.passed

    def to_dict(self) -> Dict[str, Any]:
        return {"profile": self.profile, "seed": self.seed,
                "runs": self.runs, "passed": self.passed,
                "failed": self.failed,
                "simulated_seconds": self.simulated_seconds,
                "corpus_written": self.corpus_written,
                "failures": [r.to_dict() for r in self.results
                             if not r.passed]}


def _driver_dict(spec: Dict[str, Any],
                 with_faults: bool = True) -> Dict[str, Any]:
    d: Dict[str, Any] = {"name": "sim"}
    if with_faults and spec.get("faults"):
        d["fault_plan"] = {"faults": spec["faults"]}
    if spec.get("op_latency") is not None:
        d["op_latency"] = spec["op_latency"]
    return d


def _sim_factory(recorder: Callable[[float], None],
                 kill_at_op: Optional[int] = None):
    """A make_driver-compatible factory that builds the simulator with a
    recording sleeper (latency -> virtual clock) and, optionally, the
    kill hook armed at a global mutation-clock tick."""
    from ..executor.drivers import driver_config

    def factory(doc, state):
        cfg = driver_config(doc)
        sim = CloudSimulator(state or {}, fault_plan=cfg.get("fault_plan"),
                             op_latency=cfg.get("op_latency"),
                             sleep=recorder)
        if kill_at_op is not None:
            def hook(op: str, module: str, module_op: int) -> None:
                if sim.ops >= kill_at_op:
                    raise SimulatedKillError(
                        f"injected process death at op {sim.ops} "
                        f"(module {module or '<unscoped>'})")
            sim.kill_hook = hook
        return sim

    return factory


def _executor(recorder, parallelism: int,
              kill_at_op: Optional[int] = None,
              logger: Optional[Logger] = None) -> LocalExecutor:
    if logger is None:
        # Quiet by default: a sweep applies hundreds of documents and
        # must not narrate every module span to the operator's terminal.
        logger = Logger(stream=io.StringIO())
    return LocalExecutor(
        log=lambda m: None, logger=logger,
        retry=RetryPolicy(max_retries=3, backoff=0.25, deadline=600.0),
        sleep=recorder, parallelism=parallelism,
        driver_factory=_sim_factory(recorder, kill_at_op))


def _apply_to_success(ex: LocalExecutor, doc) -> Dict[str, Any]:
    """Drive apply until the journal lands ok (fatal one-shot faults make
    the first attempts fail by design). Returns {"attempts": n,
    "first_error": str|None}. A SimulatedKillError propagates — only the
    kill arm's own loop expects deaths, and it handles them itself."""
    first_error: Optional[str] = None
    for attempt in range(1, _MAX_APPLY_ATTEMPTS + 1):
        try:
            ex.apply(doc)
            return {"attempts": attempt, "first_error": first_error}
        except Exception as e:  # noqa: BLE001 - injected faults by design
            first_error = first_error or str(e)
    raise ChaosHarnessError(
        f"apply did not converge in {_MAX_APPLY_ATTEMPTS} attempts "
        f"(doc {doc.name!r}): {first_error}")


def _destroy_to_success(ex: LocalExecutor, doc, targets=None) -> None:
    """Drive destroy until it completes. Fault rules whose anchors land
    past a module's last *apply* op fire on its destroy ops instead --
    a killed destroy resuming over the survivors is itself pinned
    machinery, so the harness rides it rather than avoiding it."""
    first_error: Optional[str] = None
    for _ in range(_MAX_APPLY_ATTEMPTS):
        try:
            ex.destroy(doc, targets=targets)
            return
        except Exception as e:  # noqa: BLE001 - injected faults by design
            first_error = first_error or str(e)
            if targets is not None:
                # Survivors only: the completed modules are gone from the
                # persisted state, and a stale target raises nothing but
                # a no-op — recompute to keep the resume tight.
                targets = sorted(load_executor_state(doc).modules)
    raise ChaosHarnessError(
        f"destroy did not converge in {_MAX_APPLY_ATTEMPTS} attempts "
        f"(doc {doc.name!r}): {first_error}")


def _trace_module_events(trace: TraceCollector) -> Dict[str, float]:
    """module key -> exported span duration (seconds) for apply-nested
    module spans."""
    out: Dict[str, float] = {}
    for e in trace.events():
        name = e.get("name", "")
        if name.startswith("module.") and \
                e.get("args", {}).get("path", "").startswith("apply/"):
            out[name[len("module."):]] = e.get("dur", 0.0) / 1e6
    return out


def run_scenario(spec: Dict[str, Any], ns: str = "chaos",
                 device: str = "cuda") -> ScenarioResult:
    """Run one generated scenario's GPU twin through every applicable
    invariant; its workload arm, if any, on ``device``.

    Documents live in the in-process memory backend under
    ``{ns}-s{seed}-*`` names and are removed afterwards, pass or fail --
    replay (corpus, shrinking) always starts clean.
    ``ScenarioResult.spec`` is ``spec`` as given (the reference's
    vocabulary), so a corpus entry written from it stays the reference's.
    ``stats["simulated_seconds"]`` is the virtual time the arms booked.
    """
    from .generator import twin_spec

    res = ScenarioResult(spec=spec)
    mutation = spec.get("mutation")
    if mutation is not None and mutation not in MUTATIONS:
        raise ChaosHarnessError(f"unknown mutation {mutation!r} "
                                f"(choices: {MUTATIONS})")
    if spec.get("workload"):
        # Before the infra arms: a workload arm asked for a card this
        # machine lacks fails at once, not after seconds of host work.
        from ..models.llama import resolve_device

        resolve_device(device)
    twin = twin_spec(spec)
    base = f"{ns}-s{spec.get('seed', 0)}"
    names = {"ref": f"{base}-ref", "par": f"{base}-par",
             "kill": f"{base}-kill", "op": f"{base}-op"}
    slept: List[float] = []
    recorder = slept.append
    try:
        _run_arms(twin, res, names, recorder, device)
    finally:
        res.stats["simulated_seconds"] = round(sum(slept), 6)
        for name in names.values():
            _MEMORY_STATES.pop(name, None)
    status = "ok" if res.passed else "violated"
    metrics.counter("tk8s_chaos_scenarios_total").inc(status=status)
    return res


def _check(res: ScenarioResult, invariant: str, ok: bool,
           detail: str) -> None:
    res.checked.append(invariant)
    metrics.counter("tk8s_chaos_invariant_checks_total").inc(
        invariant=invariant, status="ok" if ok else "violated")
    if not ok:
        res.violations.append({"invariant": invariant, "detail": detail})


def _run_arms(spec: Dict[str, Any], res: ScenarioResult,
              names: Dict[str, str], recorder, device: str) -> None:
    mutation = spec.get("mutation")

    # --- ref arm: serial, driven to success.
    ref_doc = document_from_spec(
        spec["topology"], names["ref"],
        driver=_driver_dict(spec,
                            with_faults=mutation != "unfaulted-reference"))
    ref_ex = _executor(recorder, parallelism=1)
    ref_run = _apply_to_success(ref_ex, ref_doc)
    ref_est = load_executor_state(ref_doc)
    ref_ops = int(ref_est.cloud.get("ops", 0))
    ref_modules_fp = modules_fingerprint(ref_doc)
    res.stats.update(modules=len(ref_est.modules), ref_ops=ref_ops,
                     ref_attempts=ref_run["attempts"])

    # --- par arm: the spec's width, with span export for the
    # trace/metrics agreement checks.
    trace = TraceCollector()
    logger = Logger(stream=io.StringIO(), trace=trace)
    hist = metrics.histogram("tk8s_module_apply_duration_seconds")
    pre_sum = {m: hist.sum(module=m) for m in ref_est.modules}
    par_doc = document_from_spec(spec["topology"], names["par"],
                                 driver=_driver_dict(spec))
    par_ex = _executor(recorder, parallelism=spec["parallelism"],
                       logger=logger)
    par_run = _apply_to_success(par_ex, par_doc)
    res.stats["par_attempts"] = par_run["attempts"]

    # --- parity: full fingerprint when both arms succeeded first try;
    # fatal faults force re-applies whose journals legitimately differ,
    # so those scenarios pin convergence (modules + cloud) instead.
    clean = ref_run["attempts"] == 1 and par_run["attempts"] == 1
    ref_fp = state_fingerprint(ref_doc, with_journal=clean)
    par_fp = state_fingerprint(par_doc, with_journal=clean)
    _check(res, "parity", ref_fp == par_fp,
           f"serial vs parallelism={spec['parallelism']} fingerprints "
           f"differ ({'with' if clean else 'sans'} journal)")

    # --- trace-journal / metrics-journal agreement, on the par arm's
    # final (successful) apply.
    journal = load_executor_state(par_doc).journal
    durs = journal.get("durations", {})
    spans = _trace_module_events(trace)
    bad = [m for m, d in durs.items()
           if abs(spans.get(m, -1.0) - d) > 1e-6]
    _check(res, "trace-journal", not bad,
           f"span exports disagree with journal durations for {bad}")
    moved = {m: hist.sum(module=m) - pre_sum.get(m, 0.0)
             for m in durs}
    # The histogram accumulated every attempt of both arms; each
    # successful module apply observes exactly its journal duration, so
    # the per-module delta must be >= the final journal's figure and
    # every final duration must be one of the observations.
    bad = [m for m, d in durs.items() if moved.get(m, 0.0) < d - 1e-9]
    _check(res, "metrics-journal", not bad,
           f"apply-duration histogram moved less than the journal for "
           f"{bad}")

    # --- kill arm: death mid-wave at a deterministic clock tick, then
    # resume to success; applied modules must converge to ref.
    if spec.get("kill_fraction"):
        kill_at = max(1, int(round(float(spec["kill_fraction"]) * ref_ops)))
        res.stats["kill_at_op"] = kill_at
        kill_doc = document_from_spec(spec["topology"], names["kill"],
                                      driver=_driver_dict(spec))
        kill_ex = _executor(recorder, parallelism=spec["parallelism"],
                            kill_at_op=kill_at)
        killed = False
        for _ in range(_MAX_APPLY_ATTEMPTS):
            try:
                kill_ex.apply(kill_doc)
                break
            except SimulatedKillError:
                killed = True
                break
            except Exception:
                # A generated fault failed this attempt before the clock
                # reached the kill anchor: keep the hook ARMED and retry,
                # so the stat never claims a death that did not happen.
                continue
        resume_ex = _executor(recorder,
                              parallelism=spec["parallelism"])
        _apply_to_success(resume_ex, kill_doc)
        res.stats["killed"] = killed
        _check(res, "kill-resume",
               modules_fingerprint(kill_doc) == ref_modules_fp,
               f"killed@op{kill_at}+resumed modules diverge from the "
               f"uninterrupted reference")

    # --- repair: every preempted GPU pool is replaced with verified
    # labels through the programmatic repair workflow (on ref).
    slices = gpu_pools(spec["topology"])
    if slices:
        _check_repair(spec, res, ref_doc, ref_ex, names["ref"])

    # --- operator-converge: a pool preempted between a reconcile
    # tick's observe and act phases is converged by the NEXT tick,
    # exactly once, with zero orphaned pools (its own fresh arm).
    if spec.get("operator_preempt") and slices:
        _check_operator(spec, res, names["op"], recorder)

    # --- destroy-clean: targeted destroy of everything (par arm) leaves
    # zero orphans; whole-graph destroy (ref arm) deletes the state.
    par_est = load_executor_state(par_doc)
    _destroy_to_success(par_ex, par_doc, targets=sorted(par_est.modules))
    after = load_executor_state(par_doc)
    orphans = {k: v for k, v in after.cloud.items()
               if k in ("resources", "managers", "clusters", "manifests")
               and v}
    _check(res, "destroy-clean",
           not after.modules and not orphans,
           f"targeted destroy left modules={sorted(after.modules)} "
           f"orphans={sorted(orphans)}")
    _destroy_to_success(ref_ex, ref_doc)
    _check(res, "destroy-clean", _MEMORY_STATES.get(names["ref"]) is None,
           "whole-graph destroy did not delete the executor state")

    # --- workload fault arm: serving/training faults on ``device``,
    # with the trace timeline as the generic oracle. Lazy import: the
    # infra arms load no model code.
    if spec.get("workload"):
        from .workload import run_workload_arm

        run_workload_arm(spec, res, _check, recorder, device=device)


def _check_operator(spec: Dict[str, Any], res: ScenarioResult,
                    op_name: str, recorder) -> None:
    """The preempt-mid-reconcile arm: run the port's reconcile operator
    over a freshly-applied copy of the topology and kill one pool through
    the ``between_observe_and_act`` seam -- the tick has already diffed a
    healthy world when the reclaim lands.

    Converges iff, within ``at_tick + 3`` ticks: the loop reaches the
    noop steady state, the journal shows the slice repaired EXACTLY
    once (observing the same dead slice on two ticks must not run two
    replacements), and the cloud carries no orphaned pools (every
    desired pool exists, nothing is left preempted).
    """
    from ..operator import Reconciler

    op = spec["operator_preempt"]
    sid = str(op.get("slice_id", ""))
    at_tick = int(op.get("at_tick", 1))
    known = {row["slice_id"] for row in gpu_pools(spec["topology"])}
    if sid not in known:
        return  # shrunk-away pool: the arm has nothing to exercise
    # Faults excluded on purpose: this arm isolates the mid-tick
    # preemption; fault-plan interactions are the other arms' job.
    doc = document_from_spec(spec["topology"], op_name,
                             driver=_driver_dict(spec, with_faults=False))
    ex = _executor(recorder, parallelism=spec["parallelism"])
    _apply_to_success(ex, doc)
    backend = MemoryBackend()
    backend.persist(doc)

    ticks = {"n": 0}
    fired = {"tick": 0}

    def clock() -> float:
        ticks["n"] += 1
        return float(ticks["n"])

    def preempt_mid_tick(observed) -> None:
        if fired["tick"] or len(reconciler.journal) + 1 < at_tick:
            return
        est = load_executor_state(doc)
        sim = CloudSimulator(est.cloud)
        sim.preempt_slice(sid)
        est.cloud = sim.to_dict()
        save_executor_state(doc, est)
        fired["tick"] = len(reconciler.journal) + 1

    reconciler = Reconciler(
        backend, ex, op_name, clock=clock, sleep=recorder,
        interval_s=0.0, log=lambda m: None,
        between_observe_and_act=preempt_mid_tick)
    bound = at_tick + 3
    for _ in range(bound):
        reconciler.tick()
        # Converged only counts AFTER a post-preemption tick has had
        # the chance to observe the dead slice — the firing tick's own
        # noop is the stale world, not convergence.
        if fired["tick"] and len(reconciler.journal) > fired["tick"] \
                and reconciler.converged:
            break
    repairs = [
        t for rec in reconciler.journal for t in rec.actions
        if t.get("rule") == "replace-preempted-slice" and t.get("ok")]
    repaired_slices = [s for t in repairs for s in t.get("targets", [])]
    view = ex.cloud_view(doc)
    still_preempted = sorted(view.preempted_slices())
    # Orphan check: every desired pool module still exists in applied
    # state and the cloud, and nothing undesired is left behind.
    est = load_executor_state(doc)
    desired = set(doc.to_dict().get("module", {}))
    applied = set(est.modules)
    ok = (bool(fired["tick"]) and reconciler.converged
          and repaired_slices == [sid]
          and not still_preempted
          and desired == applied)
    _check(res, "operator-converge", ok,
           f"preempt {sid} mid-tick@{at_tick}: converged="
           f"{reconciler.converged} after {len(reconciler.journal)} "
           f"ticks (bound {bound}), repairs={repaired_slices}, "
           f"still_preempted={still_preempted}, "
           f"desired^applied={sorted(desired ^ applied)}")
    res.stats["operator_ticks"] = len(reconciler.journal)


def _check_repair(spec: Dict[str, Any], res: ScenarioResult, ref_doc,
                  ref_ex, ref_name: str) -> None:
    from ..topology.gpus import GpuPoolSpec
    from ..topology.labels import verify_pool_labels
    from ..workflows import repair_slice_auto

    view = ref_ex.cloud_view(ref_doc)
    preempted = view.preempted_slices()
    if not preempted:
        return  # no preempt rule fired in this scenario
    backend = MemoryBackend()
    backend.persist(ref_doc)
    by_cluster: Dict[str, List[str]] = {}
    for sid, info in sorted(preempted.items()):
        by_cluster.setdefault(info["cluster"], []).append(sid)
    try:
        for cluster, sids in sorted(by_cluster.items()):
            for sid in sids:
                repair_slice_auto(backend, ref_ex, ref_name, cluster,
                                  slice_id=sid)
    except Exception as e:  # noqa: BLE001 - the invariant verdict
        _check(res, "repair", False, f"repair slice failed: {e}")
        return
    view2 = ref_ex.cloud_view(ref_doc)
    if view2.preempted_slices():
        _check(res, "repair", False,
               f"slices still preempted after repair: "
               f"{sorted(view2.preempted_slices())}")
        return
    problems: List[str] = []
    for row in gpu_pools(spec["topology"]):
        if row["slice_id"] not in preempted:
            continue
        gke = view2.get_resource("gke_cluster", row["cluster"]) or {}
        pool = gke.get("node_pools", {}).get(row["pool"], {})
        labels = [n.get("labels", {}) for n in pool.get("nodes", [])]
        pspec = GpuPoolSpec.from_accelerator(row["accelerator"])
        problems += [f"{row['slice_id']}: {p}" for p in
                     verify_pool_labels(labels, pspec, row["slice_id"])]
    _check(res, "repair", not problems,
           f"replaced pools came back with wrong labels: {problems}")
    res.stats["repaired"] = sorted(preempted)


def run_sweep(seed: int, runs: int, profile: str = "default",
              shrink: bool = True, corpus_dir: Optional[str] = None,
              log: Optional[Callable[[str], None]] = None,
              device: str = "cuda") -> SweepReport:
    """N seeded scenarios; failing seeds are shrunk to minimal specs and
    (when ``corpus_dir`` is set) serialized as corpus entries."""
    from .corpus import entry_for_failure, save_entry
    from .generator import generate_spec, scenario_seed
    from .shrink import shrink_spec

    report = SweepReport(profile=profile, seed=seed)
    for i in range(runs):
        spec = generate_spec(scenario_seed(seed, i), profile)
        result = run_scenario(spec, device=device)
        report.runs += 1
        report.simulated_seconds += result.stats.get("simulated_seconds", 0)
        if result.passed:
            report.passed += 1
            continue
        report.results.append(result)
        if log:
            log(f"seed {spec['seed']}: violated "
                f"{[v['invariant'] for v in result.violations]}")
        if shrink:
            spec, result = shrink_spec(spec, result, device=device)
        if corpus_dir is not None:
            path = save_entry(entry_for_failure(spec, result), corpus_dir)
            report.corpus_written.append(path)
    return report
