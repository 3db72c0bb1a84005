"""The in-process apply/destroy/output engine: the port's copy of the
reference's ``executor/engine.py``.

It resolves the module graph itself: topological order from
``${module.x.y}`` references, per-module validate -> resolve -> apply
against the driver (a wavefront over the DAG), applied state persisted
where the document's ``terraform.backend`` block points (``memory`` or
``local``; the reference's object-store location is not ported). The
workflow-visible contract is the reference's:

* apply is whole-graph and idempotent, and prunes modules gone from the
  document dependents-first;
* destroy supports ``targets`` fan-out;
* output returns one module's outputs from cached applied state;
* :meth:`LocalExecutor.cloud_view` is a read-only simulator over the
  persisted cloud dict (the operator's "actual" leg).

The reference's ``restore`` (backup replay) is not ported: the port has
no backup module.
"""

from __future__ import annotations

import copy
import json
import os
import tempfile
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as _futures_wait
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..modules import get_module
from ..modules.base import DriverContext
from ..state import StateDocument
from ..utils import metrics
from .cloudsim import CloudSimulator, FatalFaultError, TransientFaultError
from .drivers import make_driver
from .interpolate import module_dependencies, resolve, topo_order
from .plan import Plan, PlanAction, diff_states


class ApplyError(RuntimeError):
    pass


class TransientApplyError(ApplyError):
    """A module apply kept failing on retryable faults (flaked control-plane
    calls, boot failures) until retries/deadline ran out. The partial state
    is journaled; a re-run resumes from the last healthy module."""


class FatalApplyError(ApplyError):
    """A module apply hit a fault retries cannot fix (permanent provider
    rejection, quota). Fail fast — backoff would only delay the operator."""


class OutputError(KeyError):
    pass


@dataclass
class RetryPolicy:
    """Per-module retry/backoff knobs for transient apply faults.

    Backoff is capped exponential: ``backoff * 2**attempt`` up to
    ``backoff_cap`` per wait, and the *total* slept per apply is bounded by
    ``deadline`` seconds — a fleet-wide outage must surface as an error,
    not an apply that hangs for hours. With no faults no sleep ever
    happens, so the policy is behavior-neutral on the happy path.
    """

    max_retries: int = 3
    backoff: float = 0.5
    backoff_cap: float = 8.0
    deadline: float = 120.0

    def delay(self, attempt: int) -> float:
        return min(self.backoff * (2 ** attempt), self.backoff_cap)


def classify_fault(exc: BaseException) -> str:
    """``"transient"`` for faults worth retrying, ``"fatal"`` otherwise.

    Typed simulator faults carry their own classification; real-driver
    network/timeout errors are transient by nature; everything else
    (validation, interpolation, contract violations) is fatal — retrying a
    deterministic error just burns the deadline.
    """
    if isinstance(exc, TransientFaultError):
        return "transient"
    if isinstance(exc, FatalFaultError):
        return "fatal"
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return "transient"
    return "fatal"


# In-process stores for the "memory" executor backend (tests).
_MEMORY_STATES: Dict[str, Dict[str, Any]] = {}


@dataclass
class ExecutorState:
    """Applied-resource state (terraform.tfstate analog)."""

    modules: Dict[str, Any] = field(default_factory=dict)
    cloud: Dict[str, Any] = field(default_factory=dict)
    serial: int = 0
    # Journal of the most recent apply: which modules completed, which
    # failed with what classification, retries and backoff spent. Persisted
    # with the state so a re-run (or an operator) can see exactly where a
    # partial apply stopped.
    journal: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"serial": self.serial, "modules": self.modules,
                "cloud": self.cloud, "journal": self.journal}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ExecutorState":
        return ExecutorState(
            modules=d.get("modules", {}),
            cloud=d.get("cloud", {}),
            serial=d.get("serial", 0),
            journal=d.get("journal", {}),
        )


def _backend_location(doc: StateDocument) -> Dict[str, Any]:
    cfg = doc.get("terraform.backend")
    if not isinstance(cfg, dict) or not cfg:
        # Default: local state in a per-name dir under the user cache.
        return {"local": {"path": os.path.expanduser(
            f"~/.triton-kubernetes-tpu/{doc.name}/terraform.tfstate")}}
    return cfg


def load_executor_state(doc: StateDocument) -> ExecutorState:
    loc = _backend_location(doc)
    if "memory" in loc:
        raw = _MEMORY_STATES.get(loc["memory"]["name"])
        # Deep-copy so callers can never alias the stored state.
        return ExecutorState.from_dict(copy.deepcopy(raw)) if raw else ExecutorState()
    if "local" in loc:
        path = loc["local"]["path"]
        if os.path.isfile(path):
            with open(path) as f:
                return ExecutorState.from_dict(json.load(f))
        return ExecutorState()
    raise ApplyError(f"unsupported executor backend: {list(loc)}")


def save_executor_state(doc: StateDocument, est: ExecutorState) -> None:
    est.serial += 1
    loc = _backend_location(doc)
    metrics.counter("tk8s_state_saves_total").inc(
        backend=next(iter(loc), "unknown"))
    if "memory" in loc:
        _MEMORY_STATES[loc["memory"]["name"]] = copy.deepcopy(est.to_dict())
        return
    if "local" not in loc:
        raise ApplyError(f"unsupported executor backend: {list(loc)}")
    path = loc["local"]["path"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(est.to_dict(), f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def delete_executor_state(doc: StateDocument) -> None:
    loc = _backend_location(doc)
    if "memory" in loc:
        _MEMORY_STATES.pop(loc["memory"]["name"], None)
    elif "local" in loc and os.path.isfile(loc["local"]["path"]):
        os.unlink(loc["local"]["path"])


# Journal fields that are deterministic at every parallelism — what the
# bitwise-parity contract covers. Timings (durations, backoff_total,
# critical_path/total_work) vary run to run and are excluded.
JOURNAL_PARITY_FIELDS = ("kind", "order", "wave", "waves", "completed",
                         "retries", "status")


def state_fingerprint(doc: StateDocument, with_journal: bool = True) -> str:
    """Canonical bytes of everything the parallel-vs-serial parity
    contract covers: applied modules + outputs, the full cloud dict
    (content-addressed ids/ips, fault-plan fired counts, op clocks), and
    — unless ``with_journal=False`` — the journal's deterministic fields
    (:data:`JOURNAL_PARITY_FIELDS`).

    Every consumer (tests, the chaos harness) compares the same bytes.
    """
    est = load_executor_state(doc)
    fp: Dict[str, Any] = {"modules": est.modules, "cloud": est.cloud,
                          "serial": est.serial}
    if with_journal:
        fp["journal"] = {k: est.journal.get(k)
                         for k in JOURNAL_PARITY_FIELDS}
    return json.dumps(fp, sort_keys=True)


def modules_fingerprint(doc: StateDocument) -> str:
    """Canonical bytes of the applied module records alone (configs,
    outputs, resources) — the convergence contract for interrupted runs:
    a killed-and-resumed apply must end with the same *modules* as an
    uninterrupted one, even though its cloud op clocks and journal
    necessarily differ (the retried ops ticked extra mutations)."""
    return json.dumps(load_executor_state(doc).modules, sort_keys=True)


class LocalExecutor:
    """Drives modules in-process. The default executor everywhere.

    Apply and destroy run as a **wavefront** over the module DAG: every
    module whose dependencies are satisfied is dispatched to a bounded
    worker pool (``parallelism``), and dependents are released as each
    module completes — so a fan-out doc pays its critical path, not the
    sum of every module's wall time. ``parallelism=1`` executes inline in
    the calling thread, in exact topological order — byte-identical to
    the historical serial loop. Final applied state, outputs, and
    fault-plan firings are identical at every parallelism (test-pinned):
    simulator ids are content-addressed, its lists are kept sorted and
    per-module fault anchors are interleaving-independent.
    """

    def __init__(self, log: Optional[Callable[[str], None]] = None,
                 logger=None, retry: Optional[RetryPolicy] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 parallelism: int = 1,
                 driver_factory: Optional[Callable[..., Any]] = None):
        from ..utils.logging import get_logger

        self.logger = logger if logger is not None else get_logger()
        self.log = log or (lambda msg: self.logger.info(msg))
        # Injected driver construction (make_driver's signature): the seam
        # the chaos harness uses to hand the simulator a recording sleeper
        # or a kill hook -- things a JSON driver config cannot carry.
        self._make_driver = (driver_factory if driver_factory is not None
                             else make_driver)
        self.retry = retry if retry is not None else RetryPolicy()
        # Injected sleeper: tests drive backoff without wall-clock waits.
        self._sleep = sleep if sleep is not None else time.sleep
        # Wavefront width. The CLI defaults this to 4 (terraform's
        # -parallelism analog); the constructor default stays 1 so
        # embedders and tests get the exact serial contract unless they
        # opt in.
        self.parallelism = max(1, int(parallelism))

    # ------------------------------------------------------------------- plan
    def plan(self, doc: StateDocument, targets: Optional[List[str]] = None) -> Plan:
        desired = doc.get("module") or {}
        est = load_executor_state(doc)
        plan = diff_states(desired, est.modules, targets)
        self._taint_dependents(plan, desired, targets)
        return plan

    @staticmethod
    def _taint_dependents(plan: Plan, desired: Dict[str, Any],
                          targets: Optional[List[str]]) -> None:
        """A module whose dependency is being (re)applied must re-resolve its
        interpolations even though its own config text is unchanged — configs
        are compared *unresolved*, so without this, changed upstream outputs
        would never propagate (terraform re-converges here; so must we)."""
        deps = module_dependencies(desired)
        tset = set(targets) if targets is not None else None
        changed = True
        while changed:
            changed = False
            for name, dset in deps.items():
                if tset is not None and name not in tset:
                    continue
                if plan.actions.get(name) is PlanAction.NOOP and any(
                    plan.actions.get(d) in (PlanAction.CREATE, PlanAction.UPDATE)
                    for d in dset
                ):
                    plan.actions[name] = PlanAction.UPDATE
                    changed = True

    # -------------------------------------------------------------- wavefront
    @staticmethod
    def _dag_waves(names: List[str],
                   deps: Dict[str, Set[str]]) -> Dict[str, int]:
        """Deterministic wave index per name: one past the deepest in-set
        dependency (wave 0 = no deps in the set). Pure DAG depth — the
        same at every parallelism, independent of durations and
        interleaving, which is what lets the journal's wave field survive
        the bitwise-parity contract. ``names`` must be ordered so every
        dependency precedes its dependents."""
        wave: Dict[str, int] = {}
        for n in names:
            wave[n] = max((wave[d] + 1 for d in deps[n] if d in wave),
                          default=0)
        return wave

    def _run_wavefront(self, names: List[str], deps: Dict[str, Set[str]],
                       workers: int, task: Callable[[str], Any],
                       complete: Callable[[str, Any], None],
                       journal: Dict[str, Any],
                       lock: threading.RLock) -> None:
        """Dispatch every name whose in-set dependencies are complete to a
        bounded worker pool, releasing dependents as each completes.

        ``workers == 1`` executes inline in the calling thread in exact
        ``names`` order — same thread, same span nesting, same save
        cadence as the historical serial loop. On a failure no new work
        is dispatched; in-flight siblings run to completion and are
        committed (their state is saved, so a re-run NOOPs them), then
        the first failure in dispatch order is re-raised.
        """
        gauge = metrics.gauge("tk8s_apply_in_flight")
        in_flight: List[str] = []

        def run_one(name: str) -> Any:
            with lock:
                in_flight.append(name)
                journal["max_in_flight"] = max(journal["max_in_flight"],
                                               len(in_flight))
            gauge.inc()
            try:
                return task(name)
            except BaseException as e:
                # Attribute failures the task layer didn't journal itself
                # (pre-apply validation, interpolation, interrupts).
                with lock:
                    if journal.get("failed") is None:
                        journal["failed"] = {
                            "module": name, "error": str(e),
                            "kind": classify_fault(e),
                            "attempts":
                                journal.get("retries", {}).get(name, 0) + 1,
                        }
                raise
            finally:
                gauge.dec()
                with lock:
                    in_flight.remove(name)

        if workers <= 1 or len(names) <= 1:
            for name in names:
                complete(name, run_one(name))
            return

        order_idx = {n: i for i, n in enumerate(names)}
        waiting: Dict[str, Set[str]] = {}
        ready: List[str] = []
        for n in names:
            if deps[n]:
                waiting[n] = set(deps[n])
            else:
                ready.append(n)
        errors: List[Tuple[int, str, BaseException]] = []
        futures: Dict[Any, str] = {}
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="tk8s-wavefront") as pool:
            while True:
                while ready and not errors and len(futures) < workers:
                    name = ready.pop(0)
                    futures[pool.submit(run_one, name)] = name
                if not futures:
                    break
                done, _ = _futures_wait(list(futures),
                                        return_when=FIRST_COMPLETED)
                for fut in done:
                    name = futures.pop(fut)
                    try:
                        result = fut.result()
                    except BaseException as e:
                        errors.append((order_idx[name], name, e))
                        continue
                    complete(name, result)
                    for m in list(waiting):
                        pset = waiting[m]
                        pset.discard(name)
                        if not pset:
                            del waiting[m]
                            ready.append(m)
                    ready.sort(key=order_idx.__getitem__)
        if errors:
            errors.sort(key=lambda t: t[0])
            _, name, exc = errors[0]
            with lock:
                failed = journal.get("failed")
                # Concurrent failures race the journal's single failed
                # slot; pin it to the error actually re-raised.
                if failed is None or failed.get("module") != name:
                    journal["failed"] = {
                        "module": name, "error": str(exc),
                        "kind": classify_fault(exc),
                        "attempts":
                            journal.get("retries", {}).get(name, 0) + 1,
                    }
            raise exc
        if waiting:  # unreachable: topo_order rejects cycles up front
            raise ApplyError(
                f"wavefront deadlock: unrunnable modules {sorted(waiting)}")

    def _effective_workers(self, cloud: CloudSimulator,
                           parallelism: Optional[int],
                           n_modules: int) -> int:
        """The wavefront width actually used: the requested/configured
        parallelism, with a heads-up that at_op-anchored fault plans are
        only deterministic serially."""
        workers = max(1, int(parallelism if parallelism is not None
                             else self.parallelism))
        plan_obj = cloud.fault_plan
        if (workers > 1 and n_modules > 1 and plan_obj is not None
                and any("at_op" in r for r in plan_obj.rules)):
            self.logger.warn(
                "fault plan uses at_op (global-clock) anchors, which are "
                "only deterministic at --parallelism 1; use module/"
                "at_module_op anchors for interleaving-safe injection")
        return workers

    @staticmethod
    def _finalize_journal(journal: Dict[str, Any], names: List[str],
                          deps: Dict[str, Set[str]]) -> None:
        """Record the speedup accounting: total work (sum of module
        durations) vs critical path (longest dependency chain) — the two
        numbers whose ratio bounds what any parallelism can buy."""
        durs = journal.get("durations", {})
        total = 0.0
        finish: Dict[str, float] = {}
        for n in names:
            if n not in durs:
                continue
            total += durs[n]
            finish[n] = durs[n] + max(
                (finish[d] for d in deps[n] if d in finish), default=0.0)
        journal["total_work_seconds"] = total
        journal["critical_path_seconds"] = max(finish.values(), default=0.0)
        kind = journal.get("kind", "apply")
        metrics.gauge("tk8s_apply_total_work_seconds").set(total, kind=kind)
        metrics.gauge("tk8s_apply_critical_path_seconds").set(
            journal["critical_path_seconds"], kind=kind)

    # ------------------------------------------------------------------ apply
    def apply(self, doc: StateDocument, targets: Optional[List[str]] = None,
              parallelism: Optional[int] = None) -> Plan:
        desired: Dict[str, Any] = doc.get("module") or {}
        est = load_executor_state(doc)
        plan = diff_states(desired, est.modules, targets)
        self._taint_dependents(plan, desired, targets)
        self.log(plan.summary())

        cloud = self._make_driver(doc, est.cloud)
        order = topo_order(desired)
        outputs: Dict[str, Dict[str, Any]] = {
            name: rec.get("outputs", {}) for name, rec in est.modules.items()
        }

        run_order = [n for n in order
                     if plan.actions.get(n, PlanAction.NOOP)
                     in (PlanAction.CREATE, PlanAction.UPDATE)]
        workers = self._effective_workers(cloud, parallelism, len(run_order))
        deps_all = module_dependencies(desired)
        run_set = set(run_order)
        deps = {n: deps_all.get(n, set()) & run_set for n in run_order}
        wave = self._dag_waves(run_order, deps)
        waves_total = (max(wave.values()) + 1) if wave else 0
        est.journal = {
            "version": 2,
            "kind": "apply",
            "doc": doc.name,
            "order": run_order,
            "parallelism": workers,
            "wave": wave,
            "waves": waves_total,
            "completed": [],
            "retries": {},
            "durations": {},
            "backoff_total": 0.0,
            "max_in_flight": 0,
            "failed": None,
            "status": "in-progress",
        }
        journal = est.journal
        if waves_total:
            metrics.counter("tk8s_apply_waves_total").inc(waves_total)
        lock = threading.RLock()

        # State is saved even on a mid-apply failure, so resources provisioned
        # before the error stay on record (terraform persists errored applies;
        # dropping the record would orphan real resources behind a real driver).
        # It is also saved after EVERY completed module (not just at the end),
        # so even a hard process kill resumes from the last healthy module —
        # including a kill mid-wave: completed siblings NOOP, the rest re-run.
        current = ""  # in-flight prune target, for journal attribution
        try:
            with self.logger.span("apply", doc=doc.name,
                                  parallelism=workers) as apply_span, \
                    tempfile.TemporaryDirectory(prefix="tk-gpu-apply-") as workdir:

                def task(name: str):
                    action = plan.actions[name]
                    raw_cfg = desired[name]
                    module = get_module(raw_cfg.get("source", ""))
                    cfg = module.validate(raw_cfg)
                    # Outputs snapshot under the lock: every dependency has
                    # committed (the scheduler released us only then), so
                    # the view is complete for this module and immune to
                    # concurrent sibling commits.
                    with lock:
                        visible = dict(outputs)
                    try:
                        resolved = resolve(cfg, visible)
                    except KeyError as e:
                        raise ApplyError(f"module {name!r}: {e}") from e
                    ctx = DriverContext(cloud=cloud, workdir=workdir,
                                        module_key=name)
                    # under(): worker threads adopt the apply span so
                    # logs/traces keep the apply/module.<name> nesting
                    # (no-op on the serial inline path).
                    with cloud.module_scope(name), \
                            self.logger.under(apply_span), \
                            self.logger.span(f"module.{name}",
                                             action=action.value,
                                             source=module.SOURCE) as msp:
                        mod_outputs, resources = self._apply_one_with_retry(
                            name, module, resolved, ctx, journal, lock)
                    # One truth for this module's wall time: the span's
                    # duration feeds the histogram, the journal, and (via
                    # --trace-out) the exported trace event identically.
                    metrics.histogram(
                        "tk8s_module_apply_duration_seconds").observe(
                        msp.duration_s, module=name)
                    with lock:
                        journal["durations"][name] = msp.duration_s
                    missing = [o for o in module.OUTPUTS
                               if o not in mod_outputs]
                    if missing:
                        raise FatalApplyError(
                            f"module {name!r} did not produce outputs "
                            f"{missing}")
                    return raw_cfg, mod_outputs, resources

                def complete(name: str, result) -> None:
                    raw_cfg, mod_outputs, resources = result
                    with lock:
                        outputs[name] = mod_outputs
                        est.modules[name] = {
                            # Deep-copied: the doc may be mutated after apply
                            # and must not retroactively change the applied
                            # record.
                            "config": copy.deepcopy(raw_cfg),
                            "outputs": mod_outputs,
                            "resources": [r.to_dict() for r in resources],
                        }
                        journal["completed"].append(name)
                        # Serial runs keep the historical zero-copy
                        # to_dict; only concurrent lanes need the
                        # deep-copied consistent snapshot.
                        est.cloud = (cloud.to_dict() if workers == 1
                                     else cloud.snapshot())
                        save_executor_state(doc, est)

                self._run_wavefront(run_order, deps, workers, task, complete,
                                    journal, lock)

                # Modules present in applied state but gone from the doc:
                # prune dependents-first (same ordering contract as destroy()).
                delete_names = set(plan.by_action(PlanAction.DELETE))
                cfgs = {n: est.modules[n].get("config", {}) for n in est.modules}
                prune_order = [n for n in topo_order(cfgs) if n in delete_names]
                for name in reversed(prune_order):
                    current = f"{name} (prune)"
                    self._destroy_one(name, est, cloud, workdir)
            journal["status"] = "ok"
            # Deterministic journal order on success: completion order is
            # a race at parallelism > 1; run_order restricted to what
            # completed is the same list at parallelism 1 and canonical
            # at any other width.
            done = set(journal["completed"])
            journal["completed"] = [n for n in run_order if n in done]
        except BaseException as e:
            if journal["failed"] is None:
                journal["failed"] = {"module": current, "error": str(e),
                                     "kind": classify_fault(e), "attempts": 1}
            journal["status"] = "failed"
            raise
        finally:
            self._finalize_journal(journal, run_order, deps)
            metrics.counter("tk8s_applies_total").inc(
                status=journal["status"])
            est.cloud = cloud.snapshot()
            save_executor_state(doc, est)
        return plan

    def _apply_one_with_retry(self, name: str, module, resolved, ctx,
                              journal: Dict[str, Any],
                              lock: threading.RLock):
        """Run one module's apply under the retry policy.

        Transient faults retry with capped exponential backoff until
        ``max_retries`` or the ``deadline`` runs out; fatal faults raise
        immediately. The deadline is a **per-module** backoff budget: a
        flaking branch sleeps on its own clock and never eats into — or
        stalls — siblings running in parallel lanes (for a single failing
        module this is exactly the historical apply-wide budget).
        Retrying a half-applied module is safe by contract: module applies
        are idempotent create-or-get (modules/base.py), so completed ops
        no-op and the module resumes at the op that failed.
        """
        policy = self.retry
        attempt = 0
        backoff_spent = 0.0  # this module's own budget
        while True:
            metrics.counter("tk8s_module_apply_attempts_total").inc(
                module=name)
            try:
                result = module.apply(resolved, ctx)
                with lock:
                    failed = journal.get("failed")
                    # Recovered: the record is history — but only this
                    # module's; a concurrent sibling's failure must stand.
                    if failed is not None and failed.get("module") == name:
                        journal["failed"] = None
                return result
            except Exception as e:
                kind = classify_fault(e)
                metrics.counter("tk8s_apply_faults_total").inc(kind=kind)
                with lock:
                    failed = journal.get("failed")
                    if failed is None or failed.get("module") == name:
                        journal["failed"] = {"module": name, "error": str(e),
                                             "kind": kind,
                                             "attempts": attempt + 1}
                if kind == "fatal":
                    if isinstance(e, ApplyError):
                        raise
                    raise FatalApplyError(f"module {name!r}: {e}") from e
                if attempt >= policy.max_retries:
                    raise TransientApplyError(
                        f"module {name!r}: transient fault persisted after "
                        f"{attempt + 1} attempts: {e}") from e
                delay = policy.delay(attempt)
                if backoff_spent + delay > policy.deadline:
                    raise TransientApplyError(
                        f"module {name!r}: apply deadline exhausted "
                        f"({policy.deadline}s backoff budget) after "
                        f"{attempt + 1} attempts: {e}") from e
                attempt += 1
                backoff_spent += delay
                with lock:
                    journal["retries"][name] = attempt
                    journal["backoff_total"] += delay
                metrics.counter("tk8s_apply_retries_total").inc(module=name)
                metrics.counter("tk8s_apply_backoff_seconds_total").inc(delay)
                self.log(f"module.{name}: transient fault "
                         f"(attempt {attempt}/{policy.max_retries}, "
                         f"retry in {delay:g}s): {e}")
                self._sleep(delay)

    # ---------------------------------------------------------------- destroy
    def destroy(self, doc: StateDocument, targets: Optional[List[str]] = None,
                parallelism: Optional[int] = None) -> None:
        """Destroy targeted modules (or everything when targets is None) —
        RunTerraformDestroyWithState analog (shell/run_terraform.go:104).

        Runs as a **reverse wavefront** (dependents-first: a dependency is
        torn down only after every dependent in the destroy set is gone),
        with journal + metrics parity with apply: a v2 journal of kind
        ``destroy`` saved after every removed module (a killed destroy
        resumes over the survivors) and per-module durations in
        ``tk8s_module_destroy_duration_seconds``.
        """
        est = load_executor_state(doc)
        cloud = self._make_driver(doc, est.cloud)
        names = list(est.modules) if targets is None else [
            t for t in targets if t in est.modules
        ]
        # Reverse dependency order: dependents first.
        cfgs = {n: est.modules[n].get("config", {}) for n in est.modules}
        destroy_order = [n for n in reversed(topo_order(cfgs)) if n in names]
        # Reversed edges: module d may go only after every module that
        # depends on it (within the destroy set) has gone.
        deps_all = module_dependencies(cfgs)
        dset = set(destroy_order)
        rdeps: Dict[str, Set[str]] = {n: set() for n in destroy_order}
        for m in destroy_order:
            for d in deps_all.get(m, set()):
                if d in rdeps:
                    rdeps[d].add(m)
        workers = self._effective_workers(cloud, parallelism,
                                          len(destroy_order))
        wave = self._dag_waves(destroy_order, rdeps)
        waves_total = (max(wave.values()) + 1) if wave else 0
        est.journal = {
            "version": 2,
            "kind": "destroy",
            "doc": doc.name,
            "order": destroy_order,
            "parallelism": workers,
            "wave": wave,
            "waves": waves_total,
            "completed": [],
            "retries": {},
            "durations": {},
            "max_in_flight": 0,
            "failed": None,
            "status": "in-progress",
        }
        journal = est.journal
        if waves_total:
            metrics.counter("tk8s_apply_waves_total").inc(waves_total)
        lock = threading.RLock()
        try:
            with self.logger.span("destroy", doc=doc.name,
                                  targets=len(destroy_order),
                                  parallelism=workers) as destroy_span, \
                    tempfile.TemporaryDirectory(
                        prefix="tk-gpu-destroy-") as workdir:

                def task(name: str) -> None:
                    rec = est.modules.get(name)
                    if rec is None:
                        return
                    with cloud.module_scope(name), \
                            self.logger.under(destroy_span), \
                            self.logger.span(f"module.{name}",
                                             action="destroy") as msp:
                        self._destroy_module_resources(name, rec, cloud,
                                                       workdir)
                    metrics.histogram(
                        "tk8s_module_destroy_duration_seconds").observe(
                        msp.duration_s, module=name)
                    with lock:
                        journal["durations"][name] = msp.duration_s

                def complete(name: str, _result) -> None:
                    with lock:
                        est.modules.pop(name, None)
                        journal["completed"].append(name)
                        est.cloud = (cloud.to_dict() if workers == 1
                                     else cloud.snapshot())
                        save_executor_state(doc, est)

                self._run_wavefront(destroy_order, rdeps, workers, task,
                                    complete, journal, lock)
            journal["status"] = "ok"
            done = set(journal["completed"])
            journal["completed"] = [n for n in destroy_order if n in done]
        except BaseException:
            journal["status"] = "failed"
            raise
        finally:
            self._finalize_journal(journal, destroy_order, rdeps)
            metrics.counter("tk8s_destroys_total").inc(
                status=journal["status"])
            est.cloud = cloud.snapshot()
            # A clean whole-graph destroy removes the state file outright
            # (nothing left to record); partial/failed/targeted destroys
            # persist the journal so the next run resumes the survivors.
            if journal["status"] == "ok" and targets is None:
                delete_executor_state(doc)
            else:
                save_executor_state(doc, est)

    def _destroy_one(self, name: str, est: ExecutorState,
                     cloud: CloudSimulator, workdir: str) -> None:
        rec = est.modules.get(name)
        if rec is None:
            return
        self._destroy_module_resources(name, rec, cloud, workdir)
        del est.modules[name]

    def _destroy_module_resources(self, name: str, rec: Dict[str, Any],
                                  cloud: CloudSimulator,
                                  workdir: str) -> None:
        """Tear down one applied module's resources (state bookkeeping is
        the caller's: the wavefront commits under its lock, the serial
        prune path via :meth:`_destroy_one`)."""
        self.log(f"module.{name}: destroy")
        try:
            module = get_module(rec.get("config", {}).get("source", ""))
        except Exception:
            module = None
        ctx = DriverContext(cloud=cloud, workdir=workdir, module_key=name)
        if module is not None:
            module.destroy(rec, ctx)
        else:
            for rdict in reversed(rec.get("resources", [])):
                cloud.delete_resource(rdict["type"], rdict["name"])

    # ----------------------------------------------------------------- output
    def output(self, doc: StateDocument, module_key: str) -> Dict[str, Any]:
        """One module's outputs from applied state (no re-init; fixes the
        reference's heavyweight read path, SURVEY.md §3.5)."""
        est = load_executor_state(doc)
        if module_key not in est.modules:
            raise OutputError(f"no applied module {module_key!r}")
        return dict(est.modules[module_key].get("outputs", {}))

    def cloud_view(self, doc: StateDocument) -> CloudSimulator:
        """Read-only view of the driver's cloud state (tests, `get`
        inspection). Always a plain simulator over the persisted dict — a
        read must never require (or touch) the real provisioner."""
        return CloudSimulator(load_executor_state(doc).cloud)
