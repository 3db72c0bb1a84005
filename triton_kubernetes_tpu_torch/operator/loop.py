"""The reconciler: a long-running observe -> diff -> act loop (the port's
copy of the reference's ``operator/loop.py``, over GPU pools).

One :meth:`Reconciler.tick` is the whole control loop, once:

1. **observe** — re-read the desired document from the backend, the
   applied/cloud state from the executor, and the serving fleet's
   windowed metrics (:mod:`.observe`);
2. **autoscale** — the policy (:mod:`.autoscaler`) may edit desired
   state (add/remove a GPU pool module), turning a metrics signal into
   ordinary drift;
3. **diff** — compute the typed delta (:func:`~.reconcile.compute_delta`);
4. **act** — run the reconcile rules over exactly that delta
   (:func:`~.reconcile.act`), persisting the document after success.

Every tick is journaled the way apply journals modules — a structured
record of what was observed, decided, and done, kept in memory (bounded)
and optionally appended as JSONL — and exported as ``tk8s_operator_*``
metric families. Time comes only through the injected ``clock``/
``sleep`` seams (lint rule TK8S110): tests and the chaos harness drive
thousands of simulated ticks in milliseconds; ``tools.operate`` injects
the wall clock.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..state import StateDocument
from ..utils import metrics
from ..utils.trace import TraceWriter
from .autoscaler import Autoscaler, ScaleDecision, apply_decision, \
    record_decision
from .observe import MetricsWatcher, MetricsSource, ObservedState, observe
from .rebalance import RebalanceDecision, plan_rebalance
from .reconcile import act, compute_delta
from .trainfleet import TrainDecision, TrainFleetPolicy, TrainFleetStatus, \
    record_train_decision

#: Tick outcomes (journal/metrics vocabulary).
OUTCOMES = ("noop", "acted", "failed")

#: Sliding window (ticks with serving signal) over which the SLO
#: attainment gauges are computed.
SLO_WINDOW = 32


class OperatorError(RuntimeError):
    """The loop itself is misconfigured (no such manager/document) — as
    opposed to a tick whose rules failed, which is journaled and
    retried forever."""


@dataclass
class ReconcileTick:
    """One journaled reconcile decision."""

    tick: int
    at: float                      # injected-clock timestamp
    outcome: str = "noop"
    duration_s: float = 0.0
    observed: Dict[str, Any] = field(default_factory=dict)
    decision: Optional[Dict[str, Any]] = None
    train_decision: Optional[Dict[str, Any]] = None
    delta: Dict[str, Any] = field(default_factory=dict)
    actions: List[Dict[str, Any]] = field(default_factory=list)
    error: str = ""

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "tick": self.tick, "at": round(self.at, 6),
            "outcome": self.outcome,
            "duration_s": round(self.duration_s, 6),
            "observed": self.observed, "delta": self.delta,
            "actions": self.actions,
        }
        if self.decision is not None:
            out["decision"] = self.decision
        if self.train_decision is not None:
            out["train_decision"] = self.train_decision
        if self.error:
            out["error"] = self.error
        return out


class Reconciler:
    """The operator: converges one manager's document forever.

    ``autoscale_cluster`` names the GPU cluster whose pools the policy
    may scale (None = reconcile-only; the rules still run). The
    ``between_observe_and_act`` hook is the chaos seam — the harness
    preempts a pool there to pin that a world that changes mid-tick is
    converged by the *next* tick, exactly once, with no orphans.
    """

    def __init__(self, backend, executor, manager: str, *,
                 autoscaler: Optional[Autoscaler] = None,
                 autoscale_cluster: Optional[str] = None,
                 metrics_sources: Optional[List[MetricsSource]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 interval_s: float = 10.0,
                 journal_path: Optional[str] = None,
                 journal_limit: int = 1000,
                 trace: Optional[TraceWriter] = None,
                 log: Optional[Callable[[str], None]] = None,
                 rebalancer: Optional[Callable[[RebalanceDecision],
                                               Dict[str, Any]]] = None,
                 rebalance_gap: float = 0.0,
                 rebalance_high: float = 0.75,
                 train_policy: Optional[TrainFleetPolicy] = None,
                 train_status: Optional[
                     Callable[[], Optional[TrainFleetStatus]]] = None,
                 train_actuator: Optional[
                     Callable[[TrainDecision], Dict[str, Any]]] = None,
                 between_observe_and_act: Optional[
                     Callable[[ObservedState], None]] = None):
        from ..utils.logging import get_logger

        self.backend = backend
        self.executor = executor
        self.manager = manager
        self.autoscaler = autoscaler
        self.autoscale_cluster = autoscale_cluster
        self.watcher = MetricsWatcher(metrics_sources or [])
        self.clock = clock
        self._sleep = sleep
        self.interval_s = float(interval_s)
        self.journal_path = journal_path
        self.journal_limit = int(journal_limit)
        # Optional fleet-trace writer (utils/trace.py): every tick and
        # every scale actuation lands as a span on the SAME merged
        # Perfetto timeline the router and the serving replicas feed,
        # timestamped on the injected clock (the writer's meta anchor
        # maps it onto the shared wall timeline).
        self.trace = trace
        # KV-pressure rebalancing (operator/rebalance.py): the
        # actuation between grow and drain. ``rebalance_gap`` <= 0
        # disables it; ``rebalancer`` is the actuation seam
        # (http_rebalancer in production, a lambda in tests).
        self.rebalancer = rebalancer
        self.rebalance_gap = float(rebalance_gap)
        self.rebalance_high = float(rebalance_high)
        # Train-fleet arbitration (operator/trainfleet.py): the policy
        # decides replace / shrink-instead-of-wait / regrow from the
        # observed train status; the actuator is the resize seam
        # (JobSet re-render in production, launch_trainers relaunch in
        # the evidence harness, a lambda in tests). All three optional:
        # a serving-only operator never observes a train fleet.
        self.train_policy = train_policy
        self.train_status = train_status
        self.train_actuator = train_actuator
        self.journal: List[ReconcileTick] = []
        self.log = log or (lambda m: get_logger().info(m))
        self._between = between_observe_and_act
        self._ticks = 0
        # Injected-clock stamp of the last COMPLETED tick — the
        # liveness heartbeat `tools.operate` wires into /healthz (a
        # wedged tick stops the heartbeat; a dead loop must probe 503,
        # not keep answering 200 while the fleet drifts).
        self.last_tick_at: Optional[float] = None
        self._slo_hits: Dict[str, List[bool]] = {"ttft_p99": [],
                                                 "queue_depth": []}

    # ----------------------------------------------------------- document
    def _load_doc(self) -> StateDocument:
        states = self.backend.states()
        if self.manager not in states:
            raise OperatorError(
                f"no state document {self.manager!r} in the backend "
                f"(choices: {sorted(states)})")
        doc = self.backend.state(self.manager)
        doc.set_backend_config(
            self.backend.executor_backend_config(self.manager))
        return doc

    # ---------------------------------------------------------------- SLO
    def _track_slo(self, observed: ObservedState) -> None:
        if self.autoscaler is None or not observed.serving.has_signal:
            return
        cfg = self.autoscaler.config
        serving = observed.serving
        hits = self._slo_hits
        if serving.window_requests > 0:
            hits["ttft_p99"].append(serving.ttft_p99_s <= cfg.ttft_slo_p99_s)
        hits["queue_depth"].append(serving.queue_depth <= cfg.queue_high)
        for slo, window in hits.items():
            del window[:-SLO_WINDOW]
            if window:
                metrics.gauge("tk8s_operator_slo_attainment").set(
                    sum(window) / len(window), slo=slo)

    # --------------------------------------------------------------- tick
    def tick(self) -> ReconcileTick:
        """One observe -> autoscale -> diff -> act cycle. Never raises
        for rule failures (journaled, retried next tick); raises
        :class:`OperatorError` only for setup problems."""
        self._ticks += 1
        t0 = self.clock()
        record = ReconcileTick(tick=self._ticks, at=t0)
        doc = self._load_doc()
        observed = observe(doc, self.executor, self.watcher)
        record.observed = {
            "applied_modules": len(observed.applied_modules),
            "preempted": sorted(observed.preempted),
            "queue_depth": observed.serving.queue_depth,
            "ttft_p99_s": round(observed.serving.ttft_p99_s, 6),
            "window_requests": observed.serving.window_requests,
            "sources_ok": observed.serving.sources_ok,
            "last_apply_status": observed.last_apply_status,
        }
        serving = observed.serving
        useful = serving.goodput_useful_fraction
        if useful is not None:
            # Fleet chip-time attribution over THIS window (the per-
            # source counter deltas): the journal's goodput record and
            # the gauge the goodput-aware policy reads. None (no
            # counters moved) leaves the gauge standing — a blind tick
            # is "no signal", not "0% useful".
            record.observed["goodput"] = {
                "accounted_s": round(serving.goodput_accounted_s, 6),
                "useful_fraction": round(useful, 6),
                "waste_fraction": round(
                    serving.goodput_waste_fraction or 0.0, 6),
                "window": {src: {c: round(v, 6)
                                 for c, v in sorted(cats.items())}
                           for src, cats in
                           sorted(serving.goodput_window.items())},
            }
            metrics.gauge("tk8s_operator_fleet_goodput").set(useful)
        if serving.kv_bytes:
            # Per-replica KV pressure rides the same journal record:
            # the capacity signal next to the efficiency signal.
            record.observed["kv_bytes"] = {
                str(i): round(v, 1)
                for i, v in sorted(serving.kv_bytes.items())}
        if serving.kv_utilization:
            record.observed["kv_utilization"] = {
                str(i): round(v, 6)
                for i, v in sorted(serving.kv_utilization.items())}
        self._track_slo(observed)

        decision: Optional[ScaleDecision] = None
        pools_before = 0
        if self.autoscaler is not None and self.autoscale_cluster:
            pools = observed.gpu_pools.get(self.autoscale_cluster, [])
            pools_before = len(pools)
            if pools:
                decision = self.autoscaler.decide(
                    observed, pools, self.autoscale_cluster, t0)
                record_decision(decision)
                record.decision = decision.to_dict()
                changed = apply_decision(doc, decision, pools)
                if changed is not None:
                    self.log(f"autoscaler: {decision.direction} "
                             f"{changed} ({decision.reason})")
                    # The document changed: re-plan (no re-scrape — a
                    # second scrape would double-count the windowed
                    # serving deltas) so the delta sees the new/removed
                    # pool as ordinary drift.
                    observed = observe(doc, self.executor, None)

        delta = compute_delta(observed)
        record.delta = delta.to_dict()

        if self._between is not None:
            # Chaos seam: the world changes between diff and act.
            self._between(observed)

        if delta.empty:
            record.outcome = "noop"
        else:
            outcomes = act(self.backend, self.executor, self.manager, doc,
                           delta)
            record.actions = [o.to_dict() for o in outcomes]
            failed = [o for o in outcomes if not o.ok]
            record.outcome = "failed" if failed else "acted"
            if failed:
                record.error = failed[0].error
                self.log(f"reconcile tick {self._ticks}: rule "
                         f"{failed[0].rule} failed: {failed[0].error}")
        self._maybe_rebalance(record, serving, decision)
        self._maybe_train_resize(record, serving, t0)
        if decision is not None:
            landed = True
            if decision.direction in ("grow", "drain"):
                # Cooldown/hysteresis arm only on a LANDED scale
                # action — landed meaning the edited desired document
                # persisted. Any successful converge/drain rule
                # persists the whole doc, so a drain whose
                # converge-drift persisted the deletion but whose
                # prune then failed still counts (the leftover
                # resources are ordinary to_prune drift next tick —
                # re-deciding would shed a second pool off one calm
                # trend). A tick where no rule persisted leaves the
                # counters standing so the next tick re-decides
                # immediately.
                landed = any(
                    a.get("ok") and a.get("rule") in
                    ("converge-drift", "drain-orphans")
                    for a in record.actions)
                self.autoscaler.record_actuation(landed, t0)
            # Pool-count gauge from what actually holds: the decided
            # count only once the apply landed, else the pre-decision
            # count (the persisted document never changed).
            metrics.gauge("tk8s_operator_pools").set(
                decision.pools if landed else pools_before,
                cluster=self.autoscale_cluster)
        record.duration_s = self.clock() - t0
        self.last_tick_at = self.clock()
        if self.trace is not None:
            self.trace.event("operator.tick", t0, record.duration_s,
                             tick=self._ticks, outcome=record.outcome)
            if decision is not None and decision.direction in ("grow",
                                                               "drain"):
                self.trace.event("operator.scale", t0,
                                 record.duration_s,
                                 direction=decision.direction,
                                 reason=decision.reason,
                                 pools=decision.pools)
            # Ticks are seconds apart — the writer's event batching
            # (sized for the engine's hot tick path) would hold the
            # last ticks in memory exactly when a crashed operator
            # needs them on disk. Flush each tick.
            self.trace.flush()
        metrics.counter("tk8s_operator_reconciles_total").inc(
            outcome=record.outcome)
        metrics.histogram(
            "tk8s_operator_reconcile_duration_seconds").observe(
            record.duration_s)
        self._journal(record)
        return record

    # ---------------------------------------------------------- rebalance
    def _maybe_rebalance(self, record: ReconcileTick, serving: Any,
                         decision: Optional[ScaleDecision]) -> None:
        """The actuation BETWEEN grow and drain: only on a tick where
        the fleet converged (outcome noop) and the scaling policy held
        — growing or draining already changes every replica's share,
        so moving sessions in the same tick would chase a stale
        picture. Fires at most one migration per tick (the next tick
        re-observes both pools before moving anything else)."""
        if (self.rebalancer is None or self.rebalance_gap <= 0
                or record.outcome != "noop"
                or (decision is not None
                    and decision.direction != "hold")):
            return
        plan = plan_rebalance(serving.kv_utilization,
                              gap_threshold=self.rebalance_gap,
                              high_watermark=self.rebalance_high)
        if plan is None:
            return
        t0 = self.clock()
        try:
            result = self.rebalancer(plan)
            status = str(result.get("status", "ok"))
        except Exception as e:  # the seam reaches the network
            result, status = {"error": str(e)}, "failed"
        action: Dict[str, Any] = {"rule": "rebalance",
                                  "ok": status != "failed",
                                  "status": status, **plan.to_dict()}
        for key in ("request_id", "error"):
            if result.get(key):
                action[key] = str(result[key])
        record.actions.append(action)
        if status == "failed":
            record.outcome = "failed"
            record.error = action.get("error", "rebalance failed")
            self.log(f"rebalance failed: {record.error}")
        elif status == "ok":
            record.outcome = "acted"
            self.log(f"rebalance: moved {action.get('request_id')} "
                     f"from source {plan.source} to {plan.target} "
                     f"(gap {plan.gap:.2f})")
        if status in ("ok", "failed"):
            # "noop" (nothing exportable) is observation, not
            # actuation — only real attempts count.
            metrics.counter("tk8s_operator_rebalances_total").inc(
                status=status)
        if self.trace is not None:
            self.trace.event("operator.rebalance", t0,
                             self.clock() - t0, source=plan.source,
                             target=plan.target, gap=round(plan.gap, 6),
                             status=status)

    # ---------------------------------------------------------- train fleet
    def _maybe_train_resize(self, record: ReconcileTick, serving: Any,
                            t0: float) -> None:
        """Observe -> decide -> actuate for the train fleet, on every
        tick the seams are wired. Decisions (hold included) journal and
        count; only non-hold decisions reach the actuator, at most one
        per tick — the next tick re-observes what the resize actually
        did before deciding anything else."""
        if self.train_policy is None or self.train_status is None:
            return
        status = self.train_status()
        if status is not None:
            record.observed["train"] = status.to_dict()
        decision = self.train_policy.decide(status, serving, t0)
        record.train_decision = decision.to_dict()
        record_train_decision(decision)
        if decision.direction == "hold" or self.train_actuator is None:
            return
        try:
            result = self.train_actuator(decision)
            status_str = str(result.get("status", "ok"))
        except Exception as e:  # the seam reaches processes/network
            result, status_str = {"error": str(e)}, "failed"
        ok = status_str != "failed"
        self.train_policy.record_actuation(ok, t0)
        action: Dict[str, Any] = {"rule": "train-resize", "ok": ok,
                                  "status": status_str,
                                  **decision.to_dict()}
        for key in ("error", "path", "run_dir"):
            if result.get(key):
                action[key] = str(result[key])
        record.actions.append(action)
        if not ok:
            record.outcome = "failed"
            record.error = action.get("error", "train resize failed")
            self.log(f"train resize failed: {record.error}")
        else:
            record.outcome = "acted"
            self.log(f"train fleet: {decision.direction} -> "
                     f"{decision.workers} workers ({decision.reason})")
        metrics.gauge("tk8s_operator_train_workers").set(
            decision.workers if ok and status is not None
            else (status.running_workers if status is not None else 0))
        if self.trace is not None:
            self.trace.event("operator.train_resize", t0,
                             self.clock() - t0,
                             direction=decision.direction,
                             workers=decision.workers,
                             reason=decision.reason, status=status_str)

    # ------------------------------------------------------------ journal
    def _journal(self, record: ReconcileTick) -> None:
        self.journal.append(record)
        del self.journal[:-self.journal_limit]
        if self.journal_path:
            with open(self.journal_path, "a") as f:
                json.dump(record.to_dict(), f, sort_keys=True)
                f.write("\n")

    # ---------------------------------------------------------------- run
    @property
    def converged(self) -> bool:
        """True when the most recent tick observed no drift and acted
        on nothing (the steady state a healthy fleet sits in)."""
        return bool(self.journal) and self.journal[-1].outcome == "noop"

    def run(self, max_ticks: Optional[int] = None,
            until_converged: bool = False,
            should_stop: Optional[Callable[[], bool]] = None) -> int:
        """Tick until a bound is hit: ``max_ticks`` ticks, convergence
        (``until_converged``), or ``should_stop()`` (the CLI's SIGINT
        flag). Sleeps ``interval_s`` between ticks through the injected
        sleeper. Returns the number of ticks taken."""
        taken = 0
        while True:
            if should_stop is not None and should_stop():
                return taken
            self.tick()
            taken += 1
            if max_ticks is not None and taken >= max_ticks:
                return taken
            if until_converged and self.converged:
                return taken
            self._sleep(self.interval_s)
