"""Metrics-driven GPU autoscaling at pool granularity (the port's copy of
the reference's ``operator/autoscaler.py``).

The policy watches two live serving signals — fleet queue depth
(``tk8s_serve_queue_depth``) and windowed TTFT p99 (quantiled from the
``tk8s_serve_ttft_seconds`` bucket deltas) — and grows or drains the
desired document's GPU node-pool modules (``gcp-gpu-nodepool``, keyed
``node_gcp-gpu_<cluster>_<pool>``). It only ever edits **desired
state**; the reconcile rules (converge-drift / drain-orphans) do the
provisioning, so a scale decision is durable the moment the document
persists and survives operator restarts like any other drift.

Guard rails, in decision order (each is a journaled ``reason``):

* **no-signal** — a blind fleet (zero sources, or every scrape failed)
  holds; scaling on blindness is how autoscalers flap to zero. An
  *idle* window with healthy scrapes is different: that is the
  overnight trough, and counting it as calm (drain-eligible) is the
  point of the day curve.
* **repair-first** — while any pool is preempted, capacity decisions
  wait: the replacement pool is already on its way, and shrinking under
  a dead pool double-counts the loss.
* **hysteresis** — a breach (or calm) must persist ``scale_up_after``
  (``scale_down_after``) consecutive ticks; one bursty tick is traffic,
  N are a trend.
* **cooldown** — after any grow/drain, decisions hold ``cooldown_s``
  (on the injected clock) so the fleet's response to the last action is
  in the window being judged, not the action itself.
* **risk-floor** — preemption-risk weighting: an exponentially-decayed
  score of observed pool preemptions raises the minimum pool count
  (spot reclaims cluster in time; capacity that just vanished once is
  likely to vanish again), so drains are blocked while risk is hot.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..state import StateDocument
from ..utils import metrics
from .observe import ObservedState

DIRECTIONS = ("grow", "drain", "hold")


@dataclass
class AutoscalerConfig:
    """Policy knobs (documented in docs/guide/operator.md)."""

    ttft_slo_p99_s: float = 0.5     # the SLO the loop defends
    queue_high: float = 8.0         # fleet queue depth that means "behind"
    queue_low: float = 1.0          # and "comfortably ahead"
    min_pools: int = 1
    max_pools: int = 4
    scale_up_after: int = 2         # consecutive breached ticks
    scale_down_after: int = 5       # consecutive calm ticks
    cooldown_s: float = 60.0        # clock seconds after any action
    risk_per_preemption: float = 1.0   # score added per observed reclaim
    risk_decay: float = 0.8         # per-tick multiplicative decay
    risk_floor_weight: float = 1.0  # extra floor pools per unit of risk

    def validate(self) -> None:
        if self.min_pools < 1:
            raise ValueError(f"min_pools must be >= 1, got {self.min_pools}")
        if self.max_pools < self.min_pools:
            raise ValueError(
                f"max_pools ({self.max_pools}) must be >= min_pools "
                f"({self.min_pools})")
        if self.scale_up_after < 1 or self.scale_down_after < 1:
            raise ValueError("hysteresis tick counts must be >= 1")
        if not 0.0 <= self.risk_decay < 1.0:
            raise ValueError(
                f"risk_decay must be in [0, 1), got {self.risk_decay}")


@dataclass
class ScaleDecision:
    direction: str           # grow / drain / hold
    reason: str
    pools: int               # desired pool count AFTER this decision
    cluster: str = ""
    detail: str = ""
    risk: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"direction": self.direction, "reason": self.reason,
                "pools": self.pools, "cluster": self.cluster,
                "detail": self.detail, "risk": round(self.risk, 4)}


class Autoscaler:
    """One cluster's scaling policy. Stateful across ticks (hysteresis
    counters, cooldown stamp, decayed risk score) but cheap to rebuild:
    a restarted operator re-earns its hysteresis before acting, which is
    the conservative failure mode."""

    def __init__(self, config: Optional[AutoscalerConfig] = None):
        self.config = config or AutoscalerConfig()
        self.config.validate()
        self._breach_ticks = 0
        self._calm_ticks = 0
        self._last_action_at: Optional[float] = None
        self._risk = 0.0
        self._seen_preemptions = 0

    # ------------------------------------------------------------- signals
    def _update_risk(self, observed: ObservedState) -> float:
        total = sum(observed.preempt_history.values())
        new_events = max(0, total - self._seen_preemptions)
        self._seen_preemptions = max(self._seen_preemptions, total)
        self._risk = (self._risk * self.config.risk_decay
                      + new_events * self.config.risk_per_preemption)
        return self._risk

    def floor(self) -> int:
        """The effective minimum pool count under the current risk
        score: ``min_pools`` plus risk-weighted headroom, capped at
        ``max_pools`` (risk can block drains, never force an
        over-quota grow)."""
        extra = int(math.ceil(self._risk * self.config.risk_floor_weight)) \
            if self._risk >= 0.5 else 0
        return min(self.config.max_pools, self.config.min_pools + extra)

    # ------------------------------------------------------------ decision
    def decide(self, observed: ObservedState, pool_keys: List[str],
               cluster: str, now: float) -> ScaleDecision:
        """One tick's decision given the observation and the current
        desired pool module keys. Pure with respect to the document —
        the caller applies grow/drain via :func:`apply_decision`."""
        cfg = self.config
        pools = len(pool_keys)
        risk = self._update_risk(observed)

        def hold(reason: str, detail: str = "") -> ScaleDecision:
            return ScaleDecision("hold", reason, pools, cluster, detail,
                                 risk)

        serving = observed.serving
        if not serving.has_signal:  # zero sources, or all scrapes failed
            self._breach_ticks = 0
            self._calm_ticks = 0
            return hold("no-signal",
                        f"{serving.sources_ok}/{serving.sources_total} "
                        f"sources answered")
        if observed.preempted:
            # Capacity decisions wait for repair: the signal is polluted
            # by the dead pool and the replacement is already drift.
            self._breach_ticks = 0
            self._calm_ticks = 0
            return hold("repair-first",
                        f"preempted: {sorted(observed.preempted)}")

        ttft_breach = (serving.window_requests > 0
                       and serving.ttft_p99_s > cfg.ttft_slo_p99_s)
        queue_breach = serving.queue_depth > cfg.queue_high
        calm = (serving.queue_depth <= cfg.queue_low
                and (serving.window_requests == 0
                     or serving.ttft_p99_s <= cfg.ttft_slo_p99_s))
        if ttft_breach or queue_breach:
            self._breach_ticks += 1
            self._calm_ticks = 0
        elif calm:
            self._calm_ticks += 1
            self._breach_ticks = 0
        else:
            self._breach_ticks = 0
            self._calm_ticks = 0

        breach_reason = ("ttft-slo-breach" if ttft_breach else "queue-high")
        detail = (f"ttft_p99={serving.ttft_p99_s:.3f}s "
                  f"queue={serving.queue_depth:g} "
                  f"window={serving.window_requests}")

        in_cooldown = (self._last_action_at is not None
                       and now - self._last_action_at < cfg.cooldown_s)
        # Cooldown stamps and hysteresis resets happen in
        # record_actuation(), NOT here: a decision whose apply failed
        # must not consume the cooldown (the breach would then wait a
        # whole cooldown for a grow that never landed).
        if ttft_breach or queue_breach:
            if self._breach_ticks < cfg.scale_up_after:
                return hold("hysteresis",
                            f"breach {self._breach_ticks}/"
                            f"{cfg.scale_up_after}: {detail}")
            if in_cooldown:
                return hold("cooldown", detail)
            if pools >= cfg.max_pools:
                return hold("at-max", detail)
            return ScaleDecision("grow", breach_reason, pools + 1, cluster,
                                 detail, risk)
        if calm:
            if self._calm_ticks < cfg.scale_down_after:
                return hold("hysteresis",
                            f"calm {self._calm_ticks}/"
                            f"{cfg.scale_down_after}: {detail}")
            if in_cooldown:
                return hold("cooldown", detail)
            if pools <= cfg.min_pools:
                return hold("at-min", detail)
            if pools <= self.floor():
                return hold("risk-floor",
                            f"risk={risk:.2f} floor={self.floor()}: "
                            f"{detail}")
            if not drain_candidates(pool_keys, cluster):
                # Every pool is human-authored (or the protected
                # template): deciding a drain that apply_decision can
                # never land would re-fire every calm tick forever.
                return hold("nothing-drainable", detail)
            return ScaleDecision("drain", "calm", pools - 1, cluster,
                                 detail, risk)
        return hold("hysteresis", detail)

    def record_actuation(self, ok: bool, now: float) -> None:
        """Called by the loop after a grow/drain decision was acted on.
        Success arms the cooldown and re-earns hysteresis; failure
        leaves both counters standing, so a still-breaching fleet
        re-decides the same action on the very next tick instead of
        waiting out a cooldown for capacity that never landed."""
        if ok:
            self._last_action_at = now
            self._breach_ticks = 0
            self._calm_ticks = 0


# --------------------------------------------------------------- actuation

_CLONE_NAME_RE = re.compile(r"^pool(\d+)$")


def _pool_name(key: str, cluster: str) -> str:
    """Pool name from a nodepool module key
    (``node_gcp-gpu_<cluster>_<pool>``). A key that does not follow the
    add_node scheme (an out-of-band document edit) yields itself, so it
    can never look like a ``pool<N>`` clone and is never drained —
    rather than crashing the decide path."""
    marker = f"_{cluster}_"
    i = key.find(marker)
    return key if i < 0 else key[i + len(marker):]


def drain_candidates(pool_keys: List[str],
                     cluster: str) -> List[tuple]:
    """``(N, key)`` pairs for every drainable pool: ``pool<N>``-named
    clones only, minus the protected template. Pools NOT shaped like a
    clone (a hand-provisioned ``serving``) are never candidates; when
    every pool is clone-shaped, the lowest ``N`` is the template and is
    protected too. Shared by the policy (which must not decide a drain
    nothing can land) and the actuator (which picks the victim)."""
    pools = sorted(pool_keys)
    if len(pools) <= 1:
        return []
    candidates = []
    for key in pools:
        m = _CLONE_NAME_RE.match(_pool_name(key, cluster))
        if m:
            candidates.append((int(m.group(1)), key))
    if len(candidates) == len(pools):
        candidates.remove(min(candidates))
    return candidates


def apply_decision(doc: StateDocument, decision: ScaleDecision,
                   pool_keys: List[str]) -> Optional[str]:
    """Mutate the desired document per the decision; returns the pool
    module key added (grow) or removed (drain), None on hold.

    * **grow** clones the cluster's template pool module (its
      lowest-named pool — the one a human provisioned) under the next
      free ``pool<N>`` name, so a scaled-out pool carries the identical
      accelerator/spot shape and lands with correct host labels like any
      pool.
    * **drain** removes the highest-``N`` ``pool<N>``-named pool
      (numeric order, so ``pool10`` outranks ``pool2``) and refuses to
      touch anything else: a human-authored pool named e.g. ``serving``
      is never the victim even when it sorts last lexicographically —
      and in an all-clone-shaped fleet the lowest-``N`` pool is
      protected as the template — so the autoscaler only reclaims
      capacity shaped like its own clones and grow/drain cycles are
      idempotent on the human-authored document.
    """
    pools = sorted(pool_keys)
    if decision.direction == "hold" or not pools:
        return None
    cluster = decision.cluster
    if decision.direction == "grow":
        template_key = pools[0]
        cfg = dict(doc.get(f"module.{template_key}") or {})
        names = {_pool_name(k, cluster) for k in pools}
        i = len(pools)
        while f"pool{i}" in names:
            i += 1
        new_name = f"pool{i}"
        cfg["pool_name"] = new_name
        key = f"node_gcp-gpu_{cluster}_{new_name}"
        doc.set(f"module.{key}", cfg)
        return key
    # drain: the highest-numbered drainable clone (see
    # drain_candidates for the protection rules).
    candidates = drain_candidates(pools, cluster)
    if not candidates:
        return None  # nothing clone-shaped to reclaim
    victim = max(candidates)[1]
    doc.delete(f"module.{victim}")
    return victim


def record_decision(decision: ScaleDecision) -> None:
    # The pool-count gauge is set by the loop AFTER actuation, from the
    # document that actually persisted — a persistently failing grow
    # must not report capacity the fleet never reached.
    metrics.counter("tk8s_operator_scale_decisions_total").inc(
        direction=decision.direction, reason=decision.reason)
