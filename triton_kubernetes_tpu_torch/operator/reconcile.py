"""The diff->act legs: a typed delta and the reconcile rules (the port's
copy of the reference's ``operator/reconcile.py``, over GPU pools).

The one-shot workflows (`apply`, `repair slice`, `destroy`) each solved
one slice of convergence by hand; here they become **rules** a
long-running loop applies to exactly the drift it observed:

* ``replace-preempted-slice`` — every preempted GPU pool that is still
  desired is replaced through the programmatic pool repair
  (``workflows/repair.repair_slice_auto``: detect -> cordon -> replace ->
  verify host labels). The rule keeps the reference's name: a GPU pool
  is the port's slice, the unit that dies and is replaced whole.
* ``converge-drift`` — desired modules missing from (or changed in)
  applied state are wavefront-applied. The plain `apply`, scoped to the
  delta by the engine's own plan diff.
* ``drain-orphans`` — applied modules gone from the desired document
  are pruned dependents-first (the engine's prune path inside apply).
  What `destroy --target` did by hand.

Rules run in that order on purpose: a preempted pool is repaired
before converge-drift re-applies around it (repair rewrites the pool
module itself), and orphans drain last so a scale-down never tears a
pool out from under an in-flight repair.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from ..utils import metrics
from ..workflows import repair_slice_auto
from .observe import ObservedState

#: Rule identifiers, in execution order (journal/metrics vocabulary).
RULES = ("replace-preempted-slice", "converge-drift", "drain-orphans")


@dataclass
class ReconcileDelta:
    """The typed desired-vs-actual difference one tick must close.
    ``to_repair`` entries carry the cluster split the repair workflow
    needs (``{"slice_id", "cluster", "pool"}``)."""

    to_repair: List[Dict[str, str]] = field(default_factory=list)
    to_apply: List[str] = field(default_factory=list)   # module keys
    to_prune: List[str] = field(default_factory=list)   # module keys

    @property
    def empty(self) -> bool:
        return not (self.to_repair or self.to_apply or self.to_prune)

    def to_dict(self) -> Dict[str, Any]:
        return {"to_repair": [dict(r) for r in self.to_repair],
                "to_apply": list(self.to_apply),
                "to_prune": list(self.to_prune)}


def compute_delta(observed: ObservedState) -> ReconcileDelta:
    """Diff the observation into the delta the rules will act on.

    A preempted pool is repairable only while its pool module is still
    desired — a pool the autoscaler already drained is not
    drift to repair but an orphan to drain (repairing it would resurrect
    capacity the policy just decided to shed).
    """
    desired_pools = set()
    for cluster, keys in observed.gpu_pools.items():
        for key in keys:
            cfg = observed.doc.get(f"module.{key}") or {}
            desired_pools.add((cluster, str(cfg.get("pool_name", ""))))
    to_repair = []
    for sid, info in sorted(observed.preempted.items()):
        # Exact (cluster, pool) identity from the module CONFIG — the
        # names the cloud reports and the repair workflow resolves.
        # Suffix matching would let a cousin pool keep a drained pool's
        # dead slice in the repair set; reconstructing the module key
        # would silently strand a pool stored under an out-of-band key
        # (its dead slice would hold the autoscaler in repair-first
        # forever — attempting the repair fails loudly in the journal
        # instead).
        if (str(info["cluster"]), str(info["pool"])) in desired_pools:
            to_repair.append({"slice_id": sid,
                              "cluster": str(info["cluster"]),
                              "pool": str(info["pool"])})
    delta = ReconcileDelta(
        to_repair=to_repair,
        to_apply=observed.to_apply,
        to_prune=observed.to_prune,
    )
    for kind, items in (("preempted", delta.to_repair),
                        ("apply", delta.to_apply),
                        ("prune", delta.to_prune)):
        if items:
            metrics.counter("tk8s_operator_drift_total").inc(
                len(items), kind=kind)
    return delta


@dataclass
class RuleOutcome:
    rule: str
    targets: List[str]
    ok: bool
    error: str = ""

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"rule": self.rule,
                               "targets": list(self.targets),
                               "ok": self.ok}
        if self.error:
            out["error"] = self.error
        return out


def act(backend, executor, manager: str, doc,
        delta: ReconcileDelta) -> List[RuleOutcome]:
    """Apply exactly the delta, rule by rule, in :data:`RULES` order.

    The first failing rule stops the tick (its outcome carries the
    error); the next tick re-observes and re-acts — convergence through
    repetition, never through in-tick retries stacked on the engine's
    own retry policy. State-document persistence follows the workflow
    discipline: commit after the engine succeeded.
    """
    outcomes: List[RuleOutcome] = []

    if delta.to_repair:
        repaired: List[str] = []
        sid = ""
        try:
            for item in delta.to_repair:
                sid = item["slice_id"]
                repair_slice_auto(backend, executor, manager,
                                  item["cluster"], slice_id=sid)
                repaired.append(sid)
        except Exception as e:
            outcomes.append(RuleOutcome("replace-preempted-slice",
                                        repaired + [sid], False, str(e)))
            return outcomes
        outcomes.append(RuleOutcome("replace-preempted-slice",
                                    repaired, True))
        # Repair re-applied through its own workflow; fall through so
        # converge-drift still closes any remaining gap this tick.

    # Converge and drain are SEPARATE targeted applies so the journal
    # attributes a failure to the rule that actually raised (one
    # combined apply would blame converge-drift for a prune error) —
    # and creates land before orphans are torn down, so a scale-down
    # never races an in-flight replacement.
    if delta.to_apply:
        try:
            executor.apply(doc, targets=delta.to_apply)
            backend.persist(doc)
        except Exception as e:
            outcomes.append(RuleOutcome("converge-drift", delta.to_apply,
                                        False, str(e)))
            return outcomes
        outcomes.append(RuleOutcome("converge-drift", delta.to_apply,
                                    True))
    if delta.to_prune:
        try:
            executor.apply(doc, targets=delta.to_prune)
            backend.persist(doc)
        except Exception as e:
            outcomes.append(RuleOutcome("drain-orphans", delta.to_prune,
                                        False, str(e)))
            return outcomes
        outcomes.append(RuleOutcome("drain-orphans", delta.to_prune,
                                    True))
    return outcomes
