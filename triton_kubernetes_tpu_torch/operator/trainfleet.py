"""Train-fleet reconcile rules: the operator drives training too (the
port's copy of the reference's ``operator/trainfleet.py``).

With ``--resume --elastic`` the port's trainer restarts on whatever fleet
survived (``train/__main__.py`` negotiates the mesh from the checkpoint
manifest's recorded shape), so the operator need not wait for an
identical replacement pool. This module is the policy side
of that bargain — one control loop arbitrating chips between the
serving classes and training:

* **replace** — the train job is down, the checkpoint is durable, and
  the cluster can give back the full desired worker count: relaunch at
  the desired size. Recovery is repair-first (no cooldown), exactly
  like the autoscaler's preempted-pool rule.
* **shrink-instead-of-wait** — the job is down but only part of the
  capacity came back: restart NOW on the surviving workers (elastic
  restore onto the smaller mesh) instead of idling chips until a full
  replacement appears. Progress degrades; it does not stop.
* **regrow** — the job is running degraded, the capacity returned, the
  regrow cooldown passed, and the serving fleet is calm (queue below
  the high watermark, TTFT inside the SLO when there is a signal):
  restart at the desired size. Regrow is the only direction the
  serving signal can veto — taking chips back from serving under
  pressure is how one loop loses both workloads.

Decisions journal through the same :class:`~.loop.ReconcileTick`
discipline as serving scale decisions (``tk8s_operator_train_resizes_
total`` by direction/reason, an ``operator.train_resize`` trace span
per actuation), and actuation goes through an injected seam —
``tools.operate`` wires a JobSet re-render (:func:`jobset_actuator`,
``topology/jobset.resize_jobset``), tests wire a lambda or a relaunch of
local ranks. Standard library only, like the whole operator package; time
arrives only through ``now`` parameters (lint rule TK8S110).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ..utils import metrics

#: Decision directions (journal/metrics vocabulary). ``hold`` is a
#: decision too — the reason says why nothing moved.
TRAIN_DIRECTIONS = ("replace", "shrink", "regrow", "hold")


@dataclass(frozen=True)
class TrainFleetConfig:
    """Policy knobs. ``desired_workers`` is the world size training
    wants; ``min_workers`` is the smallest fleet worth restarting on
    (below it, shrink-instead-of-wait would spend the restart cost on a
    mesh the negotiation may not even fit)."""

    desired_workers: int = 2
    min_workers: int = 1
    #: Seconds between a landed resize and the next regrow (replace and
    #: shrink are recovery: never throttled).
    regrow_cooldown_s: float = 60.0
    #: Serving queue depth at/above which regrow is vetoed — the chips
    #: stay with serving until the queue drains.
    serve_queue_high: float = 8.0
    #: TTFT p99 SLO bound for the regrow veto (0 disables the check).
    ttft_slo_p99_s: float = 0.0


@dataclass
class TrainFleetStatus:
    """What the operator observed about the train fleet this tick.

    ``running_workers`` is the live job's world size (0 = the job is
    down — preempted, crashed, or never started); ``capacity_workers``
    is how many train-worker slots the cluster could grant right now
    (surviving pools plus anything reclaimable from the shared pool);
    ``step``/``target_step`` carry progress for the journal.
    """

    running_workers: int = 0
    capacity_workers: int = 0
    step: Optional[int] = None
    target_step: Optional[int] = None
    done: bool = False

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "TrainFleetStatus":
        return cls(
            running_workers=int(doc.get("running_workers") or 0),
            capacity_workers=int(doc.get("capacity_workers") or 0),
            step=(int(doc["step"]) if doc.get("step") is not None
                  else None),
            target_step=(int(doc["target_step"])
                         if doc.get("target_step") is not None else None),
            done=bool(doc.get("done", False)))

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "running_workers": self.running_workers,
            "capacity_workers": self.capacity_workers,
        }
        if self.step is not None:
            out["step"] = self.step
        if self.target_step is not None:
            out["target_step"] = self.target_step
        if self.done:
            out["done"] = True
        return out


@dataclass
class TrainDecision:
    """One train-fleet policy decision — journaled verbatim."""

    direction: str                 # one of TRAIN_DIRECTIONS
    workers: int                   # the world size to actuate (0 = none)
    reason: str
    detail: str = ""

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"direction": self.direction,
                               "workers": self.workers,
                               "reason": self.reason}
        if self.detail:
            out["detail"] = self.detail
        return out


def record_train_decision(decision: TrainDecision) -> None:
    """Every decision (hold included) ticks the counter — the journal's
    aggregate view, same discipline as autoscaler decisions."""
    metrics.counter("tk8s_operator_train_resizes_total").inc(
        direction=decision.direction, reason=decision.reason)


class TrainFleetPolicy:
    """Replace / shrink-instead-of-wait / regrow, with the serving
    signal vetoing only regrow. Stateful exactly like the autoscaler:
    the regrow cooldown arms on a LANDED actuation
    (:meth:`record_actuation`), never on a decision."""

    def __init__(self, config: Optional[TrainFleetConfig] = None):
        self.config = config or TrainFleetConfig()
        self._last_actuation: Optional[float] = None

    # ------------------------------------------------------------ policy
    def decide(self, status: Optional[TrainFleetStatus],
               serving: Any, now: float) -> TrainDecision:
        cfg = self.config
        if status is None:
            return TrainDecision("hold", 0, "no-signal",
                                 "no train-fleet status this tick")
        if status.done:
            return TrainDecision("hold", 0, "done",
                                 "train job reached its target step")
        running = status.running_workers
        capacity = status.capacity_workers
        desired = cfg.desired_workers
        if running >= desired:
            return TrainDecision("hold", 0, "converged",
                                 f"{running}/{desired} workers running")
        if running == 0:
            # The job is down; the checkpoint (scheduled or emergency)
            # is the durable artifact. Recovery is repair-first: no
            # cooldown, no serving veto — a dead train job consumes no
            # chips, so restarting it takes nothing from serving that
            # the capacity signal has not already granted.
            if capacity >= desired:
                return TrainDecision(
                    "replace", desired, "replace-lost",
                    f"capacity for all {desired} workers is back")
            if capacity >= cfg.min_workers:
                return TrainDecision(
                    "shrink", capacity, "shrink-instead-of-wait",
                    f"only {capacity}/{desired} worker slots available; "
                    f"elastic restart on the survivors beats idling "
                    f"them")
            return TrainDecision(
                "hold", 0, "no-capacity",
                f"{capacity} worker slots available, min is "
                f"{cfg.min_workers}")
        # Running degraded: regrow wants desired - running MORE slots on
        # top of the running job's (a restart re-occupies its own).
        if capacity < desired:
            return TrainDecision(
                "hold", 0, "await-capacity",
                f"{capacity}/{desired} worker slots available")
        calm, why = self._serving_calm(serving)
        if not calm:
            return TrainDecision("hold", 0, "serving-pressure", why)
        if (self._last_actuation is not None
                and now - self._last_actuation < cfg.regrow_cooldown_s):
            remain = cfg.regrow_cooldown_s - (now - self._last_actuation)
            return TrainDecision("hold", 0, "cooldown",
                                 f"{remain:.1f}s of regrow cooldown left")
        return TrainDecision(
            "regrow", desired, "regrow",
            f"capacity back and serving calm; {running} -> {desired} "
            f"workers")

    def _serving_calm(self, serving: Any) -> tuple:
        cfg = self.config
        if serving is None or not getattr(serving, "has_signal", False):
            # No serving signal = nothing to arbitrate against; regrow
            # freely (a train-only cluster must not wedge on a scrape
            # gap).
            return True, ""
        queue = float(getattr(serving, "queue_depth", 0.0))
        if queue >= cfg.serve_queue_high:
            return False, (f"serving queue {queue:.0f} >= "
                           f"{cfg.serve_queue_high:.0f}")
        if cfg.ttft_slo_p99_s > 0 and \
                getattr(serving, "window_requests", 0) > 0:
            ttft = float(getattr(serving, "ttft_p99_s", 0.0))
            if ttft > cfg.ttft_slo_p99_s:
                return False, (f"serving TTFT p99 {ttft:.3f}s > SLO "
                               f"{cfg.ttft_slo_p99_s:.3f}s")
        return True, ""

    # ---------------------------------------------------------- actuation
    def record_actuation(self, ok: bool, now: float) -> None:
        """Arm the regrow cooldown only when the resize landed — a
        failed actuation leaves the policy free to retry next tick."""
        if ok:
            self._last_actuation = now


def file_train_status(path: str) -> Callable[[], Optional[TrainFleetStatus]]:
    """Status seam reading a JSON document from ``path`` — the shape the
    evidence harness and ``tools.operate --train-status`` read:
    ``{"running_workers": N, "capacity_workers": M, "step": S, ...}``.
    Missing or torn files are "no signal this tick", never a raised
    tick."""
    import json

    def read() -> Optional[TrainFleetStatus]:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(doc, dict):
            return None
        return TrainFleetStatus.from_dict(doc)

    return read


#: The rank command a resized JobSet runs (behind the host launcher,
#: ``topology/jobset.HOST_LAUNCH``): resume from the newest checkpoint on
#: the fleet's new shape.
ELASTIC_TRAIN_COMMAND = ["python", "-m", "triton_kubernetes_tpu_torch.train",
                         "--resume", "--elastic"]


def jobset_actuator(out_dir: str, name: str, spec: Any, image: str,
                    command: Any = None, namespace: str = "default"):
    """Actuation seam rendering the resized Job of a GPU pool's train
    fleet into ``out_dir`` (``topology/jobset.resize_jobset``, ``spec`` a
    ``GpuPoolSpec``) — what ``tools.operate --train-jobset-dir`` writes
    for a ``kubectl apply``. ``command`` defaults to
    :data:`ELASTIC_TRAIN_COMMAND`. Returns the actuator callable."""
    import json
    import os

    from ..topology.jobset import resize_jobset

    command = list(command or ELASTIC_TRAIN_COMMAND)

    def actuate(decision: TrainDecision) -> Dict[str, Any]:
        try:
            doc = resize_jobset(name, spec, decision.workers,
                                image=image, command=command,
                                namespace=namespace)
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"{name}-jobset.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
            return {"status": "ok", "path": path,
                    "workers": decision.workers}
        except Exception as e:
            return {"status": "failed", "error": str(e)}

    return actuate
