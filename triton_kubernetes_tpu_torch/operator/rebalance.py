"""KV-pressure rebalancing: the actuation between grow and drain (the
port's copy of the reference's ``operator/rebalance.py``, against the
port's ``tools.serve`` replicas: their ``/stats`` sessions and
``/migrate/out``).

Growing adds chips and draining removes them, but neither helps when
the fleet is the right SIZE and the wrong SHAPE: one replica's KV pool
near saturation (preempting sequences, recomputing their prefills)
while a peer idles half-empty. The rebalancer closes that gap without
touching the document — it migrates ONE session per tick from the
most- to the least-pressured replica over the live-migration plane
(serve/migration.py), so the pressured pool sheds pages it already
paid prefill for instead of evicting and recomputing them.

Split the same way as the autoscaler: a pure, deterministic *plan*
(:func:`plan_rebalance`, TK8S110-clean) over the per-replica KV
utilization the metrics watcher already windows, and an injectable
*actuation* seam (:func:`http_rebalancer` in production, a lambda in
tests). One session per tick is deliberate hysteresis: pressure data
is a window old, and a migration changes both ends of the gap — the
next tick re-observes before moving anything else.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

#: Actuation outcomes (journal/metrics vocabulary).
REBALANCE_STATUSES = ("ok", "failed", "noop")


@dataclass
class RebalanceDecision:
    """Move one session from metrics-source ``source`` to ``target``
    (indices into the watcher's source list — the same keying
    ``ServingSample.kv_utilization`` uses)."""

    source: int
    target: int
    gap: float  # utilization spread that triggered the move

    def to_dict(self) -> Dict[str, Any]:
        return {"source": self.source, "target": self.target,
                "gap": round(self.gap, 6)}


def plan_rebalance(kv_utilization: Dict[int, float], *,
                   gap_threshold: float,
                   high_watermark: float = 0.75,
                   ) -> Optional[RebalanceDecision]:
    """Decide whether the pressure spread justifies a migration.

    Fires only when BOTH hold: the hottest replica is above
    ``high_watermark`` (a fleet that is uniformly cold has nothing
    worth moving even if the spread is wide), and the spread between
    hottest and coldest exceeds ``gap_threshold`` (moving a session
    across a narrow gap just flips which replica is hottest).
    Deterministic: ties break toward the lower source index.
    """
    if gap_threshold <= 0 or len(kv_utilization) < 2:
        return None
    items = kv_utilization.items()
    hi, hi_util = min(items, key=lambda kv: (-kv[1], kv[0]))
    lo, lo_util = min(items, key=lambda kv: (kv[1], kv[0]))
    gap = hi_util - lo_util
    if hi_util < high_watermark or gap <= gap_threshold:
        return None
    return RebalanceDecision(source=hi, target=lo, gap=gap)


def _base_url(source: str) -> str:
    """A watcher source is the replica's ``/metrics`` URL; the
    migration endpoints live on the same listener."""
    url = source.rstrip("/")
    if url.endswith("/metrics"):
        url = url[: -len("/metrics")]
    return url


def http_rebalancer(sources: Sequence[Any], timeout_s: float = 10.0,
                    ) -> Callable[[RebalanceDecision], Dict[str, Any]]:
    """The production actuation: resolve the decision's source/target
    indices against the watcher's scrape-URL list and ship the
    source replica's first exportable session via its /migrate/out.

    Returns a callable for :class:`~.loop.Reconciler`'s ``rebalancer``
    seam producing ``{"status": "ok" | "failed" | "noop", ...}`` —
    "noop" when the pressured replica had no decode-ready session to
    move (mid-prefill sequences re-land via recompute, not migration).
    """
    urls = [s for s in sources if isinstance(s, str)]

    def act(decision: RebalanceDecision) -> Dict[str, Any]:
        try:
            src = _base_url(urls[decision.source])
            dst = _base_url(urls[decision.target])
        except IndexError:
            return {"status": "failed",
                    "error": f"no scrape URL for source index "
                             f"{decision.source}/{decision.target}"}
        try:
            with urllib.request.urlopen(
                    urllib.request.Request(src + "/stats"),
                    timeout=timeout_s) as r:
                sessions = (json.loads(r.read() or b"{}")
                            .get("sessions", []))
        except (urllib.error.URLError, OSError, ValueError) as e:
            return {"status": "failed", "error": f"source /stats: {e}"}
        if not sessions:
            return {"status": "noop",
                    "error": "no exportable session on source"}
        rid = sessions[0]
        body = json.dumps({"request_id": rid, "dest": dst,
                           "reason": "rebalance"}).encode()
        req = urllib.request.Request(
            src + "/migrate/out", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                out = json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            return {"status": "failed", "request_id": rid,
                    "error": f"migrate/out: HTTP {e.code}"}
        except (urllib.error.URLError, OSError, ValueError) as e:
            return {"status": "failed", "request_id": rid,
                    "error": f"migrate/out: {e}"}
        return {"status": "ok", "request_id": rid,
                "bytes": out.get("bytes"),
                "dest_request_id": out.get("dest_request_id")}

    return act
