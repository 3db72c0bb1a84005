"""The observe leg of the reconcile loop: desired, actual, and live (the
port's copy of the reference's ``operator/observe.py``, over GPU pools).

Three sources, one typed snapshot per tick:

* **desired** — the StateDocument (the operator re-reads it from the
  backend every tick, so out-of-band edits are just drift to converge);
* **actual** — the executor's applied state plus the driver's cloud
  view (preempted GPU pools, preemption history);
* **live** — the serving fleet's ``GET /metrics`` Prometheus text,
  through :func:`~..utils.metrics.parse_prometheus`. Scrapes are
  *windowed* by :class:`MetricsWatcher`: serving histograms are
  cumulative since process start, so the autoscaler's TTFT p99 must be
  quantiled over the per-tick bucket **delta**, not the lifetime
  distribution — a morning of calm traffic must not mask an afternoon
  SLO breach.

Everything here is read-only and standard-library only; acting on the
snapshot is :mod:`.reconcile`'s job. The scaling unit is a GPU pool (a
``gcp-gpu-nodepool`` module), where the reference's is a TPU slice.
"""

from __future__ import annotations

import urllib.request
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from ..executor.engine import load_executor_state
from ..executor.plan import Plan, PlanAction
from ..state import StateDocument
from ..utils import metrics
from ..utils.trace import GOODPUT_FAMILY, GOODPUT_USEFUL, GOODPUT_WASTE

#: A metrics source: a replica/fleet ``/metrics`` URL, or any callable
#: returning Prometheus text (the test/evidence seam — an in-process
#: registry's ``render_prometheus`` is a source).
MetricsSource = Union[str, Callable[[], str]]

TTFT_FAMILY = "tk8s_serve_ttft_seconds"
QUEUE_FAMILY = "tk8s_serve_queue_depth"
REQUESTS_FAMILY = "tk8s_serve_requests_total"
KV_BYTES_FAMILY = "tk8s_serve_kv_bytes"
KV_UTIL_FAMILY = "tk8s_serve_kv_block_utilization"


def scrape_source(source: MetricsSource, timeout_s: float = 5.0) -> str:
    """One source's Prometheus text. URL sources are fetched over HTTP;
    callable sources are invoked. Raises on unreachable/malformed —
    the caller decides whether a blind scrape is tolerable."""
    if callable(source):
        return source()
    with urllib.request.urlopen(source, timeout=timeout_s) as resp:
        return resp.read().decode("utf-8")


@dataclass
class ServingSample:
    """One tick's windowed view of the serving fleet.

    ``ttft_p99_s`` is quantiled over the TTFT histogram *delta* since
    the previous sample (0.0 when no request finished in the window);
    ``queue_depth`` is the current gauge summed across sources.
    ``sources_ok``/``sources_total`` make a blind tick visible: a
    fleet that stopped answering /metrics must read as "no signal",
    never as "all quiet".
    """

    sources_total: int = 0
    sources_ok: int = 0
    queue_depth: float = 0.0
    ttft_p99_s: float = 0.0
    window_requests: int = 0
    # Per-tick chip-second deltas of tk8s_goodput_seconds_total, summed
    # across sources: source kind -> category -> seconds this window
    # (windowed per source exactly like the TTFT buckets — first sample
    # is baseline, a counter regression re-baselines).
    goodput_window: Dict[str, Dict[str, float]] = field(
        default_factory=dict)
    # Current per-replica KV snapshot (source index -> value): pool
    # bytes (pages + scales components summed) and block-pool occupancy
    # in [0, 1] — gauges, so no windowing.
    kv_bytes: Dict[int, float] = field(default_factory=dict)
    kv_utilization: Dict[int, float] = field(default_factory=dict)

    @property
    def blind(self) -> bool:
        return self.sources_total > 0 and self.sources_ok == 0

    @property
    def has_signal(self) -> bool:
        return self.sources_ok > 0

    @property
    def goodput_accounted_s(self) -> float:
        return sum(v for cats in self.goodput_window.values()
                   for v in cats.values())

    @property
    def goodput_useful_fraction(self) -> Optional[float]:
        """Fleet useful-chip-time fraction over this window, None when
        no goodput counters moved (a blind or idle window must read as
        "no signal", never as 0% useful)."""
        total = self.goodput_accounted_s
        if total <= 0.0:
            return None
        useful = sum(cats.get(c, 0.0)
                     for src, cats in self.goodput_window.items()
                     for c in GOODPUT_USEFUL.get(src, ()))
        return useful / total

    @property
    def goodput_waste_fraction(self) -> Optional[float]:
        total = self.goodput_accounted_s
        if total <= 0.0:
            return None
        waste = sum(cats.get(c, 0.0)
                    for src, cats in self.goodput_window.items()
                    for c in GOODPUT_WASTE.get(src, ()))
        return waste / total


class MetricsWatcher:
    """Scrapes a set of metrics sources and windows the cumulative
    families between ticks (the Prometheus ``rate()`` analog, done
    client-side because the operator IS the monitoring system here).

    Windows are kept **per source**: a replica that skipped a tick (a
    scrape timeout during scale churn) simply contributes a two-tick
    delta next time, and a replica whose counters went *backwards* (a
    restart reset its registry) is re-baselined instead of having its
    whole lifetime histogram re-counted as fresh traffic — either of
    which, under a fleet-merged baseline, would poison the windowed
    p99 with stale or negative counts.
    """

    def __init__(self, sources: List[MetricsSource],
                 timeout_s: float = 5.0):
        self.sources = list(sources)
        self.timeout_s = timeout_s
        # source index -> that source's previous cumulative TTFT
        # buckets (incl. the "+Inf" count).
        self._prev_ttft: Dict[int, Dict[str, float]] = {}
        # source index -> previous cumulative goodput chip-seconds,
        # keyed (source kind, category) — windowed with the same
        # baseline / re-baseline discipline as the TTFT buckets.
        self._prev_goodput: Dict[int, Dict[Tuple[str, str], float]] = {}

    @staticmethod
    def _sum_values(fam: Optional[Dict[str, Any]]) -> float:
        if not fam:
            return 0.0
        return sum(float(s.get("value", 0.0)) for s in fam["series"])

    def _ttft_delta(self, idx: int,
                    cum: Dict[str, Any]) -> Dict[str, float]:
        """One source's per-tick bucket delta. The first-ever sample
        only establishes the baseline (empty delta): the cumulative
        histogram is the replica's lifetime, not this tick's traffic,
        and quantiling it would let a restarted operator judge a whole
        morning's incident as one fresh window (and grow on it). A
        counter regression (replica restart) re-baselines the same
        way rather than re-counting the lifetime or going negative."""
        buckets = dict(cum["buckets"])
        buckets["+Inf"] = float(cum["count"])
        prev = self._prev_ttft.get(idx)
        self._prev_ttft[idx] = buckets
        if prev is None:
            return {}
        delta = {le: c - prev.get(le, 0.0) for le, c in buckets.items()}
        if any(d < 0 for d in delta.values()):
            return {}
        return delta

    def _goodput_delta(self, idx: int, fam: Optional[Dict[str, Any]],
                       ) -> Dict[Tuple[str, str], float]:
        """One source's per-tick goodput chip-second delta by (source
        kind, category). First sample establishes the baseline; a
        regressed counter (process restart) re-baselines — lifetime
        chip-seconds must never be re-counted as one fresh window."""
        if not fam:
            return {}
        cum: Dict[Tuple[str, str], float] = {}
        for s in fam["series"]:
            labels = s.get("labels", {})
            key = (labels.get("source", "?"), labels.get("category", "?"))
            cum[key] = cum.get(key, 0.0) + float(s.get("value", 0.0))
        prev = self._prev_goodput.get(idx)
        self._prev_goodput[idx] = cum
        if prev is None:
            return {}
        delta = {k: v - prev.get(k, 0.0) for k, v in cum.items()}
        if any(d < 0 for d in delta.values()):
            return {}
        return delta

    def sample(self) -> ServingSample:
        """Scrape every source and window each against its own previous
        sample. Unreachable or unparsable sources are skipped (counted
        in ``sources_total - sources_ok``) — one dead replica must not
        blind the operator to the rest of the fleet."""
        sample = ServingSample(sources_total=len(self.sources))
        window: Dict[str, float] = {}
        for idx, source in enumerate(self.sources):
            try:
                parsed = metrics.parse_prometheus(
                    scrape_source(source, self.timeout_s))
            except Exception:
                # tk8s-lint: disable=TK8S106(scrape failures are expected
                # during scale churn; the blind-vs-quiet distinction is
                # carried by sources_ok, not an exception)
                continue
            sample.sources_ok += 1
            sample.queue_depth += self._sum_values(
                parsed.get(QUEUE_FAMILY))
            ttft = parsed.get(TTFT_FAMILY)
            if ttft and ttft["series"]:
                cum = metrics.merge_histogram_series(ttft["series"])
                for le, d in self._ttft_delta(idx, cum).items():
                    window[le] = window.get(le, 0.0) + d
            for (src, cat), d in self._goodput_delta(
                    idx, parsed.get(GOODPUT_FAMILY)).items():
                cats = sample.goodput_window.setdefault(src, {})
                cats[cat] = cats.get(cat, 0.0) + d
            kv = parsed.get(KV_BYTES_FAMILY)
            if kv and kv["series"]:
                sample.kv_bytes[idx] = self._sum_values(kv)
            util = parsed.get(KV_UTIL_FAMILY)
            if util and util["series"]:
                sample.kv_utilization[idx] = max(
                    float(s.get("value", 0.0)) for s in util["series"])
        sample.window_requests = max(0, int(window.get("+Inf", 0.0)))
        if sample.window_requests > 0:
            sample.ttft_p99_s = metrics.histogram_quantile(window, 0.99)
        return sample


@dataclass
class ObservedState:
    """One tick's full observation: the inputs every reconcile rule and
    the autoscaler read. ``plan`` is the executor's desired-vs-applied
    diff; ``preempted`` maps pool (slice) id -> pool info for pools the
    cloud reports dead; ``preempt_history`` is the driver's lifetime
    per-pool preemption count (survives repair — the risk-weighting
    signal)."""

    doc: StateDocument
    plan: Plan
    applied_modules: List[str]
    preempted: Dict[str, Dict[str, Any]]
    preempt_history: Dict[str, int]
    gpu_pools: Dict[str, List[str]]  # cluster name -> pool module keys
    serving: ServingSample
    last_apply_status: str = ""

    @property
    def to_apply(self) -> List[str]:
        return sorted(
            n for n, a in self.plan.actions.items()
            if a in (PlanAction.CREATE, PlanAction.UPDATE))

    @property
    def to_prune(self) -> List[str]:
        return sorted(n for n, a in self.plan.actions.items()
                      if a is PlanAction.DELETE)


def gpu_pool_modules(doc: StateDocument) -> Dict[str, List[str]]:
    """cluster name -> sorted GPU pool module keys, from the desired
    document (the autoscaler's scaling units). A pool module is any
    ``module.*`` whose source is the GPU nodepool module."""
    out: Dict[str, List[str]] = {}
    for key in doc.module_keys():
        cfg = doc.get(f"module.{key}") or {}
        if cfg.get("source", "").endswith("gcp-gpu-nodepool"):
            cluster = str(cfg.get("gke_cluster_name", ""))
            out.setdefault(cluster, []).append(key)
    for pools in out.values():
        pools.sort()
    return out


def observe(doc: StateDocument, executor,
            watcher: Optional[MetricsWatcher] = None) -> ObservedState:
    """Build one tick's :class:`ObservedState` (read-only everywhere:
    the plan loads applied state, the cloud view is a copy)."""
    plan = executor.plan(doc)
    est = load_executor_state(doc)
    view = executor.cloud_view(doc)
    serving = watcher.sample() if watcher is not None else ServingSample()
    return ObservedState(
        doc=doc,
        plan=plan,
        applied_modules=sorted(est.modules),
        preempted=view.preempted_slices(),
        preempt_history=dict(est.cloud.get("preempt_history", {})),
        gpu_pools=gpu_pool_modules(doc),
        serving=serving,
        last_apply_status=str(est.journal.get("status", "")),
    )
