"""Process-wide metrics: counters, gauges, histograms, Prometheus text --
the port's copy of ``triton_kubernetes_tpu/utils/metrics.py``, holding the
registry, its exposition, the ``tk8s_serve_*`` families the serving
engine and its HTTP front end update (its KV-session migration's among
them), the router's ``tk8s_route_*``, the
``tk8s_train_*`` families of the training loop, its checkpoints and its
anomaly guard, the goodput ledger's ``tk8s_goodput_seconds_total``, and
the executor's, the simulated cloud's, the pool repair's and the
operator's (``tk8s_apply_*``, ``tk8s_cloudsim_*``, ``tk8s_repairs_total``,
``tk8s_operator_*``), so they behave exactly as the JAX package's
do, and the Prometheus text parser (``parse_prometheus``,
``histogram_quantile``, ``merge_histogram_series``) that reads a saved
scrape back.

Families are create-or-get by name (``metrics.counter(name).inc(...)``);
help text, label names and buckets come from :data:`CATALOG`. The registry
is thread-safe, and one process-default instance is reachable from anywhere
(:func:`get_registry`; :func:`configure` swaps it, as tests do).
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Seconds-scale latency buckets: module applies range from sub-ms
# (simulator) to minutes (real drivers); HTTP calls live in the middle.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

# name -> (kind, help, labelnames, buckets-or-None). The one catalog the
# instrumentation, the docs table (docs/guide/observability.md), and the
# `tk8s metrics` pre-registration all read.
CATALOG: Dict[str, Tuple[str, str, Tuple[str, ...], Optional[Tuple[float, ...]]]] = {
    # ------------------------------------------- serve/engine.py + server
    "tk8s_serve_requests_total": (
        "counter", "Serving requests completed, by outcome "
        "(eos/length/error)", ("outcome",), None),
    "tk8s_serve_tokens_total": (
        "counter", "Tokens processed by the serving engine, by phase "
        "(prefill tokens ingested vs decode tokens generated)",
        ("kind",), None),
    "tk8s_serve_ttft_seconds": (
        "histogram", "Time to first token: request submission to the "
        "first sampled token (prefill completion)", (), DEFAULT_BUCKETS),
    "tk8s_serve_tpot_seconds": (
        "histogram", "Time per output token after the first, averaged "
        "per request at completion", (), DEFAULT_BUCKETS),
    "tk8s_serve_queue_depth": (
        "gauge", "Requests waiting for a decode slot / KV pages", (), None),
    "tk8s_serve_sequences": (
        "gauge", "Sequences by scheduler state (running = in a decode "
        "slot, waiting = queued or preempted)", ("state",), None),
    "tk8s_serve_kv_blocks_in_use": (
        "gauge", "KV-cache pages currently allocated to sequences", (),
        None),
    "tk8s_serve_kv_block_utilization": (
        "gauge", "Allocated fraction of the allocatable KV page pool "
        "(0..1); sustained ~1.0 means admission is page-bound", (), None),
    "tk8s_serve_preemptions_total": (
        "counter", "Running sequences evicted to free KV pages "
        "(recompute-on-readmit)", (), None),
    "tk8s_serve_kv_bytes": (
        "gauge", "Device bytes of the paged KV pool by component "
        "(pages = the K/V page arrays at the configured --kv-dtype; "
        "scales = the per-page-per-head f32 quantization scales, 0 "
        "unless --kv-dtype int8)", ("component",), None),
    "tk8s_serve_quant_error": (
        "gauge", "Mean relative dequantization error of the most "
        "recent quantized prefill's scattered KV pages, by tensor "
        "(k/v); stays 0 when the pool is unquantized", ("tensor",), None),
    "tk8s_serve_http_requests_total": (
        "counter", "Serving HTTP requests by route, method, and "
        "response code", ("route", "method", "code"), None),
    "tk8s_serve_prefix_hit_tokens_total": (
        "counter", "Prompt tokens served from the shared radix prefix "
        "cache instead of prefill compute — the O(users) -> O(1) "
        "system-prompt win, measured", (), None),
    "tk8s_serve_prefix_cache_pages": (
        "gauge", "KV pages currently indexed by the radix prefix cache "
        "(each holds one cache-owned reference; evicted LRU-leaf-first "
        "under pool pressure)", (), None),
    "tk8s_serve_spec_proposed_tokens_total": (
        "counter", "Draft tokens proposed by the n-gram self-drafter "
        "and scored by the widened verify step (spec_k > 0)", (), None),
    "tk8s_serve_spec_accepted_tokens_total": (
        "counter", "Proposed draft tokens the model's own keyed samples "
        "agreed with (accepted/proposed = the effective accept rate; "
        "rejected tokens' KV writes are rolled back)", (), None),
    "tk8s_serve_spec_accept_rate": (
        "histogram", "Per-verify-step draft acceptance rate "
        "(accepted/proposed over the step's batch); high on "
        "self-similar text, ~0 where speculation is wasted",
        (), (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)),
    "tk8s_serve_spec_tokens_per_step": (
        "gauge", "Tokens emitted per decoding sequence by the most "
        "recent verify step (1.0 = plain-decode pace, up to spec_k + 1 "
        "when every draft accepts)", (), None),
    # ------------------------------- serve/engine.py (KV-session migration)
    "tk8s_serve_migrations_total": (
        "counter", "KV-page session migrations by direction (out = "
        "packed and shipped, in = unpacked into the local pool), reason "
        "(handoff = prefill->decode disaggregation, drain / rebalance = "
        "operator actuation), and status (ok, torn = digest rejected a "
        "damaged payload, error = ship/import failed); exemplar-linked "
        "to the migrated session's trace id", ("direction", "reason",
        "status"), None),
    "tk8s_serve_migration_bytes_total": (
        "counter", "Serialized bytes shipped (direction=out) or "
        "accepted (direction=in) by KV-page session migration — raw "
        "quantized pages ship as-is, so int8/fp8 pools move ~4x/~2x "
        "fewer bytes than bf16/f32; exemplar-linked to the migrated "
        "session's trace id", ("direction",), None),
    "tk8s_serve_migration_transfer_seconds": (
        "histogram", "Wall seconds a migration payload spent on the "
        "wire (the outbound /migrate/in POST, including any simulated "
        "DCN bytes/sec + RTT cost when a transfer model is configured "
        "— loopback tests otherwise pretend the ship is free); "
        "exemplar-linked to the migrated session's trace id", (),
        (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0)),
    # ------------------------------------------------- serve/router.py
    "tk8s_route_requests_total": (
        "counter", "Requests the router placed, by replica and routing "
        "reason (affine = consistent-hash owner, spill = owner over the "
        "in-flight threshold, eject = owner unhealthy/ejected)",
        ("replica", "reason"), None),
    "tk8s_route_replica_healthy": (
        "gauge", "Replica health as the router sees it (1 = in "
        "rotation, 0 = ejected; /healthz probes re-admit on recovery)",
        ("replica",), None),
    # -------- train/pipeline.py, checkpoint.py, resilience.py (one
    # process: the reference's process_id label has one value here and is
    # dropped)
    "tk8s_train_step_duration_seconds": (
        "histogram", "Per-step wall-clock duration, amortized over each "
        "sync window of the pipelined training loop", ("config",),
        DEFAULT_BUCKETS),
    "tk8s_train_tokens_total": (
        "counter", "Tokens trained, incremented at each host sync point",
        ("config",), None),
    "tk8s_train_host_syncs_total": (
        "counter", "Device->host metric syncs taken by the training loop "
        "(one per sync window, NOT one per step)", ("config",), None),
    "tk8s_train_steps_in_flight": (
        "gauge", "Dispatched-but-unsynced steps currently in flight in "
        "the pipelined training loop", (), None),
    "tk8s_train_prefetch_wait_seconds": (
        "gauge", "Seconds the training loop has spent blocked waiting on "
        "the device-prefetch iterator (cumulative; ~0 means host input "
        "fully overlaps device compute)", (), None),
    # ------------------------------- train/trainer.py (kernel builds)
    "tk8s_train_compile_seconds": (
        "gauge", "Ahead-of-time split of the train step by phase (lower: "
        "0, nothing is traced; compile: the build and load of its CUDA "
        "kernels, near zero on a warm build directory)",
        ("config", "phase"), None),
    "tk8s_train_memory_bytes": (
        "gauge", "Device byte accounting of one train step, measured on "
        "the card (MemoryStats), by kind (argument/output/temp/alias/"
        "peak); temp is what a remat policy moves, argument what a "
        "precision policy's storage dtypes move", ("config", "kind"),
        None),
    # ------------------------------------------------------------ chaos/
    "tk8s_chaos_scenarios_total": (
        "counter", "Chaos-harness scenarios run, by verdict "
        "(ok / violated)", ("status",), None),
    "tk8s_chaos_invariant_checks_total": (
        "counter", "Chaos-harness invariant evaluations by invariant id "
        "and verdict", ("invariant", "status"), None),
    "tk8s_chaos_shrink_steps_total": (
        "counter", "Candidate reductions tried while shrinking failing "
        "chaos specs, by outcome (accepted / rejected)",
        ("outcome",), None),
    "tk8s_chaos_workload_arms_total": (
        "counter", "Workload fault arms run by the chaos harness, by "
        "fault kind and outcome (ok / violated / skipped)",
        ("kind", "status"), None),
    # --------------------------------- train/checkpoint.py (integrity)
    "tk8s_train_checkpoint_save_duration_seconds": (
        "histogram", "Wall clock from checkpoint-save dispatch to "
        "manifest commit, by save kind (scheduled/emergency/final)",
        ("kind",), DEFAULT_BUCKETS),
    "tk8s_train_checkpoint_bytes_total": (
        "counter", "Bytes committed to manifest-verified checkpoints, "
        "by save kind", ("kind",), None),
    "tk8s_train_checkpoint_verify_failures_total": (
        "counter", "Checkpoint manifest verification failures, by "
        "reason (missing-manifest/torn-manifest/digest-mismatch/"
        "truncated/checksum-mismatch/missing-file/missing-step)",
        ("reason",), None),
    "tk8s_train_checkpoint_emergency_saves_total": (
        "counter", "Synchronous emergency checkpoints written on a "
        "preemption warning", (), None),
    "tk8s_train_checkpoint_fallback_restores_total": (
        "counter", "Restores that quarantined a bad step and fell back "
        "to an earlier verified one", (), None),
    # --------------------------------- train/resilience.py (anomaly guard)
    "tk8s_train_anomaly_rollbacks_total": (
        "counter", "Loss-anomaly rollbacks taken by the guarded "
        "training loop, by trip reason (non-finite/spike)",
        ("reason",), None),
    "tk8s_train_anomaly_aborts_total": (
        "counter", "Guarded-loop aborts after the consecutive-rollback "
        "budget was exhausted", (), None),
    # ----------------------------------------- goodput ledger (fleet-wide)
    "tk8s_goodput_seconds_total": (
        "counter", "Chip-seconds attributed by the goodput ledger, by "
        "source (serve/train/route) and category — ticked from the same "
        "closed segments that land as <source>.goodput trace spans, so "
        "the categories partition each process's recorded wall window "
        "exactly (GOODPUT_CATEGORIES in utils/trace.py is the closed "
        "vocabulary; lint rule TK8S113 pins it)",
        ("source", "category", "process_id"), None),
    # -------------------------------------------------- executor/engine.py
    "tk8s_module_apply_duration_seconds": (
        "histogram", "Wall-clock duration of one module apply "
        "(including retries and backoff)", ("module",), DEFAULT_BUCKETS),
    "tk8s_module_apply_attempts_total": (
        "counter", "Module apply attempts (first try + every retry)",
        ("module",), None),
    "tk8s_apply_retries_total": (
        "counter", "Retries taken after a transient module-apply fault",
        ("module",), None),
    "tk8s_apply_faults_total": (
        "counter", "Module-apply faults by retryability classification",
        ("kind",), None),
    "tk8s_apply_backoff_seconds_total": (
        "counter", "Total seconds slept in retry backoff across applies",
        (), None),
    "tk8s_applies_total": (
        "counter", "Whole-graph applies by terminal journal status",
        ("status",), None),
    "tk8s_destroys_total": (
        "counter", "Whole-graph/targeted destroys by terminal journal "
        "status", ("status",), None),
    "tk8s_module_destroy_duration_seconds": (
        "histogram", "Wall-clock duration of one module destroy",
        ("module",), DEFAULT_BUCKETS),
    "tk8s_apply_in_flight": (
        "gauge", "Modules currently in flight in the wavefront "
        "apply/destroy scheduler (bounded by --parallelism)", (), None),
    "tk8s_apply_waves_total": (
        "counter", "Dependency waves (DAG depth levels) dispatched by "
        "the wavefront scheduler", (), None),
    "tk8s_apply_critical_path_seconds": (
        "gauge", "Critical-path (longest dependency chain) seconds of "
        "the most recent apply/destroy — the floor no parallelism can "
        "beat", ("kind",), None),
    "tk8s_apply_total_work_seconds": (
        "gauge", "Sum of per-module durations of the most recent "
        "apply/destroy — what a serial run would pay", ("kind",), None),
    "tk8s_state_saves_total": (
        "counter", "Executor-state (journal) saves by backend kind",
        ("backend",), None),
    # ------------------------------------------------ executor/cloudsim.py
    "tk8s_cloudsim_ops_total": (
        "counter", "Simulated cloud mutations by operation", ("op",), None),
    "tk8s_cloudsim_faults_total": (
        "counter", "Injected simulator faults fired, by kind",
        ("kind",), None),
    "tk8s_cloudsim_preemptions_total": (
        "counter", "GPU pool preemptions fired in the simulator", (), None),
    # ------------------------------------------------- workflows/repair.py
    "tk8s_repairs_total": (
        "counter", "repair {node,slice} workflow runs by outcome",
        ("kind", "outcome"), None),
    # --------------------------------------------- operator/ (reconcile)
    "tk8s_operator_reconciles_total": (
        "counter", "Reconcile ticks by outcome (noop = no drift, acted "
        "= a rule ran, failed = a rule raised)", ("outcome",), None),
    "tk8s_operator_reconcile_duration_seconds": (
        "histogram", "Wall-clock duration of one observe->diff->act "
        "reconcile tick", (), DEFAULT_BUCKETS),
    "tk8s_operator_drift_total": (
        "counter", "Drift items the reconciler observed, by kind "
        "(apply = missing/changed desired module, prune = orphaned "
        "applied module, preempted = dead GPU pool awaiting "
        "replacement)", ("kind",), None),
    "tk8s_operator_scale_decisions_total": (
        "counter", "Autoscaler decisions per reconcile tick, by "
        "direction (grow/drain/hold) and the policy reason that drove "
        "it (ttft-slo-breach, queue-high, calm, cooldown, risk-floor, "
        "at-max, at-min, hysteresis, no-signal, repair-first, "
        "nothing-drainable)",
        ("direction", "reason"), None),
    "tk8s_operator_rebalances_total": (
        "counter", "KV-pressure rebalance actuations between serving "
        "replicas (migrate one session from the most- to the "
        "least-pressured replica), by status (ok / failed)",
        ("status",), None),
    "tk8s_operator_slo_attainment": (
        "gauge", "Fraction of recent reconcile ticks (sliding window) "
        "whose observed serving signal met the SLO, by slo "
        "(ttft_p99 / queue_depth); 1.0 = fully attained", ("slo",), None),
    "tk8s_operator_pools": (
        "gauge", "GPU node pools currently desired for the "
        "autoscaled cluster (the autoscaler's scaling unit)",
        ("cluster",), None),
    "tk8s_operator_train_resizes_total": (
        "counter", "Train-fleet policy decisions per reconcile tick, "
        "by direction (replace/shrink/regrow/hold) and the rule reason "
        "that drove it (replace-lost, shrink-instead-of-wait, regrow, "
        "converged, no-signal, no-capacity, await-capacity, "
        "serving-pressure, cooldown, done)",
        ("direction", "reason"), None),
    "tk8s_operator_train_workers": (
        "gauge", "Train worker processes the operator last decided the "
        "fleet should run (the elastic trainer's negotiated world "
        "size)", (), None),
    "tk8s_operator_fleet_goodput": (
        "gauge", "Fleet useful-chip-time fraction over the most recent "
        "reconcile window (useful categories / all accounted "
        "chip-seconds across scraped sources) — the signal the "
        "goodput-aware arbitration policy reads", (), None),
}

_VALID_KINDS = ("counter", "gauge", "histogram")


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """One metric family: a name, label schema, and its labeled series."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.RLock,
                 defaults: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock  # the owning registry's lock, shared
        # Registry-wide default label values (shared dict): declared
        # labels a call site omits are filled from here — how every
        # tk8s_train_* family gets its process_id rank tag without each
        # call site threading the rank through.
        self._defaults = defaults if defaults is not None else {}
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        missing = set(self.labelnames) - set(labels)
        if missing & set(self._defaults):
            labels = dict(labels)
            for name in missing:
                if name in self._defaults:
                    labels[name] = self._defaults[name]
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {list(self.labelnames)}, "
                f"got {sorted(labels)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _label_str(self, key: Tuple[str, ...]) -> str:
        if not self.labelnames:
            return ""
        pairs = ",".join(f'{n}="{_escape_label(v)}"'
                         for n, v in zip(self.labelnames, key))
        return "{" + pairs + "}"

    def samples(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"labels": dict(zip(self.labelnames, key)),
                     "value": value}
                    for key, value in sorted(self._series.items())]


class Counter(_Metric):
    """Monotonically increasing count. Prometheus convention: name ends
    in ``_total``."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.RLock,
                 defaults: Optional[Dict[str, str]] = None):
        super().__init__(name, help, labelnames, lock, defaults)
        # series key -> last exemplar (OpenMetrics counter semantics:
        # at most one exemplar per sample, last-writer-wins).
        self._exemplars: Dict[Tuple[str, ...], Dict[str, Any]] = {}

    def inc(self, amount: float = 1.0,
            exemplar: Optional[str] = None, **labels: Any) -> None:
        """Add ``amount``; an ``exemplar`` (a trace id) is pinned to the
        series, last-writer-wins — the link from a rate spike back to
        the concrete request trace that drove it (e.g. a slow KV
        migration resolves to its handoff trace)."""
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc by {amount})")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount
            if exemplar is not None:
                self._exemplars[key] = {"trace_id": str(exemplar),
                                        "value": float(amount)}

    def exemplar(self, **labels: Any) -> Optional[Dict[str, Any]]:
        """The last exemplar recorded for one series (or None)."""
        with self._lock:
            ex = self._exemplars.get(self._key(labels))
            return dict(ex) if ex is not None else None

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)


class Gauge(_Metric):
    """A value that can go up and down (queue depth, in-flight ops)."""

    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: Any) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)


class Histogram(_Metric):
    """Fixed-bucket histogram (Prometheus semantics: cumulative buckets,
    implicit ``+Inf``, plus ``_sum`` and ``_count``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 defaults: Optional[Dict[str, str]] = None):
        super().__init__(name, help, labelnames, lock, defaults)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name!r} needs at least one bucket")
        self.buckets = bs

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels: Any) -> None:
        """Record ``value``; an ``exemplar`` (a trace id) is pinned to
        the landing bucket, last-writer-wins — the link from a latency
        histogram back to the concrete request trace that landed there
        (OpenMetrics exemplar semantics, one per bucket)."""
        key = self._key(labels)
        v = float(value)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = {"counts": [0] * len(self.buckets),
                          "sum": 0.0, "count": 0, "exemplars": {}}
                self._series[key] = series
            idx = len(self.buckets)  # the implicit +Inf bucket
            for i, le in enumerate(self.buckets):
                if v <= le:
                    series["counts"][i] += 1
                    idx = i
                    break  # counts are per-bucket here; cumulated on render
            if exemplar is not None:
                series["exemplars"][idx] = {"trace_id": str(exemplar),
                                            "value": v}
            series["sum"] += v
            series["count"] += 1

    def count(self, **labels: Any) -> int:
        with self._lock:
            series = self._series.get(self._key(labels))
            return series["count"] if series else 0

    def sum(self, **labels: Any) -> float:
        with self._lock:
            series = self._series.get(self._key(labels))
            return series["sum"] if series else 0.0

    def samples(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        with self._lock:
            for key, series in sorted(self._series.items()):
                cum, buckets = 0, {}
                for le, c in zip(self.buckets, series["counts"]):
                    cum += c
                    buckets[_format_value(le)] = cum
                buckets["+Inf"] = series["count"]
                out.append({"labels": dict(zip(self.labelnames, key)),
                            "buckets": buckets, "sum": series["sum"],
                            "count": series["count"]})
        return out

    def _le_str(self, idx: int) -> str:
        return ("+Inf" if idx >= len(self.buckets)
                else _format_value(self.buckets[idx]))

    def exemplars(self, **labels: Any) -> Dict[str, Dict[str, Any]]:
        """Per-bucket last exemplars for one series, keyed by the
        bucket's ``le`` exposition string (incl. ``"+Inf"``)."""
        with self._lock:
            series = self._series.get(self._key(labels))
            if series is None:
                return {}
            return {self._le_str(i): dict(ex)
                    for i, ex in sorted(series.get("exemplars",
                                                   {}).items())}

    def exemplar_for_quantile(self, q: float,
                              **labels: Any) -> Optional[Dict[str, Any]]:
        """The exemplar of the bucket quantile ``q`` lands in — what
        links "TTFT p99 is breaching" to one offending request trace.
        Walks down to the nearest lower populated-exemplar bucket when
        the landing bucket has none (its last traced observation may
        have been evicted by a registry reset)."""
        with self._lock:
            series = self._series.get(self._key(labels))
            if series is None or series["count"] == 0:
                return None
            rank = q * series["count"]
            cum = 0.0
            landing = len(self.buckets)
            for i, c in enumerate(series["counts"]):
                cum += c
                if cum >= rank:
                    landing = i
                    break
            exemplars = series.get("exemplars", {})
            # Landing bucket first; then higher buckets (slower traces
            # — they explain a tail breach at least as well); then
            # lower as a last resort.
            order = list(range(landing, len(self.buckets) + 1)) \
                + list(range(landing - 1, -1, -1))
            for i in order:
                if i in exemplars:
                    return dict(exemplars[i], le=self._le_str(i))
        return None


class MetricsRegistry:
    """Thread-safe named collection of metric families.

    ``counter``/``gauge``/``histogram`` are create-or-get: the first call
    fixes the family's help/labels (falling back to :data:`CATALOG` when
    omitted); later calls must agree on kind and label names.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Metric] = {}
        # Default label values filled into any family that declares the
        # label but whose call site omits it. process_id defaults to "0"
        # (the truthful single-process rank); a multi-process run calls
        # set_default_labels(process_id=<rank>) once after distributed
        # init and every series of a family declaring the label is
        # rank-tagged from then on.
        self._default_labels: Dict[str, str] = {"process_id": "0"}

    # ------------------------------------------------------------ families
    def _get_or_create(self, kind: str, name: str, help: Optional[str],
                       labelnames: Optional[Sequence[str]],
                       buckets: Optional[Sequence[float]]) -> _Metric:
        cat = CATALOG.get(name)
        if help is None:
            help = cat[1] if cat else ""
        if labelnames is None:
            labelnames = cat[2] if cat else ()
        if buckets is None:
            buckets = (cat[3] if cat and cat[3] else DEFAULT_BUCKETS)
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if existing.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {kind}")
                if existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{list(existing.labelnames)}, not {list(labelnames)}")
                return existing
            if kind == "counter":
                fam = Counter(name, help, labelnames, self._lock,
                              self._default_labels)
            elif kind == "gauge":
                fam = Gauge(name, help, labelnames, self._lock,
                            self._default_labels)
            elif kind == "histogram":
                fam = Histogram(name, help, labelnames, self._lock, buckets,
                                self._default_labels)
            else:
                raise ValueError(f"unknown metric kind {kind!r} "
                                 f"(valid: {list(_VALID_KINDS)})")
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: Optional[str] = None,
                labelnames: Optional[Sequence[str]] = None) -> Counter:
        return self._get_or_create("counter", name, help, labelnames, None)  # type: ignore[return-value]

    def gauge(self, name: str, help: Optional[str] = None,
              labelnames: Optional[Sequence[str]] = None) -> Gauge:
        return self._get_or_create("gauge", name, help, labelnames, None)  # type: ignore[return-value]

    def histogram(self, name: str, help: Optional[str] = None,
                  labelnames: Optional[Sequence[str]] = None,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create("histogram", name, help, labelnames,
                                   buckets)  # type: ignore[return-value]

    def set_default_labels(self, **labels: Any) -> None:
        """Set registry-wide default label values (merged into every
        family — existing and future — that declares the label). The
        multi-process rank tag: ``set_default_labels(process_id="1")``."""
        with self._lock:
            for name, value in labels.items():
                self._default_labels[str(name)] = str(value)

    def register_catalog(self) -> None:
        """Instantiate every :data:`CATALOG` family (zero series), so a
        dump shows the full metric surface even before traffic."""
        for name, (kind, help, labelnames, buckets) in CATALOG.items():
            self._get_or_create(kind, name, help, labelnames, buckets)

    def reset(self) -> None:
        """Drop every family (tests). Call sites re-create on demand."""
        with self._lock:
            self._families.clear()

    # ---------------------------------------------------------- exposition
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view: {name: {type, help, labelnames, series}}."""
        with self._lock:
            fams = list(self._families.values())
        out: Dict[str, Any] = {}
        for fam in sorted(fams, key=lambda f: f.name):
            out[fam.name] = {
                "type": fam.kind,
                "help": fam.help,
                "labelnames": list(fam.labelnames),
                "series": fam.samples(),
            }
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        with self._lock:
            fams = list(self._families.values())
        lines: List[str] = []
        for fam in sorted(fams, key=lambda f: f.name):
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            if isinstance(fam, Histogram):
                for s in fam.samples():
                    base = [(n, s["labels"][n]) for n in fam.labelnames]
                    for le, cum in s["buckets"].items():
                        pairs = ",".join(
                            [f'{n}="{_escape_label(v)}"' for n, v in base]
                            + [f'le="{le}"'])
                        lines.append(
                            f"{fam.name}_bucket{{{pairs}}} {cum}")
                    suffix = fam._label_str(
                        tuple(s["labels"][n] for n in fam.labelnames))
                    lines.append(f"{fam.name}_sum{suffix} "
                                 f"{_format_value(s['sum'])}")
                    lines.append(f"{fam.name}_count{suffix} {s['count']}")
            else:
                for s in fam.samples():
                    suffix = fam._label_str(
                        tuple(s["labels"][n] for n in fam.labelnames))
                    lines.append(
                        f"{fam.name}{suffix} {_format_value(s['value'])}")
        return "\n".join(lines) + ("\n" if lines else "")

    def render_openmetrics(self) -> str:
        """OpenMetrics text exposition: the Prometheus rendering plus
        per-bucket **exemplars** (``# {trace_id="..."} value``) on
        histogram ``_bucket`` lines and the mandatory ``# EOF``
        terminator. This is the surface that links a latency histogram
        to the concrete request trace last seen in each bucket — e.g.
        the operator's windowed TTFT p99 resolves to the offending
        trace id. Served at ``/metrics?format=openmetrics``; the plain
        0.0.4 rendering (and its strict parser) is unchanged."""
        with self._lock:
            fams = list(self._families.values())
        lines: List[str] = []
        for fam in sorted(fams, key=lambda f: f.name):
            # OpenMetrics counter naming: the FAMILY name must not end
            # in _total; only the sample carries the suffix. Our
            # catalog names counters tk8s_*_total (Prometheus 0.0.4
            # style), so strip it for HELP/TYPE and re-suffix the
            # sample lines — a strict OM parser drops the whole scrape
            # otherwise.
            om_name = fam.name
            if fam.kind == "counter" and om_name.endswith("_total"):
                om_name = om_name[: -len("_total")]
            if fam.help:
                lines.append(f"# HELP {om_name} {fam.help}")
            kind = "unknown" if fam.kind == "untyped" else fam.kind
            lines.append(f"# TYPE {om_name} {kind}")
            if isinstance(fam, Histogram):
                for s in fam.samples():
                    base = [(n, s["labels"][n]) for n in fam.labelnames]
                    exemplars = fam.exemplars(**s["labels"])
                    for le, cum in s["buckets"].items():
                        pairs = ",".join(
                            [f'{n}="{_escape_label(v)}"' for n, v in base]
                            + [f'le="{le}"'])
                        line = f"{fam.name}_bucket{{{pairs}}} {cum}"
                        ex = exemplars.get(le)
                        if ex is not None:
                            line += (f' # {{trace_id="'
                                     f'{_escape_label(ex["trace_id"])}"}} '
                                     f'{_format_value(ex["value"])}')
                        lines.append(line)
                    suffix = fam._label_str(
                        tuple(s["labels"][n] for n in fam.labelnames))
                    lines.append(f"{fam.name}_sum{suffix} "
                                 f"{_format_value(s['sum'])}")
                    lines.append(f"{fam.name}_count{suffix} {s['count']}")
            else:
                sample_name = (f"{om_name}_total"
                               if fam.kind == "counter" else fam.name)
                for s in fam.samples():
                    suffix = fam._label_str(
                        tuple(s["labels"][n] for n in fam.labelnames))
                    line = (f"{sample_name}{suffix} "
                            f"{_format_value(s['value'])}")
                    if isinstance(fam, Counter):
                        ex = fam.exemplar(**s["labels"])
                        if ex is not None:
                            line += (f' # {{trace_id="'
                                     f'{_escape_label(ex["trace_id"])}"}} '
                                     f'{_format_value(ex["value"])}')
                    lines.append(line)
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-default registry (mirrors ``get_logger()``)."""
    return _default


def configure(registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Swap the process-default registry (tests, embedders)."""
    global _default
    _default = registry if registry is not None else MetricsRegistry()
    return _default


# Convenience module-level constructors against the *current* default
# registry — instrumented call sites use these so a registry swap/reset
# takes effect immediately (no stale family references).
def set_default_labels(**labels: Any) -> None:
    """Registry-wide default label values on the current default
    registry (see :meth:`MetricsRegistry.set_default_labels`)."""
    get_registry().set_default_labels(**labels)


def counter(name: str, help: Optional[str] = None,
            labelnames: Optional[Sequence[str]] = None) -> Counter:
    return get_registry().counter(name, help, labelnames)


def gauge(name: str, help: Optional[str] = None,
          labelnames: Optional[Sequence[str]] = None) -> Gauge:
    return get_registry().gauge(name, help, labelnames)


def histogram(name: str, help: Optional[str] = None,
              labelnames: Optional[Sequence[str]] = None,
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return get_registry().histogram(name, help, labelnames, buckets)


# ---------------------------------------------------------------------------
# Prometheus text parsing (the scrape side)
# ---------------------------------------------------------------------------
#
# The read half of :meth:`MetricsRegistry.render_prometheus`: a saved
# ``/metrics`` body parses back into the snapshot shape (``goodput report
# --metrics`` folds its ``tk8s_goodput_seconds_total`` samples in beside the
# trace-derived ledger). Dependency-free and strict: a malformed line raises
# with its line number, since a scrape that half-parses would feed its
# reader silent garbage.

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?\d+))?\s*$")
_LABEL_RE = re.compile(
    r'(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"')


class PrometheusParseError(ValueError):
    """A scrape body does not parse as Prometheus text exposition 0.0.4.
    Carries the 1-based line number so an operator log names the exact
    offending line of the replica's /metrics response."""

    def __init__(self, lineno: int, line: str, reason: str):
        super().__init__(f"line {lineno}: {reason}: {line!r}")
        self.lineno = lineno
        self.line = line


def _unescape_label(value: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(raw: str, lineno: int, line: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    pos = 0
    raw = raw.strip()
    while pos < len(raw):
        m = _LABEL_RE.match(raw, pos)
        if m is None:
            raise PrometheusParseError(lineno, line, "malformed label pair")
        labels[m.group("name")] = _unescape_label(m.group("value"))
        pos = m.end()
        if pos < len(raw):
            if raw[pos] != ",":
                raise PrometheusParseError(
                    lineno, line, "expected ',' between labels")
            pos += 1
    return labels


def _parse_value(raw: str, lineno: int, line: str) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    if raw == "NaN":
        return math.nan
    try:
        return float(raw)
    except ValueError:
        raise PrometheusParseError(
            lineno, line, f"sample value {raw!r} is not a number") from None


def parse_prometheus(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse Prometheus text exposition into a snapshot-shaped dict:
    ``{family: {"type", "help", "series": [...]}}``.

    Plain families carry ``series: [{"labels", "value"}]``; histogram
    families (``# TYPE ... histogram``) are reassembled from their
    ``_bucket``/``_sum``/``_count`` samples into
    ``[{"labels", "buckets": {le: cumulative}, "sum", "count"}]`` — the
    exact shape :meth:`Histogram.samples` emits, so a render -> parse
    round trip is an identity on the series content. Untyped samples
    (no ``# TYPE``) are treated as plain. Raises
    :class:`PrometheusParseError` on any malformed line.
    """
    families: Dict[str, Dict[str, Any]] = {}
    types: Dict[str, str] = {}

    def family(name: str) -> Dict[str, Any]:
        return families.setdefault(
            name, {"type": types.get(name, "untyped"), "help": "",
                   "series": []})

    def hist_series(fam: Dict[str, Any],
                    labels: Dict[str, str]) -> Dict[str, Any]:
        for s in fam["series"]:
            if s["labels"] == labels:
                return s
        s = {"labels": labels, "buckets": {}, "sum": 0.0, "count": 0}
        fam["series"].append(s)
        return s

    for lineno, line in enumerate(text.splitlines(), start=1):
        stripped = line.strip()
        if not stripped:
            continue
        if stripped.startswith("#"):
            parts = stripped.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                kind = parts[3] if len(parts) > 3 else ""
                if kind not in _VALID_KINDS + ("untyped", "summary"):
                    raise PrometheusParseError(
                        lineno, line, f"unknown metric type {kind!r}")
                types[parts[2]] = kind
                family(parts[2])["type"] = kind
            elif len(parts) >= 3 and parts[1] == "HELP":
                family(parts[2])["help"] = parts[3] if len(parts) > 3 else ""
            # Other comments are legal and ignored.
            continue
        m = _SAMPLE_RE.match(stripped)
        if m is None:
            raise PrometheusParseError(lineno, line, "malformed sample line")
        name = m.group("name")
        labels = _parse_labels(m.group("labels") or "", lineno, line)
        value = _parse_value(m.group("value"), lineno, line)
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and \
                    types.get(name[: -len(suffix)]) == "histogram":
                base = name[: -len(suffix)]
                break
        if base != name:
            fam = family(base)
            if name.endswith("_bucket"):
                if "le" not in labels:
                    raise PrometheusParseError(
                        lineno, line, "histogram bucket without le label")
                le = labels.pop("le")
                hist_series(fam, labels)["buckets"][le] = value
            elif name.endswith("_sum"):
                hist_series(fam, labels)["sum"] = value
            else:
                hist_series(fam, labels)["count"] = int(value)
        else:
            family(name)["series"].append(
                {"labels": labels, "value": value})
    return families


def histogram_quantile(buckets: Dict[str, float], q: float) -> float:
    """Prometheus-style quantile from cumulative buckets
    (``{le: cumulative_count}``, ``le`` as exposition strings incl.
    ``"+Inf"``), with linear interpolation inside the landing bucket.

    Matches PromQL ``histogram_quantile`` semantics: the answer for a
    quantile that lands in the ``+Inf`` bucket is the highest finite
    bound (the histogram cannot see past its buckets), and an empty
    histogram returns 0.0. The lower edge of the first bucket is 0 —
    these are latency histograms.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    def is_inf(le: str) -> bool:
        # Any overflow-bucket spelling: "+Inf", "inf", "+INF", ...
        return le.lstrip("+").lower() == "inf"

    finite = sorted(
        (float(le), float(cum)) for le, cum in buckets.items()
        if not is_inf(le))
    overflow = [float(cum) for le, cum in buckets.items() if is_inf(le)]
    total = (max(overflow) if overflow
             else (finite[-1][1] if finite else 0.0))
    if total <= 0:
        return 0.0
    rank = q * total
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in finite:
        if cum >= rank:
            if cum <= prev_cum:
                return le
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = le, cum
    # Landed past every finite bucket: report the highest finite bound.
    return finite[-1][0] if finite else 0.0


def merge_histogram_series(series: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Sum several parsed histogram series (e.g. one per scraped
    replica) into one: cumulative buckets added per ``le``, sums and
    counts added. The fleet-wide TTFT distribution the autoscaler
    quantiles is exactly this merge."""
    buckets: Dict[str, float] = {}
    total_sum, total_count = 0.0, 0
    for s in series:
        for le, cum in s.get("buckets", {}).items():
            buckets[le] = buckets.get(le, 0.0) + float(cum)
        total_sum += float(s.get("sum", 0.0))
        total_count += int(s.get("count", 0))
    return {"labels": {}, "buckets": buckets, "sum": total_sum,
            "count": total_count}
