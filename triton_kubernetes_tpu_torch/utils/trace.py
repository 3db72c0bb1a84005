"""Request/span tracing: single-process collection, fleet-wide merge --
the port's own copy of ``triton_kubernetes_tpu/utils/trace.py``, every
public name with its semantics and its JSONL lines unchanged, so a trace
written by either package merges and validates with the other's.

Three layers, all dependency-free:

* :class:`TraceCollector` -- one Chrome trace event per finished span.
* :class:`TraceWriter` + :class:`FlightRecorder` -- every traced process
  appends span events as JSON lines through a :class:`TraceWriter`, whose
  first line anchors the process's *injectable* clock to the wall clock;
  the serving engine's :class:`FlightRecorder` also keeps a bounded
  in-memory lifecycle per request (submitted -> admitted -> prefill
  windows -> first token -> grows -> preempt/re-prefill -> verify ->
  finish) and folds it into an exact per-phase latency attribution
  (``queue_s + prefill_s + decode_s + recompute_s + migrate_out_s +
  migrate_in_s == e2e`` by construction: the segments partition the
  request's lifetime). :class:`GoodputRecorder` partitions one process's
  wall time into its source's closed category vocabulary and ticks the
  port's own ``tk8s_goodput_seconds_total`` (``utils/metrics.py``).
* :func:`merge_trace_files` -- aligns each file's clock through its meta
  anchor and emits ONE Perfetto timeline, each request's lifecycle on its
  own track; :func:`validate_chrome_trace`, :func:`validate_goodput_trace`
  and :func:`validate_chaos_trace` are its validators, and
  :func:`summarize_goodput` the goodput report
  (``python -m triton_kubernetes_tpu_torch.tools.trace`` / ``.goodput``).

On a card the recorders read host time, as the reference's do over JAX's
asynchronous dispatch: a phase's attribution follows where the host
blocks (the token read in sampling), not the device.

Span/event *names* are namespaced (``serve.*`` / ``route.*`` /
``operator.*`` / ``train.*``) and declared in :data:`SPAN_CATALOG`.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, \
    Tuple

#: The HTTP header carrying the request's trace id across process
#: boundaries (router -> replica; any upstream proxy -> router). The
#: router mints ids (seeded, injectable) for requests that arrive
#: without one; a replica serving direct traffic falls back to its own
#: request id — every /generate response echoes the id it served under.
TRACE_HEADER = "X-TK8S-Trace"

_INF = float("inf")
_NINF = float("-inf")

#: The only shapes an X-TK8S-Trace header may carry. Ids the fleet
#: mints are 16-hex, but an upstream proxy may send its own — anything
#: outside this set is treated as ABSENT at the HTTP boundary (router
#: mints a fresh id; a replica falls back to the request id), because a
#: hostile header would otherwise ride verbatim into span fields, file
#: names, and metrics exemplars.
_TRACE_ID_RE = re.compile(r"^[0-9A-Za-z._-]{1,128}$")


def valid_trace_id(s: Any) -> bool:
    """True when ``s`` is usable as a fleet trace id (see
    :data:`_TRACE_ID_RE`). The router and the serving replicas gate the
    incoming trace-context header on this."""
    return isinstance(s, str) and _TRACE_ID_RE.match(s) is not None

#: name -> one-line meaning. The single source of truth the emitting
#: call sites (serve/, operator/, this module) and the span-catalog
#: table in docs/guide/observability.md share; lint rule TK8S111
#: enforces three-way agreement exactly as TK8S105 does for metrics.
SPAN_CATALOG: Dict[str, str] = {
    "serve.submitted": "request entered the engine's waiting queue",
    "serve.admitted": "request took a decode slot and its prompt pages "
                      "(recompute=True after a preemption)",
    "serve.prefill": "one prefill window ran (offset/tokens fields; the "
                     "whole prompt in legacy non-chunked mode)",
    "serve.prefill_yield": "a chunked-prefill window ended with windows "
                           "still to run — the wait for the next one is "
                           "queue time, not prefill",
    "serve.first_token": "the first token sampled — TTFT stops here",
    "serve.resume": "a preempted request finished re-prefilling its own "
                    "history and rejoined decode",
    "serve.grow": "KV pages allocated for upcoming decode writes",
    "serve.preempt": "request evicted to free pages; re-queued for "
                     "recompute",
    "serve.verify": "one speculative verify pass for this request "
                    "(proposed/accepted fields)",
    "serve.finish": "request completed (reason field: "
                    "eos/length/handoff/migrated)",
    "serve.migrate_out": "a session's KV pages packed and shipped to "
                         "another replica (bytes/pages/dest/reason "
                         "fields)",
    "serve.migrate_in": "a shipped session unpacked into this replica's "
                        "pool (bytes/pages/reused_pages/reason fields)",
    "serve.abort": "engine loop died with the request in flight; "
                   "lifecycle flushed post-mortem",
    "serve.phase": "one attributed latency segment (state field: "
                   "queue/prefill/decode/recompute/migrate_out/"
                   "migrate_in) — segments tile submit..finish exactly",
    "serve.step": "one engine scheduler tick (finished-count field)",
    "route.place": "router placed a request on a replica (replica, "
                   "reason=affine/spill/eject, status fields)",
    "route.abort": "the router gave up on a request (timeout, every "
                   "replica down, or router shutdown) — the terminal "
                   "child of its route.place spans",
    "operator.tick": "one reconcile observe->diff->act cycle (outcome "
                     "field)",
    "operator.scale": "autoscaler actuation (direction/reason/pools "
                      "fields)",
    "operator.rebalance": "KV-pressure rebalance actuation between two "
                          "serving replicas (source/target/gap/status "
                          "fields)",
    "serve.goodput": "one process-level chip-time segment (category "
                     "field) — segments tile the engine's recorded "
                     "window exactly",
    "route.goodput": "one process-level chip-time segment (category "
                     "field) — segments tile the router's recorded "
                     "window exactly",
    "train.goodput": "one process-level chip-time segment (category "
                     "field) — segments tile the trainer's recorded "
                     "window exactly",
    "train.window": "one sync window drained to host (steps/loss "
                    "fields)",
    "train.compile": "AOT lower+compile of the step function "
                     "(lower_s/compile_s fields)",
    "train.checkpoint": "one checkpoint save (step/kind fields)",
    "train.restore": "checkpoint restore (step field; rollback=True "
                     "after an anomaly trip)",
    "train.reshard": "elastic restore re-placed the state onto a "
                     "differently-sized fleet (step/from_devices/"
                     "from_processes/to_devices/to_processes/seconds "
                     "fields)",
    "operator.train_resize": "train-fleet actuation (direction/workers/"
                             "reason/status fields)",
    "train.rollback": "anomaly rollback decision (window_end/target "
                      "fields)",
    "train.preempt": "preemption honored — partial window synced, "
                     "emergency save next",
}

#: Scheduling states a request moves through; phase keys are what the
#: breakdown dict carries (`<state>_s`).
PHASE_STATES = ("queue", "prefill", "decode", "recompute",
                "migrate_out", "migrate_in")

# Lifecycle events that unconditionally move the request to a new
# scheduling state ("serve.admitted" is handled separately: it lands in
# `prefill` on first admission and `recompute` after a preemption).
_EVENT_STATE = {
    "serve.submitted": "queue",
    "serve.preempt": "queue",
    "serve.first_token": "decode",
    "serve.resume": "decode",
    "serve.migrate_out": "migrate_out",
    "serve.migrate_in": "migrate_in",
}

#: The goodput counter family every accelerator-owning process ticks —
#: same segments that land as `<source>.goodput` spans (one
#: measurement, two sinks).
GOODPUT_FAMILY = "tk8s_goodput_seconds_total"

#: The closed goodput category vocabulary, per source. Every
#: process-level chip-time segment a :class:`GoodputRecorder` books
#: carries exactly one of its source's categories; lint rule TK8S113
#: keeps the emitting sites, the metrics CATALOG entry, and the
#: category table in docs/guide/observability.md agreeing (the TK8S111
#: pattern applied to the goodput ledger).
GOODPUT_CATEGORIES: Dict[str, Tuple[str, ...]] = {
    "serve": ("prefill", "decode", "verify", "recompute",
              "migrate_out", "migrate_in", "idle"),
    "train": ("step", "compile", "data_wait", "host_sync", "checkpoint",
              "rollback_replay", "preempted_lost", "reshard", "idle"),
    "route": ("forward", "idle"),
}

#: Categories that count as *useful* chip time in the fleet rollup (the
#: operator's goodput signal). Everything not useful and not waste is
#: overhead/idle — accounted, but neither numerator.
GOODPUT_USEFUL: Dict[str, Tuple[str, ...]] = {
    "serve": ("prefill", "decode", "verify"),
    "train": ("step",),
    "route": ("forward",),
}

#: Categories that count as *waste*: chip time spent redoing or losing
#: work a fault already paid for once.
GOODPUT_WASTE: Dict[str, Tuple[str, ...]] = {
    "serve": ("recompute",),
    "train": ("rollback_replay", "preempted_lost"),
    "route": (),
}


class TraceCollector:
    """Accumulates finished spans as Chrome trace events. Thread-safe;
    one instance per traced run (the CLI makes one per invocation)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []

    def add_span(self, name: str, path: str, start_wall_s: float,
                 duration_s: float, fields: Optional[Dict[str, Any]] = None,
                 error: Optional[str] = None) -> None:
        args: Dict[str, Any] = {"path": path}
        for k, v in (fields or {}).items():
            args[k] = v if isinstance(v, (int, float, bool)) else str(v)
        if error is not None:
            args["error"] = error
        event = {
            "name": name,
            "cat": "span" if error is None else "span,error",
            "ph": "X",
            "ts": round(start_wall_s * 1e6, 3),
            "dur": round(duration_s * 1e6, 3),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": args,
        }
        with self._lock:
            self._events.append(event)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events]

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            events = sorted(self._events, key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        """Serialize to ``path`` atomically (the CLI writes on exit, even
        after a failed command — a crashed apply's trace is the one you
        most want to open)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Per-process trace JSONL (the fleet-merge input)
# ---------------------------------------------------------------------------

def mint_trace_id(rng) -> str:
    """A 16-hex trace id from a seeded ``random.Random`` — the router's
    injectable minting seam (deterministic schedules replay with
    deterministic ids)."""
    return f"{rng.getrandbits(64):016x}"


class TraceWriter:
    """Appends span events as JSON lines, one file per traced process.

    The first line is a *meta anchor*: the process role plus a
    simultaneous reading of its span clock and the wall clock. Every
    event timestamp is on the span clock (the engine's injectable
    ``clock`` seam, the router's monotonic clock, the operator's
    injected tick clock) — the merge maps it onto the shared wall
    timeline as ``wall + (at - clock)``, which is what lets processes
    with arbitrarily skewed/offset clocks land on one coherent fleet
    view. Writes are buffered and flushed every ``flush_every`` events
    (per-line flushes measurably tax the engine's tick path — the
    tracing-overhead gate in scripts/ci/trace_evidence.py); the
    post-mortem paths (the recorder's abort flush, ``close``) force a
    :meth:`flush`, so a dead engine loop's traces still land on disk.
    """

    def __init__(self, path: str, role: str, *,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 pid: Optional[int] = None, flush_every: int = 32):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.path = path
        self.role = role
        self.flush_every = max(1, int(flush_every))
        self._pending = 0
        self._lock = threading.Lock()
        self._f = open(path, "w", encoding="utf-8")
        self._write({
            "type": "meta", "version": 1, "role": role,
            "pid": pid if pid is not None else os.getpid(),
            "clock": clock(), "wall": wall(),
        })
        self.flush()  # the anchor lands immediately: a live file parses

    def _write(self, record: Dict[str, Any]) -> None:
        self._write_line(json.dumps(record, sort_keys=True, default=str))

    def _write_line(self, line: str) -> None:
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._pending += 1
            if self._pending >= self.flush_every:
                self._f.flush()
                self._pending = 0

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._pending = 0

    def event(self, name: str, at: float, dur_s: float = 0.0, *,
              trace: Optional[str] = None, request: Optional[str] = None,
              **fields: Any) -> None:
        """One span event at ``at`` (span-clock seconds), ``dur_s`` long
        (0 = instant). ``trace`` groups events onto one per-request
        track in the merged timeline.

        This is the engine tick path's only serialization site, so the
        line is built by hand: ``name``/``trace`` come from trusted
        sources (the span catalog; engine-minted hex ids) and numeric
        fields self-serialize, leaving ``json.dumps`` — ~2.5x the cost
        of the whole f-string path on the boxes this repo measures —
        only for strings that genuinely need escaping.
        """
        parts = [f'{{"type":"event","name":"{name}","at":{at:.9f}'
                 f',"dur_s":{dur_s:.9f}']
        if trace is not None:
            # The HTTP boundary only admits valid_trace_id() strings,
            # but embedders call this directly — anything that could
            # need escaping goes through json.dumps rather than
            # corrupting the line (and every line after it a reader
            # would misparse).
            if trace.isascii() and trace.isalnum():
                parts.append(f',"trace":"{trace}"')
            else:
                parts.append(',"trace":' + json.dumps(trace))
        if request is not None:
            parts.append(',"request":' + json.dumps(request))
        if fields:
            fs = ",".join(
                f'"{k}":{v}'
                if (type(v) is int) or (type(v) is float
                                        and _NINF < v < _INF)
                else f'"{k}":' + json.dumps(v, default=str)
                for k, v in fields.items())
            parts.append(',"fields":{' + fs + "}")
        parts.append("}")
        self._write_line("".join(parts))

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


# ---------------------------------------------------------------------------
# Flight recorder: bounded per-request lifecycles with phase attribution
# ---------------------------------------------------------------------------

@dataclass
class RequestTrace:
    """One request's recorded lifecycle. ``phases`` partitions the
    request's whole lifetime — the keys sum to ``finished_at -
    submitted_at`` exactly (each transition closes the previous
    segment at the same timestamp the next one opens)."""

    trace_id: str
    request_id: str
    submitted_at: float
    state: Optional[str] = "queue"     # None once finished
    state_since: float = 0.0
    phases: Dict[str, float] = field(default_factory=lambda: {
        "queue_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0,
        "recompute_s": 0.0, "migrate_out_s": 0.0, "migrate_in_s": 0.0})
    segments: List[Tuple[str, float, float]] = field(default_factory=list)
    events: List[Dict[str, Any]] = field(default_factory=list)
    events_dropped: int = 0
    preemptions: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    outcome: str = ""
    finished_at: Optional[float] = None

    @property
    def e2e_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "request_id": self.request_id,
            "submitted_at": round(self.submitted_at, 9),
            "phases": {k: round(v, 9) for k, v in self.phases.items()},
            "preemptions": self.preemptions,
            "events": len(self.events),
            "events_dropped": self.events_dropped,
            "outcome": self.outcome,
        }
        if self.spec_proposed:
            out["spec"] = {"proposed": self.spec_proposed,
                           "accepted": self.spec_accepted}
        if self.finished_at is not None:
            out["e2e_s"] = round(self.e2e_s, 9)
        return out


class FlightRecorder:
    """Bounded in-memory lifecycle store for the serving engine.

    The engine (single-owner) drives ``begin``/``event``/``finish``;
    ``/stats`` handler threads read ``snapshot()`` and the exemplar
    path reads ``lookup()`` — hence the lock. Finished lifecycles live
    in a bounded deque (oldest evicted); per-request event lists are
    capped too (``events_dropped`` counts the overflow) so a
    pathological request cannot grow memory without bound. With a
    :class:`TraceWriter` attached every event also lands as a JSON
    line the instant it happens, which is why a dead engine loop still
    leaves complete post-mortem traces (``flush_aborted``).
    """

    def __init__(self, limit: int = 256, events_per_request: int = 256,
                 writer: Optional[TraceWriter] = None):
        if limit < 1:
            raise ValueError(f"limit must be >= 1, got {limit}")
        self._lock = threading.Lock()
        self._live: Dict[str, RequestTrace] = {}
        self.finished: Deque[RequestTrace] = deque(maxlen=limit)
        self.events_per_request = events_per_request
        self.writer = writer

    # ------------------------------------------------------------ record
    def begin(self, request_id: str, trace_id: Optional[str],
              at: float) -> None:
        rec = RequestTrace(trace_id=trace_id or request_id,
                           request_id=request_id, submitted_at=at,
                           state="queue", state_since=at)
        with self._lock:
            self._live[request_id] = rec
        self._record(rec, "serve.submitted", at, {})

    def event(self, request_id: str, name: str, at: float,
              **fields: Any) -> None:
        with self._lock:
            rec = self._live.get(request_id)
        if rec is None:
            return
        self._record(rec, name, at, fields)

    def migration(self, name: str, at: float, dur_s: float = 0.0, *,
                  trace: Optional[str] = None,
                  request: Optional[str] = None, **fields: Any) -> None:
        """Writer-only migration span. A handed-off session's recorded
        lifecycle already closed at its ``finish(..., "handoff")``, so
        the pack/ship that follows cannot ride :meth:`event` (the live
        record is gone) — it lands directly on the trace file."""
        if self.writer is not None:
            self.writer.event(name, at, dur_s, trace=trace,
                              request=request, **fields)

    def finish(self, request_id: str, at: float,
               outcome: str) -> Optional[RequestTrace]:
        with self._lock:
            rec = self._live.pop(request_id, None)
        if rec is None:
            return None
        self._record(rec, "serve.finish", at, {"reason": outcome})
        self._close(rec, at, outcome)
        return rec

    def flush_aborted(self, at: float, error: str) -> List[RequestTrace]:
        """Engine-loop death: finalize every in-flight lifecycle as
        ``aborted`` so its partial phase attribution survives into the
        bounded store and (when a writer is attached) onto disk — the
        post-mortem trace of exactly the requests the crash killed."""
        with self._lock:
            live, self._live = self._live, {}
        out = []
        for rec in live.values():
            self._record(rec, "serve.abort", at, {"error": error})
            self._close(rec, at, "aborted")
            out.append(rec)
        if self.writer is not None:
            # Force the buffered lines out: the process may be about to
            # be restarted by its liveness probe.
            self.writer.flush()
        return out

    def _record(self, rec: RequestTrace, name: str, at: float,
                fields: Dict[str, Any]) -> None:
        with self._lock:
            if len(rec.events) < self.events_per_request:
                ev = {"name": name, "at": at}
                ev.update(fields)
                rec.events.append(ev)
            else:
                rec.events_dropped += 1
            if name == "serve.preempt":
                rec.preemptions += 1
            elif name == "serve.verify":
                rec.spec_proposed += int(fields.get("proposed", 0))
                rec.spec_accepted += int(fields.get("accepted", 0))
            state = _EVENT_STATE.get(name)
            if name == "serve.admitted":
                # A chunked-mode admission (deferred=True) only grants
                # the slot and pages — compute happens per window, so
                # the request stays in `queue` until its first
                # serve.prefill. Legacy admissions prefill inline.
                if fields.get("deferred"):
                    state = None
                else:
                    state = ("recompute" if fields.get("recompute")
                             else "prefill")
            elif name == "serve.prefill":
                state = "recompute" if rec.preemptions else "prefill"
            elif name == "serve.prefill_yield":
                # Window over, more to come: the wait until the engine
                # schedules the next window is queue time. Booking it
                # as prefill would silently inflate prefill_s whenever
                # two prefilling requests interleave.
                state = "queue"
            if state is not None and rec.state is not None:
                self._transition(rec, state, at)
        if self.writer is not None:
            self.writer.event(name, at, trace=rec.trace_id,
                              request=rec.request_id, **fields)

    def _transition(self, rec: RequestTrace, state: str,
                    at: float) -> None:
        # Close the open segment at exactly the timestamp the next one
        # opens: the segments tile [submitted_at, finished_at] with no
        # gap and no overlap, which is the summed-equals-e2e pin.
        if rec.state is not None and at > rec.state_since:
            rec.phases[rec.state + "_s"] += at - rec.state_since
            if len(rec.segments) < self.events_per_request:
                rec.segments.append((rec.state, rec.state_since, at))
        rec.state, rec.state_since = state, at

    def _close(self, rec: RequestTrace, at: float, outcome: str) -> None:
        with self._lock:
            self._transition(rec, "done", at)
            rec.state = None
            rec.outcome = outcome
            rec.finished_at = at
            self.finished.append(rec)
            segments = list(rec.segments)
        if self.writer is not None:
            for state, t0, t1 in segments:
                self.writer.event("serve.phase", t0, t1 - t0,
                                  trace=rec.trace_id,
                                  request=rec.request_id, state=state)

    def step(self, at: float, dur_s: float, finished: int) -> None:
        """One engine tick span (writer-only: ticks are process-level,
        not per-request, so the bounded store never sees them)."""
        if self.writer is not None:
            self.writer.event("serve.step", at, dur_s, finished=finished)

    # -------------------------------------------------------------- read
    @property
    def in_flight(self) -> int:
        with self._lock:
            return len(self._live)

    def lookup(self, trace_id: str) -> Optional[RequestTrace]:
        """The lifecycle behind a trace id (exemplar resolution):
        finished first (newest wins), then in-flight."""
        with self._lock:
            for rec in reversed(self.finished):
                if rec.trace_id == trace_id:
                    return rec
            for rec in self._live.values():
                if rec.trace_id == trace_id:
                    return rec
        return None

    def snapshot(self, limit: int = 32) -> Dict[str, Any]:
        with self._lock:
            recent = list(self.finished)[-limit:]
            in_flight = len(self._live)
        return {"in_flight": in_flight,
                "finished": [r.to_dict() for r in recent]}


# ---------------------------------------------------------------------------
# Goodput recorder: process-level chip-second attribution
# ---------------------------------------------------------------------------

class GoodputRecorder:
    """Attributes ONE process's wall time into its source's closed
    goodput vocabulary (:data:`GOODPUT_CATEGORIES`), with the flight
    recorder's construction guarantee: :meth:`transition` closes the
    open segment at exactly the timestamp the next one opens, so the
    per-category seconds *partition* ``[started_at, closed_at]`` on the
    process's injectable clock — no gap, no overlap, sum == wall.

    Each closed segment lands in two sinks from the one measurement:
    a ``<source>.goodput`` span on the attached :class:`TraceWriter`
    (when present) and the :data:`GOODPUT_FAMILY` counter family —
    the journal/trace agreement rule, applied to chip-seconds.

    The recorder opens in ``idle``. Re-transitioning into the current
    category is a no-op (no zero-length segment churn). ``enter``/
    ``exit_idle`` wrap the nesting pattern threaded servers need: the
    first concurrent enter opens the category, the last exit returns to
    idle — segments still partition by construction because only the
    depth edges transition.
    """

    def __init__(self, source: str, *,
                 clock: Callable[[], float] = time.monotonic,
                 writer: Optional[TraceWriter] = None,
                 flush_each: bool = False,
                 metrics_enabled: bool = True,
                 start_at: Optional[float] = None):
        if source not in GOODPUT_CATEGORIES:
            raise ValueError(
                f"unknown goodput source {source!r} "
                f"(valid: {sorted(GOODPUT_CATEGORIES)})")
        self.source = source
        self.categories = GOODPUT_CATEGORIES[source]
        self.clock = clock
        self.writer = writer
        self.flush_each = flush_each
        self.metrics_enabled = metrics_enabled
        self.seconds: Dict[str, float] = {c: 0.0 for c in self.categories}
        self.segments = 0
        self._span = source + ".goodput"
        self._lock = threading.Lock()
        self._depth = 0
        self.started_at = (start_at if start_at is not None else clock())
        self.state: Optional[str] = "idle"
        self.state_since = self.started_at
        self.closed_at: Optional[float] = None

    # ----------------------------------------------------------- record
    def _book(self, t1: float) -> None:
        """Close the open segment at ``t1`` (caller holds the lock)."""
        state, t0 = self.state, self.state_since
        if state is None or t1 <= t0:
            return
        self.seconds[state] += t1 - t0
        self.segments += 1
        if self.writer is not None:
            self.writer.event(self._span, t0, t1 - t0, category=state)
            if self.flush_each:
                self.writer.flush()
        if self.metrics_enabled:
            from . import metrics as _metrics
            _metrics.counter(GOODPUT_FAMILY).inc(
                t1 - t0, source=self.source, category=state)

    def transition(self, category: str, at: Optional[float] = None) -> None:
        """Open ``category`` at ``at`` (default: now on the injectable
        clock), closing the current segment at the same instant."""
        if category not in self.seconds:
            raise ValueError(
                f"category {category!r} not in the {self.source!r} "
                f"goodput vocabulary {list(self.categories)}")
        with self._lock:
            if self.state is None:
                return  # closed: a late transition cannot reopen
            if category == self.state:
                return
            t = self.clock() if at is None else at
            self._book(t)
            self.state, self.state_since = category, max(t, self.state_since)

    def enter(self, category: str, at: Optional[float] = None) -> None:
        """Depth-counted :meth:`transition` for concurrent call sites:
        only the 0→1 edge opens ``category``."""
        with self._lock:
            self._depth += 1
            first = self._depth == 1
        if first:
            self.transition(category, at)

    def exit_idle(self, at: Optional[float] = None) -> None:
        """The matching 1→0 edge returns the process to ``idle``."""
        with self._lock:
            self._depth = max(0, self._depth - 1)
            last = self._depth == 0
        if last:
            self.transition("idle", at)

    def close(self, at: Optional[float] = None) -> None:
        """Book the final segment and freeze the ledger; the recorded
        window is ``[started_at, closed_at]``."""
        with self._lock:
            if self.state is None:
                return
            t = self.clock() if at is None else at
            t = max(t, self.state_since)
            self._book(t)
            self.state = None
            self.closed_at = t
        if self.writer is not None:
            self.writer.flush()

    # ------------------------------------------------------------- read
    def wall_seconds(self, at: Optional[float] = None) -> float:
        """The recorded window so far (closed: exactly the span the
        booked categories partition)."""
        if self.closed_at is not None:
            return self.closed_at - self.started_at
        return (self.clock() if at is None else at) - self.started_at

    def accounted_seconds(self) -> float:
        return sum(self.seconds.values())

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "source": self.source,
                "seconds": {c: round(v, 9)
                            for c, v in self.seconds.items() if v > 0.0},
                "segments": self.segments,
                "wall_s": round(self.wall_seconds(
                    at=self.state_since if self.closed_at is None
                    else None), 9),
            }


# ---------------------------------------------------------------------------
# Fleet merge: N per-process JSONL files -> ONE Perfetto timeline
# ---------------------------------------------------------------------------

class TraceMergeError(ValueError):
    """A trace JSONL input cannot be merged (missing/malformed meta
    anchor or an unparsable line) — named by file and line so the
    operator fixes the right capture."""


def read_trace_jsonl(path: str) -> Tuple[Dict[str, Any],
                                         List[Dict[str, Any]]]:
    """(meta, events) from one per-process trace file. Strict: the
    first line must be the meta anchor (no anchor = no clock alignment
    = a silently wrong timeline)."""
    meta: Optional[Dict[str, Any]] = None
    events: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise TraceMergeError(
                    f"{path}:{lineno}: not valid JSON: {e}") from None
            kind = rec.get("type")
            if kind == "meta":
                if meta is not None:
                    raise TraceMergeError(
                        f"{path}:{lineno}: duplicate meta anchor")
                if not isinstance(rec.get("clock"), (int, float)) \
                        or not isinstance(rec.get("wall"), (int, float)):
                    raise TraceMergeError(
                        f"{path}:{lineno}: meta anchor needs numeric "
                        f"clock and wall readings")
                meta = rec
            elif kind == "event":
                if meta is None:
                    raise TraceMergeError(
                        f"{path}:{lineno}: event before the meta anchor")
                if not isinstance(rec.get("name"), str) \
                        or not isinstance(rec.get("at"), (int, float)):
                    raise TraceMergeError(
                        f"{path}:{lineno}: event needs a name and a "
                        f"numeric at")
                events.append(rec)
            else:
                raise TraceMergeError(
                    f"{path}:{lineno}: unknown record type {kind!r}")
    if meta is None:
        raise TraceMergeError(f"{path}: no meta anchor (empty trace?)")
    return meta, events


def merge_trace_files(paths: Sequence[str]) -> Dict[str, Any]:
    """Align every file's span clock through its meta anchor and emit
    one Chrome/Perfetto trace: one pid per process (named by role),
    tid 0 for process-level spans (engine ticks, operator ticks), one
    tid per trace id so each request's lifecycle — across every
    process it touched — reads as parallel tracks of one timeline."""
    trace_events: List[Dict[str, Any]] = []
    for pid, path in enumerate(paths):
        meta, events = read_trace_jsonl(path)
        offset = float(meta["wall"]) - float(meta["clock"])
        role = str(meta.get("role", f"proc-{pid}"))
        trace_events.append({"ph": "M", "name": "process_name",
                             "pid": pid, "tid": 0, "ts": 0.0,
                             "args": {"name": role}})
        tids: Dict[str, int] = {}
        for rec in events:
            trace = rec.get("trace")
            if trace is None:
                tid = 0
            elif trace in tids:
                tid = tids[trace]
            else:
                tid = tids[trace] = len(tids) + 1
                trace_events.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "ts": 0.0,
                    "args": {"name": f"trace {trace}"}})
            dur_s = float(rec.get("dur_s", 0.0))
            args: Dict[str, Any] = dict(rec.get("fields") or {})
            if trace is not None:
                args["trace"] = trace
            if rec.get("request") is not None:
                args["request"] = rec["request"]
            ev: Dict[str, Any] = {
                "name": rec["name"], "cat": "span",
                "ts": round((offset + float(rec["at"])) * 1e6, 3),
                "pid": pid, "tid": tid, "args": args,
            }
            if dur_s > 0.0:
                ev["ph"] = "X"
                ev["dur"] = round(dur_s * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            trace_events.append(ev)
    trace_events.sort(key=lambda e: (e["ph"] != "M", e["ts"],
                                     e["pid"], e["tid"]))
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def validate_chrome_trace(doc: Any) -> List[str]:
    """Structural validation of a merged timeline (the CI evidence
    gate's schema check). Returns problems, [] when valid."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["top level is not an object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is missing or not a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            problems.append(f"{where}: missing name")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"{where}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            problems.append(f"{where}: pid/tid must be integers")
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"{where}: ts must be a number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: complete event needs a "
                                f"non-negative dur")
        if ph == "i" and ev.get("s") not in ("t", "p", "g"):
            problems.append(f"{where}: instant event needs scope s in "
                            f"t/p/g")
    return problems


# ---------------------------------------------------------------------------
# Chaos trace-validity oracle
# ---------------------------------------------------------------------------

#: Timestamps land on disk rounded to 9 decimals and phase sums
#: accumulate float error per segment; anything past this is a real
#: attribution bug, not rounding.
_CHAOS_EPS = 1e-6


def validate_goodput_events(label: str,
                            events: Sequence[Dict[str, Any]]) -> List[str]:
    """The goodput partition oracle over ONE process's parsed events:
    its ``<source>.goodput`` segments must carry only that source's
    vocabulary and tile the recorded window contiguously — a gap means
    chip time escaped attribution, an overlap means it was booked
    twice. Either way the categories no longer partition wall time and
    the ledger is lying. Returns problems, [] when valid."""
    problems: List[str] = []
    by_source: Dict[str, List[Tuple[str, float, float]]] = {}
    for ev in events:
        name = ev.get("name", "")
        if not name.endswith(".goodput"):
            continue
        source = name[: -len(".goodput")]
        f = ev.get("fields") or {}
        t0 = float(ev["at"])
        by_source.setdefault(source, []).append(
            (str(f.get("category")), t0, t0 + float(ev.get("dur_s", 0.0))))
    for source, segs in sorted(by_source.items()):
        vocab = GOODPUT_CATEGORIES.get(source)
        if vocab is None:
            problems.append(f"{label}: goodput segments for unknown "
                            f"source {source!r}")
            continue
        bad = sorted({c for c, _, _ in segs if c not in vocab})
        if bad:
            problems.append(f"{label}: {source} goodput categories {bad} "
                            f"not in the closed vocabulary {list(vocab)}")
            continue
        segs.sort(key=lambda s: s[1])
        cursor = segs[0][1]
        ok = True
        for cat, t0, t1 in segs:
            if t0 - cursor > _CHAOS_EPS:
                problems.append(
                    f"{label}: {source} goodput gap — {cat} opens at "
                    f"{t0:.9f} but the previous segment closed at "
                    f"{cursor:.9f} ({t0 - cursor:.9f}s unattributed)")
                ok = False
                break
            if cursor - t0 > _CHAOS_EPS:
                problems.append(
                    f"{label}: {source} goodput overlap — {cat} opens at "
                    f"{t0:.9f} before the previous segment closed at "
                    f"{cursor:.9f} (chip time booked twice)")
                ok = False
                break
            cursor = max(cursor, t1)
        if not ok:
            continue
        window = segs[-1][2] - segs[0][1]
        total = sum(t1 - t0 for _, t0, t1 in segs)
        if abs(total - window) > _CHAOS_EPS:
            problems.append(
                f"{label}: {source} goodput sum {total:.9f}s != recorded "
                f"window {window:.9f}s — categories do not partition "
                f"wall time")
    return problems


def validate_goodput_trace(paths: Sequence[str]) -> List[str]:
    """Run the goodput partition oracle over per-process trace files
    (the standalone entry CI evidence and the chaos arms use)."""
    problems: List[str] = []
    for path in paths:
        try:
            meta, events = read_trace_jsonl(path)
        except TraceMergeError as e:
            problems.append(str(e))
            continue
        label = f"{os.path.basename(path)}[{meta.get('role', '?')}]"
        problems.extend(validate_goodput_events(label, events))
    return problems


def summarize_goodput(paths: Sequence[str]) -> Dict[str, Any]:
    """Fold per-process trace files into the goodput report shape:
    one ledger per process (role, source, per-category seconds, wall
    window, useful/waste split) plus a fleet rollup with the waste
    decomposed by category — the ``tk8s goodput report`` payload."""
    processes: List[Dict[str, Any]] = []
    fleet_seconds: Dict[str, Dict[str, float]] = {}
    for path in paths:
        meta, events = read_trace_jsonl(path)
        role = str(meta.get("role", "?"))
        per: Dict[str, Dict[str, float]] = {}
        window: Dict[str, List[float]] = {}
        for ev in events:
            name = ev.get("name", "")
            if not name.endswith(".goodput"):
                continue
            source = name[: -len(".goodput")]
            f = ev.get("fields") or {}
            cat = str(f.get("category"))
            t0 = float(ev["at"])
            dur = float(ev.get("dur_s", 0.0))
            per.setdefault(source, {})
            per[source][cat] = per[source].get(cat, 0.0) + dur
            lo_hi = window.setdefault(source, [t0, t0 + dur])
            lo_hi[0] = min(lo_hi[0], t0)
            lo_hi[1] = max(lo_hi[1], t0 + dur)
        for source, seconds in sorted(per.items()):
            useful = sum(seconds.get(c, 0.0)
                         for c in GOODPUT_USEFUL.get(source, ()))
            waste = sum(seconds.get(c, 0.0)
                        for c in GOODPUT_WASTE.get(source, ()))
            total = sum(seconds.values())
            lo, hi = window[source]
            processes.append({
                "path": os.path.basename(path),
                "role": role,
                "source": source,
                "wall_s": round(hi - lo, 9),
                "accounted_s": round(total, 9),
                "seconds": {c: round(v, 9)
                            for c, v in sorted(seconds.items())},
                "useful_s": round(useful, 9),
                "waste_s": round(waste, 9),
                "useful_fraction": round(useful / total, 6) if total else 0.0,
                "waste_fraction": round(waste / total, 6) if total else 0.0,
            })
            agg = fleet_seconds.setdefault(source, {})
            for c, v in seconds.items():
                agg[c] = agg.get(c, 0.0) + v
    total = sum(v for agg in fleet_seconds.values() for v in agg.values())
    useful = sum(agg.get(c, 0.0)
                 for source, agg in fleet_seconds.items()
                 for c in GOODPUT_USEFUL.get(source, ()))
    waste_by_cat: Dict[str, float] = {}
    for source, agg in fleet_seconds.items():
        for c in GOODPUT_WASTE.get(source, ()):
            if agg.get(c, 0.0) > 0.0:
                waste_by_cat[c] = waste_by_cat.get(c, 0.0) + agg[c]
    waste = sum(waste_by_cat.values())
    return {
        "processes": processes,
        "fleet": {
            "accounted_s": round(total, 9),
            "useful_s": round(useful, 9),
            "waste_s": round(waste, 9),
            "useful_fraction": round(useful / total, 6) if total else 0.0,
            "waste_fraction": round(waste / total, 6) if total else 0.0,
            "waste_by_category": {c: round(v, 9)
                                  for c, v in sorted(waste_by_cat.items())},
            "seconds": {s: {c: round(v, 9)
                            for c, v in sorted(agg.items())}
                        for s, agg in sorted(fleet_seconds.items())},
        },
    }


def validate_chaos_trace(paths: Sequence[str]) -> List[str]:
    """The chaos harness's *generic* trace-validity oracle: one check
    that any faulted arm's per-process trace files describe complete,
    exactly-attributed request lifecycles. Returns problems, [] when
    the timeline is valid.

    Per file:

    * every event name is declared in :data:`SPAN_CATALOG`;
    * every request that appears reaches a terminal
      (``serve.finish`` or ``serve.abort`` — aborted lifecycles must
      be *flushed*, not dropped);
    * the request's ``serve.phase`` spans carry only
      :data:`PHASE_STATES`, tile ``[submitted, terminal]``
      contiguously, and their durations sum to e2e exactly;
    * *exclusive prefill*: the engine runs one prefill window per
      tick, so no two requests' prefill/recompute spans may overlap
      within one file — overlap means a wait between windows was
      booked as prefill instead of queue;
    * any ``<source>.goodput`` segments pass the partition oracle
      (:func:`validate_goodput_events`): closed vocabulary, contiguous
      tiling, sum == recorded window — so a faulted trainer's ledger
      is held to the same exactness as a serving replica's phases.

    Across files:

    * every trace id the router placed (``route.place``) reaches
      ``serve.finish`` in some file or ``route.abort`` in the
      router's own — no placement span without a terminal child;
    * the files merge (:func:`merge_trace_files`) into a timeline
      that passes :func:`validate_chrome_trace`.
    """
    problems: List[str] = []
    placed, route_aborted, finished = set(), set(), set()
    readable = True
    for path in paths:
        try:
            meta, events = read_trace_jsonl(path)
        except TraceMergeError as e:
            problems.append(str(e))
            readable = False
            continue
        label = f"{os.path.basename(path)}[{meta.get('role', '?')}]"
        problems.extend(validate_goodput_events(label, events))
        reqs: Dict[str, Dict[str, Any]] = {}
        for ev in events:
            name = ev["name"]
            if name not in SPAN_CATALOG:
                problems.append(f"{label}: undeclared span name {name!r}")
            trace = ev.get("trace")
            if trace is not None:
                if name == "route.place":
                    placed.add(trace)
                elif name == "route.abort":
                    route_aborted.add(trace)
                elif name == "serve.finish":
                    finished.add(trace)
            rid = ev.get("request")
            if rid is None or not name.startswith("serve."):
                continue
            st = reqs.setdefault(rid, {"submitted": None, "terminal": None,
                                       "phase": []})
            if name == "serve.submitted":
                st["submitted"] = float(ev["at"])
            elif name in ("serve.finish", "serve.abort"):
                st["terminal"] = float(ev["at"])
            elif name == "serve.phase":
                f = ev.get("fields") or {}
                t0 = float(ev["at"])
                st["phase"].append((str(f.get("state")), t0,
                                    t0 + float(ev.get("dur_s", 0.0))))
        compute_spans: List[Tuple[float, float, str]] = []
        for rid, st in sorted(reqs.items()):
            sub, term = st["submitted"], st["terminal"]
            if sub is None:
                problems.append(f"{label}: request {rid}: events without "
                                f"serve.submitted")
                continue
            if term is None:
                problems.append(f"{label}: request {rid}: no terminal — "
                                f"never finished, never flushed as "
                                f"aborted")
                continue
            spans = sorted(st["phase"], key=lambda s: s[1])
            bad_state = [s for s, _, _ in spans if s not in PHASE_STATES]
            if bad_state:
                problems.append(f"{label}: request {rid}: unknown phase "
                                f"state(s) {sorted(set(bad_state))}")
                continue
            if not spans:
                if term - sub > _CHAOS_EPS:
                    problems.append(f"{label}: request {rid}: lifetime "
                                    f"{term - sub:.9f}s but no serve.phase "
                                    f"spans")
                continue
            cursor = sub
            for state, t0, t1 in spans:
                if abs(t0 - cursor) > _CHAOS_EPS:
                    problems.append(
                        f"{label}: request {rid}: phase gap/overlap — "
                        f"{state} opens at {t0:.9f}, previous segment "
                        f"closed at {cursor:.9f}")
                    break
                cursor = t1
            else:
                if abs(cursor - term) > _CHAOS_EPS:
                    problems.append(
                        f"{label}: request {rid}: phase spans end at "
                        f"{cursor:.9f} but terminal is at {term:.9f}")
            total = sum(t1 - t0 for _, t0, t1 in spans)
            if abs(total - (term - sub)) > _CHAOS_EPS:
                problems.append(
                    f"{label}: request {rid}: phase sum {total:.9f} != "
                    f"e2e {term - sub:.9f}")
            compute_spans.extend(
                (t0, t1, rid) for state, t0, t1 in spans
                if state in ("prefill", "recompute"))
        compute_spans.sort()
        max_end, max_rid = _NINF, None
        for t0, t1, rid in compute_spans:
            if rid != max_rid and t0 < max_end - _CHAOS_EPS:
                problems.append(
                    f"{label}: prefill overlap — requests {max_rid} and "
                    f"{rid} both in prefill/recompute at {t0:.9f} (a "
                    f"wait between windows was booked as prefill)")
            if t1 > max_end:
                max_end, max_rid = t1, rid
    for t in sorted(placed - finished - route_aborted):
        problems.append(f"route.place without terminal: trace {t} was "
                        f"placed but never reached serve.finish or "
                        f"route.abort")
    if readable:
        try:
            doc = merge_trace_files(paths)
        except TraceMergeError as e:
            problems.append(str(e))
        else:
            problems.extend(f"merged timeline: {p}"
                            for p in validate_chrome_trace(doc))
    return problems
