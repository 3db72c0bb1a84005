"""The serving HTTP front end -- the port of
``triton_kubernetes_tpu/serve/server.py`` (the reference's ``tk8s serve``;
here ``python -m triton_kubernetes_tpu_torch.tools.serve``), its wire
surface and status codes unchanged.

A stdlib ``ThreadingHTTPServer``, embeddable in tests as a context
manager, Prometheus ``/metrics`` and ``/healthz`` unauthenticated. What
is new is the threading shape: :class:`ServeEngine` is single-owner, so
handler threads never touch it — they validate, enqueue a waiter into
the engine loop's inbox, and block on its event. One **engine loop**
thread drains the inbox, calls ``engine.step()`` while work exists, and
resolves waiters as requests complete. Continuous batching falls out:
requests that arrive while a step runs are admitted at the next tick
and decode in the same batch as everything already running.

Wire surface:

========  ============  =========================================
method    path          body / response
========  ============  =========================================
GET       /healthz      ``{"ok": true, "model": ...}``
GET       /metrics      Prometheus text (tk8s_serve_* et al.)
GET       /stats        engine scheduler/pool snapshot (JSON), plus
                        ``kernel_launches``: this process's launches
                        of the hand-written kernels
POST      /generate     ``{"tokens": [ids...], "max_new_tokens": N,
                        "temperature"/"top_k"/"top_p"/"eos_id"/"seed"
                        /"handoff"}``
                        → ``{"tokens": [...], "finish_reason",
                        "ttft_s", "tpot_s", "preemptions", ...}``
POST      /migrate/out  ``{"request_id", "dest", "reason"}`` — pack the
                        session, ship it to ``dest``'s /migrate/in,
                        release on confirm / resume on failure
POST      /migrate/in   raw wire unit (serve/migration.py) →
                        ``{"request_id": local id}``; 400 on torn
POST      /await        ``{"request_id"}`` → /generate-shaped body when
                        an imported session completes
POST      /resume       ``{"request_id"}`` → /generate-shaped body:
                        un-park a session and finish it HERE (the
                        failed-transfer fallback)
========  ============  =========================================

The migration endpoints keep the single-owner rule: engine calls run as
closures on the engine loop (``_op``); only the dumb byte shipping —
an outbound POST of an already-packed payload — happens on the handler
thread, and never under a lock.

The engine loop thread launches every kernel on the device's default
stream, as the main thread does: the kernels' per-device arrival counters
(``ops/_kernels.py``) are safe only while every launch that shares them
runs on one stream, so two replicas in one process serialize there. The
loop checks this when it starts and dies (``/healthz`` 503) otherwise.
"""

from __future__ import annotations

import json
import queue
import random
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from http.server import ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import urlparse

import torch

# The default port of the serve entry point (/metrics rides the same
# listener); single-sourced from constants.py.
from ..constants import SERVE_PORT  # noqa: F401
from ..ops import decode_gemm, norms, quantization
from ..ops import paged_attention as pa
from ..utils import metrics
from ..utils.trace import TRACE_HEADER, FlightRecorder, valid_trace_id
from ._http import JSONHandler, route_label
from .engine import FinishedRequest, Request, ServeEngine
from .migration import MigrationError, TornPayloadError


def kernel_launches() -> Dict[str, int]:
    """Launches of the serving path's hand-written kernels in this process
    since their counters were last reset (the counters are process-wide:
    every replica in the process adds to them)."""
    return {"paged_decode": pa.ragged_paged_attention.launches,
            "paged_verify": pa.ragged_verify_attention.launches,
            "paged_prefill": pa.paged_prefill_attention.launches,
            "decode_gemm": decode_gemm.decode_gemm_group.launches,
            "decode_gemm_wgmma": decode_gemm.decode_gemm_group.wgmma_launches,
            "decode_gemm_w8a8": decode_gemm.w8a8_gemm_group.launches,
            "decode_gemm_w8a8_wgmma":
                decode_gemm.w8a8_gemm_group.wgmma_launches,
            "rms_norm": norms.rms_norm_rows.launches,
            "add_rms_norm": norms.add_rms_norm_rows.launches,
            "rms_norm_quant": norms.rms_norm_quant_rows.launches,
            "add_rms_norm_quant": norms.add_rms_norm_quant_rows.launches,
            "quantize_rows": quantization.quantize_rows.launches,
            "swiglu_quant": quantization.swiglu_quantize_rows.launches}


def require_default_stream(device: torch.device) -> None:
    """Raise unless the calling thread's current stream on ``device`` is
    the device's default stream (see the module docstring)."""
    if device.type != "cuda":
        return
    current = torch.cuda.current_stream(device)
    if current != torch.cuda.default_stream(device):
        raise RuntimeError(
            f"the engine loop must launch on {device}'s default stream, "
            f"not {current}: the kernels' arrival counters are shared by "
            f"every launch on the device")


@dataclass
class _Waiter:
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[FinishedRequest] = None
    error: Optional[str] = None
    fatal: bool = False  # loop death (503), not request rejection (400)


@dataclass
class _OpResult:
    """A migration control call marshaled onto the engine loop: the
    closure's return value or its exception, verbatim, so the handler
    thread can map typed MigrationErrors to status codes."""

    event: threading.Event = field(default_factory=threading.Event)
    value: Any = None
    exc: Optional[BaseException] = None


class _Handler(JSONHandler):
    server_version = "tk8s-serve"
    serve: "ServeHTTPServer"  # injected by ServeHTTPServer

    def send_response(self, code: int, message: Optional[str] = None) -> None:
        self._last_code = code
        super().send_response(code, message)

    def _counted(self, handler) -> None:
        self._last_code = 0
        try:
            handler()
        finally:
            metrics.counter("tk8s_serve_http_requests_total").inc(
                route=route_label(urlparse(self.path).path),
                method=self.command, code=str(self._last_code))

    def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
        self._counted(self._get)

    def do_POST(self) -> None:  # noqa: N802
        self._counted(self._post)

    def _get(self) -> None:
        parsed = urlparse(self.path)
        path = parsed.path
        if path == "/healthz":
            # Health is the ENGINE LOOP's, not this handler thread's: a
            # dead scheduler must flip the liveness probe (the rendered
            # Deployment restarts on /healthz), not serve 200 forever.
            err = self.serve.loop_error
            if err is not None:
                self._json(503, {"ok": False, "error": err,
                                 "model": self.serve.engine.config.name})
                return
            self._json(200, {"ok": True,
                             "model": self.serve.engine.config.name})
        elif path == "/metrics":
            self._metrics_response(metrics.get_registry(), parsed.query)
        elif path == "/stats":
            self._json(200, dict(self.serve.engine.stats(),
                                 kernel_launches=kernel_launches()))
        else:
            self._json(404, {"type": "error", "message": "not found"})

    def _post(self) -> None:
        path = urlparse(self.path).path
        if path == "/migrate/out":
            self._migrate_out()
            return
        if path == "/migrate/in":
            self._migrate_in()
            return
        if path == "/await":
            self._await()
            return
        if path == "/resume":
            self._resume()
            return
        if path != "/generate":
            self._json(404, {"type": "error", "message": "not found"})
            return
        n = int(self.headers.get("Content-Length") or 0)
        try:
            d = json.loads(self.rfile.read(n) if n else b"{}")
            if not isinstance(d, dict):
                raise ValueError("body must be a JSON object")
            tokens = d.get("tokens")
            if (not isinstance(tokens, list)
                    or not all(isinstance(t, int) for t in tokens)):
                raise ValueError("'tokens' must be a list of token ids")
            eos_id = d.get("eos_id")
            sid = d.get("session_id")
            if sid is not None and not isinstance(sid, str):
                # The router's affinity key rides along to the replica;
                # a malformed one is the caller's fault, not ours to
                # coerce (the engine itself never reads it).
                raise ValueError("'session_id' must be a string")
            opts = {
                "max_new_tokens": int(d.get("max_new_tokens", 16)),
                "temperature": float(d.get("temperature", 0.0)),
                "top_k": int(d.get("top_k", 0)),
                "top_p": float(d.get("top_p", 1.0)),
                "eos_id": int(eos_id) if eos_id is not None else None,
                "seed": int(d.get("seed", 0)),
                # Disaggregation: a prefill-pool replica answers with
                # the first token and finish_reason "handoff", pages
                # parked for /migrate/out (router sets this).
                "handoff": bool(d.get("handoff", False)),
            }
        except (ValueError, TypeError) as e:
            # TypeError too: float(None)/int([]) from a malformed body is
            # the caller's fault, not a handler crash.
            self._json(400, {"type": "error", "message": str(e)})
            return
        # The trace-context header: the router (or any upstream) minted
        # the id; this replica propagates it through the engine so its
        # whole lifecycle is recorded under the fleet-wide id. Absent
        # OR invalid header (hostile/binary bytes must not ride into
        # span fields) = direct traffic; the engine falls back to the
        # local request id.
        trace_id = self.headers.get(TRACE_HEADER)
        if not valid_trace_id(trace_id):
            trace_id = None
        try:
            done = self.serve.generate(tokens, trace_id=trace_id, **opts)
        except ValueError as e:  # engine validation: caller's fault
            self._json(400, {"type": "error", "message": str(e)})
            return
        except TimeoutError as e:
            # Per-request timeout, NOT engine death: 504 so the router
            # can tell "slow" from "dead" — a 503 here would eject this
            # replica and re-run the same long generation on its peers
            # (serve/router.py's eject-storm contract).
            self._json(504, {"type": "error", "message": str(e)})
            return
        except RuntimeError as e:  # engine-loop death: liveness event
            self._json(503, {"type": "error", "message": str(e)})
            return
        self._json(200, _finished_body(done))

    # ------------------------------------------------------- migration
    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _json_body(self) -> Dict[str, Any]:
        d = json.loads(self._read_body() or b"{}")
        if not isinstance(d, dict):
            raise ValueError("body must be a JSON object")
        return d

    def _migrate_out(self) -> None:
        try:
            d = self._json_body()
            rid = str(d["request_id"])
            dest = str(d["dest"])
            reason = str(d.get("reason", "handoff"))
        except (ValueError, KeyError, TypeError) as e:
            self._json(400, {"type": "error", "message": str(e)})
            return
        try:
            body = self.serve.migrate_out(rid, dest, reason)
        except MigrationError as e:  # no such session / not exportable
            self._json(404, {"type": "error", "message": str(e)})
            return
        except (TimeoutError, RuntimeError) as e:
            self._json(503, {"type": "error", "message": str(e)})
            return
        if "error" in body:
            # Transfer failed: the session was resumed locally and the
            # source keeps serving it un-degraded. 502 tells the caller
            # the DESTINATION (not this replica) refused the bytes.
            self._json(502, body)
            return
        self._json(200, body)

    def _migrate_in(self) -> None:
        payload = self._read_body()
        reason = self.headers.get("X-TK8S-Migrate-Reason") or "handoff"
        try:
            body = self.serve.migrate_in(payload, reason)
        except TornPayloadError as e:
            self._json(400, {"type": "error", "torn": True,
                             "message": str(e)})
            return
        except MigrationError as e:  # incompatible / pool pressure
            self._json(409, {"type": "error", "torn": False,
                             "message": str(e)})
            return
        except (TimeoutError, RuntimeError) as e:
            self._json(503, {"type": "error", "message": str(e)})
            return
        self._json(200, body)

    def _await(self) -> None:
        try:
            rid = str(self._json_body()["request_id"])
        except (ValueError, KeyError, TypeError) as e:
            self._json(400, {"type": "error", "message": str(e)})
            return
        waiter = self.serve.imported_waiter(rid)
        if waiter is None:
            self._json(404, {"type": "error",
                             "message": f"no imported session {rid!r}"})
            return
        if not waiter.event.wait(self.serve.request_timeout_s):
            self._json(504, {"type": "error",
                             "message": f"{rid}: still decoding after "
                             f"{self.serve.request_timeout_s}s"})
            return
        if waiter.fatal or waiter.error is not None:
            self._json(503 if waiter.fatal else 400,
                       {"type": "error", "message": waiter.error})
            return
        assert waiter.result is not None
        self.serve.forget_imported(rid)
        self._json(200, _finished_body(waiter.result))

    def _resume(self) -> None:
        try:
            rid = str(self._json_body()["request_id"])
        except (ValueError, KeyError, TypeError) as e:
            self._json(400, {"type": "error", "message": str(e)})
            return
        try:
            done = self.serve.resume(rid)
        except MigrationError as e:
            self._json(404, {"type": "error", "message": str(e)})
            return
        except TimeoutError as e:
            self._json(504, {"type": "error", "message": str(e)})
            return
        except RuntimeError as e:
            self._json(503, {"type": "error", "message": str(e)})
            return
        self._json(200, _finished_body(done))


def _finished_body(done: FinishedRequest) -> Dict[str, Any]:
    body: Dict[str, Any] = {
        "request_id": done.request_id,
        "tokens": done.tokens,
        "prompt_len": done.prompt_len,
        "finish_reason": done.finish_reason,
        "ttft_s": done.ttft,
        "tpot_s": done.tpot,
        "preemptions": done.preemptions,
    }
    if done.migrated_to is not None:
        body["migrated_to"] = done.migrated_to
        body["dest_request_id"] = done.dest_request_id
    if done.trace_id is not None:
        # The per-phase latency attribution rides the response: the
        # phases sum to e2e_s exactly.
        body["trace_id"] = done.trace_id
        body["phases"] = done.phases
        body["e2e_s"] = done.finished_at - done.submitted_at
        if done.spec is not None:
            body["spec"] = done.spec
    return body


class DcnTransferModel:
    """Deterministic datacenter-network cost model for migration
    transfers.

    Loopback tests and single-host A/Bs ship KV sessions over the
    kernel's loopback at effectively infinite bandwidth, so a
    disaggregated prefill→decode handoff looks free when the real
    deployment pays a cross-rack (or cross-DC) wire for every packed
    page. The model charges ``rtt_s + nbytes / bytes_per_s`` (plus an
    optional seeded uniform jitter in ``[0, jitter_s)``) per transfer,
    slept on the HANDLER thread around the ``/migrate/in`` POST — never
    on the engine loop and never under a lock, so a simulated slow wire
    stalls only that transfer, exactly like a real one.

    The sleeper is injectable: tests
    assert latency *accounting* against a recorder instead of
    wall-clock thresholds that flake under load. The jitter RNG is
    seeded and private, so a fixed seed yields the same latency
    sequence run-to-run — chaos timelines that include migrations stay
    reproducible. ``to_dict``/``from_dict`` round-trip the model (sans
    sleeper) so a scenario spec can carry it."""

    def __init__(self, bytes_per_s: float = 0.0, rtt_s: float = 0.0,
                 jitter_s: float = 0.0, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        if bytes_per_s < 0 or rtt_s < 0 or jitter_s < 0:
            raise ValueError(
                f"DCN model parameters must be >= 0 (bytes_per_s="
                f"{bytes_per_s}, rtt_s={rtt_s}, jitter_s={jitter_s})")
        self.bytes_per_s = float(bytes_per_s)
        self.rtt_s = float(rtt_s)
        self.jitter_s = float(jitter_s)
        self.seed = int(seed)
        self._sleep = sleep
        self._rng = random.Random(self.seed)
        # Concurrent handler threads share the RNG; the lock keeps the
        # draw sequence deterministic per (seed, transfer index).
        self._rng_lock = threading.Lock()

    def transfer_s(self, nbytes: int) -> float:
        """Modeled seconds for one ``nbytes`` payload (draws jitter)."""
        s = self.rtt_s
        if self.bytes_per_s > 0:
            s += nbytes / self.bytes_per_s
        if self.jitter_s > 0:
            with self._rng_lock:
                s += self._rng.uniform(0.0, self.jitter_s)
        return s

    def apply(self, nbytes: int) -> float:
        """Charge one transfer: sleep the modeled latency (on the
        calling thread) and return it."""
        latency = self.transfer_s(int(nbytes))
        if latency > 0:
            self._sleep(latency)
        return latency

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.bytes_per_s:
            out["bytes_per_s"] = self.bytes_per_s
        if self.rtt_s:
            out["rtt_s"] = self.rtt_s
        if self.jitter_s:
            out["jitter_s"] = self.jitter_s
            out["seed"] = self.seed
        return out

    @classmethod
    def from_dict(cls, spec: Dict[str, Any],
                  sleep: Callable[[float], None] = time.sleep,
                  ) -> "DcnTransferModel":
        return cls(bytes_per_s=spec.get("bytes_per_s", 0.0),
                   rtt_s=spec.get("rtt_s", 0.0),
                   jitter_s=spec.get("jitter_s", 0.0),
                   seed=spec.get("seed", 0), sleep=sleep)


class ServeHTTPServer:
    """Embeddable serving endpoint:
    ``with ServeHTTPServer(engine) as url: ...`` in tests;
    ``serve_forever`` under the serve entry point."""

    def __init__(self, engine: ServeEngine, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 120.0,
                 tracing: bool = True,
                 dcn: Optional[DcnTransferModel] = None):
        self.engine = engine
        if tracing and engine.flight is None:
            # Served engines trace by default (a bounded in-memory
            # recorder; JSONL export only when the caller attached a
            # writer): /generate then always carries the phase
            # breakdown. tracing=False is the overhead-A/B off arm.
            engine.flight = FlightRecorder()
        self.request_timeout_s = request_timeout_s
        # Optional simulated DCN cost charged per outbound migration
        # payload (handler thread, around the /migrate/in POST).
        self.dcn = dcn
        self._inbox: "queue.Queue[Tuple[Request, _Waiter]]" = queue.Queue()
        self._waiters: Dict[str, _Waiter] = {}
        # Migration control closures for the engine loop, and the
        # waiters /await blocks on for imported sessions (resolved by
        # the loop's ordinary finish resolution, like any request).
        self._ops: "queue.Queue[Tuple[Callable[[], Any], _OpResult]]" = (
            queue.Queue())
        self._imported: Dict[str, _Waiter] = {}
        self._id_lock = threading.Lock()
        self._next_id = 0
        self._stop = threading.Event()
        self._loop_error: Optional[str] = None
        handler = type("Handler", (_Handler,), {"serve": self})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._engine_thread: Optional[threading.Thread] = None
        self._http_thread: Optional[threading.Thread] = None

    # ----------------------------------------------------- handler side
    def _mint_id(self, prefix: str = "req") -> str:
        with self._id_lock:
            rid = f"{prefix}-{self._next_id}"
            self._next_id += 1
        return rid

    def generate(self, tokens, **opts) -> FinishedRequest:
        rid = self._mint_id()
        request = Request(request_id=rid, tokens=list(tokens), **{
            "max_new_tokens": opts.get("max_new_tokens", 16),
            "temperature": opts.get("temperature", 0.0),
            "top_k": opts.get("top_k", 0),
            "top_p": opts.get("top_p", 1.0),
            "eos_id": opts.get("eos_id"),
            "seed": opts.get("seed", 0),
            "trace_id": opts.get("trace_id"),
            "handoff": opts.get("handoff", False),
        })
        # Fail fast off-loop; the loop's own submit re-validates.
        self.engine.validate_request(request)
        if self._loop_error is not None:
            raise RuntimeError(f"engine loop died: {self._loop_error}")
        waiter = _Waiter()
        self._inbox.put((request, waiter))
        if not waiter.event.wait(self.request_timeout_s):
            if self._loop_error is not None:
                raise RuntimeError(
                    f"engine loop died: {self._loop_error}")
            raise TimeoutError(
                f"{rid}: no completion within {self.request_timeout_s}s")
        if waiter.fatal:
            raise RuntimeError(waiter.error or "engine loop died")
        if waiter.error is not None:
            raise ValueError(waiter.error)
        assert waiter.result is not None
        return waiter.result

    @property
    def loop_error(self) -> Optional[str]:
        """Why the engine loop died, or None while it is healthy."""
        return self._loop_error

    # ------------------------------------------------------- migration
    def _op(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` on the engine-loop thread (the engine's single
        owner) and return its result, re-raising its exception here so
        typed MigrationErrors keep their meaning across the marshal."""
        if self._loop_error is not None:
            raise RuntimeError(f"engine loop died: {self._loop_error}")
        box = _OpResult()
        self._ops.put((fn, box))
        if not box.event.wait(self.request_timeout_s):
            if self._loop_error is not None:
                raise RuntimeError(
                    f"engine loop died: {self._loop_error}")
            raise TimeoutError(
                f"engine loop did not service the migration op within "
                f"{self.request_timeout_s}s")
        if box.exc is not None:
            raise box.exc
        return box.value

    def migrate_out(self, request_id: str, dest: str,
                    reason: str) -> Dict[str, Any]:
        """Pack → ship → release (or resume). The engine calls run on
        the loop; the outbound POST of the already-packed bytes runs on
        THIS handler thread with no lock held — a slow or dead
        destination stalls only this transfer, never the scheduler."""
        def _export() -> Tuple[bytes, Optional[str]]:
            blob = self.engine.export_session(request_id, reason)
            return blob, self.engine.parked[request_id].request.trace_id

        blob, trace_id = self._op(_export)
        headers = {"Content-Type": "application/octet-stream",
                   "X-TK8S-Migrate-Reason": reason}
        if trace_id is not None:
            headers[TRACE_HEADER] = trace_id
        req = urllib.request.Request(
            dest.rstrip("/") + "/migrate/in", data=blob,
            headers=headers, method="POST")
        dest_rid, err = None, None
        ship_started = time.monotonic()
        if self.dcn is not None:
            # The simulated wire cost of shipping len(blob) — charged
            # here on the handler thread (the same thread the real POST
            # blocks), so concurrent migrations overlap their latency
            # and the engine loop never notices.
            self.dcn.apply(len(blob))
        try:
            with urllib.request.urlopen(
                    req, timeout=self.request_timeout_s) as resp:
                dest_rid = json.loads(resp.read()).get("request_id")
        except urllib.error.HTTPError as e:
            try:
                detail = e.read().decode("utf-8", "replace")[:200]
            except Exception:
                detail = ""
            err = f"destination refused import: HTTP {e.code} {detail}"
        except (urllib.error.URLError, OSError, ValueError) as e:
            err = f"transfer failed: {e}"
        if err is not None:
            metrics.counter("tk8s_serve_migrations_total").inc(
                direction="out", reason=reason, status="error",
                exemplar=trace_id)
            resumed = self._op(lambda: self._recover(request_id))
            return {"type": "error", "error": err,
                    "request_id": request_id, "resumed": resumed}
        metrics.histogram("tk8s_serve_migration_transfer_seconds").observe(
            time.monotonic() - ship_started, exemplar=trace_id)

        def _release() -> int:
            done = self.engine.release_session(request_id)
            if done is not None:
                # Drain/rebalance: the original /generate client is
                # still blocked — it gets finish_reason "migrated"
                # plus the forwarding address, so the router can
                # follow the session and return the full stream.
                done.migrated_to = dest.rstrip("/")
                done.dest_request_id = dest_rid
                waiter = self._waiters.pop(request_id, None)
                if waiter is not None:
                    waiter.result = done
                    waiter.event.set()
            return len(blob)

        self._op(_release)
        return {"request_id": request_id, "dest_request_id": dest_rid,
                "bytes": len(blob)}

    def _recover(self, request_id: str) -> bool:
        """Loop-side failure recovery: a drained session resumes at
        once (its original client is still waiting); a handed-off one
        — whose client was already answered — stays parked for an
        explicit /resume, which is where its remaining tokens land."""
        seq = self.engine.parked.get(request_id)
        if seq is None:
            return False
        if seq.handed_off:
            return False
        self.engine.resume_session(request_id)
        return True

    def migrate_in(self, payload: bytes, reason: str) -> Dict[str, Any]:
        """Install a shipped session under a locally-minted id and
        register the waiter /await blocks on."""
        rid = self._mint_id("mig")
        waiter = _Waiter()

        def _import() -> None:
            self.engine.import_session(payload, request_id=rid,
                                       reason=reason)
            self._waiters[rid] = waiter
            self._imported[rid] = waiter

        self._op(_import)
        return {"request_id": rid, "bytes": len(payload)}

    def imported_waiter(self, request_id: str) -> Optional[_Waiter]:
        return self._imported.get(request_id)

    def forget_imported(self, request_id: str) -> None:
        self._imported.pop(request_id, None)

    def resume(self, request_id: str) -> FinishedRequest:
        """Un-park a handed-off session and block until it finishes
        HERE — the failed-transfer fallback: the caller (router) gets
        the same /generate-shaped completion the destination would
        have produced."""
        waiter = _Waiter()

        def _go() -> None:
            if request_id in self._waiters:
                raise MigrationError(
                    f"session {request_id!r} has a live client and "
                    f"resumes automatically")
            self.engine.resume_session(request_id)
            self._waiters[request_id] = waiter

        self._op(_go)
        if not waiter.event.wait(self.request_timeout_s):
            raise TimeoutError(
                f"{request_id}: no completion within "
                f"{self.request_timeout_s}s of resume")
        if waiter.fatal:
            raise RuntimeError(waiter.error or "engine loop died")
        if waiter.error is not None:
            raise MigrationError(waiter.error)
        assert waiter.result is not None
        return waiter.result

    # ------------------------------------------------------- engine loop
    def _loop(self) -> None:
        try:
            require_default_stream(self.engine.device)
            while not self._stop.is_set():
                # Drain the inbox; block briefly only when idle so
                # shutdown and new arrivals are both prompt.
                try:
                    item = self._inbox.get(
                        timeout=0.0 if self.engine.has_work else 0.05)
                except queue.Empty:
                    item = None
                while item is not None:
                    request, waiter = item
                    try:
                        self.engine.submit(request)
                        self._waiters[request.request_id] = waiter
                    except ValueError as e:
                        waiter.error = str(e)
                        waiter.event.set()
                    try:
                        item = self._inbox.get_nowait()
                    except queue.Empty:
                        item = None
                # Migration control ops run between steps, on the
                # engine's owning thread — export/import/release never
                # race a tick.
                while True:
                    try:
                        fn, box = self._ops.get_nowait()
                    except queue.Empty:
                        break
                    try:
                        box.value = fn()
                    except Exception as e:
                        box.exc = e
                    box.event.set()
                if self.engine.has_work:
                    for done in self.engine.step():
                        waiter = self._waiters.pop(done.request_id, None)
                        if waiter is not None:
                            waiter.result = done
                            waiter.event.set()
        except BaseException as e:  # loop death is a liveness event
            self._loop_error = f"{type(e).__name__}: {e}"
            # Recorded, not re-raised: /healthz now fails (the manifest's
            # liveness probe restarts the pod) and every blocked or
            # future client gets a 503 instead of a silent 200 zombie.
            self._fail_pending()
            # Flush the flight recorder LAST: the killed requests'
            # partial lifecycles survive as post-mortem traces (and as
            # already-flushed JSONL lines) even though their clients
            # only ever saw a 503.
            try:
                self.engine.abort_inflight(self._loop_error)
            except Exception:
                pass  # post-mortem best effort: the 503 path already ran

    def _fail_pending(self) -> None:
        """Release every blocked client as 503 instead of a 120s hang:
        in-flight waiters, then anything still queued in the inbox."""
        msg = f"engine loop died: {self._loop_error}"
        for waiter in list(self._waiters.values()):
            waiter.error, waiter.fatal = msg, True
            waiter.event.set()
        self._waiters.clear()
        while True:
            try:
                _, waiter = self._inbox.get_nowait()
            except queue.Empty:
                break
            waiter.error, waiter.fatal = msg, True
            waiter.event.set()
        while True:
            try:
                _, box = self._ops.get_nowait()
            except queue.Empty:
                break
            box.exc = RuntimeError(msg)
            box.event.set()

    # ---------------------------------------------------------- lifecycle
    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "ServeHTTPServer":
        self._engine_thread = threading.Thread(target=self._loop,
                                               daemon=True)
        self._engine_thread.start()
        self._http_thread = threading.Thread(
            target=lambda: self.httpd.serve_forever(poll_interval=0.05),
            daemon=True)
        self._http_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        for t in (self._engine_thread, self._http_thread):
            if t is not None:
                t.join(timeout=5)

    def serve_forever(self) -> None:
        """Foreground mode (the serve entry point): engine loop on its own
        thread, HTTP on the caller's thread."""
        self._engine_thread = threading.Thread(target=self._loop,
                                               daemon=True)
        self._engine_thread.start()
        try:
            self.httpd.serve_forever()
        finally:
            self._stop.set()

    def __enter__(self) -> "ServeHTTPServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
