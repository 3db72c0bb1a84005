"""Session-affine router in front of N serving replicas -- the port of
``triton_kubernetes_tpu/serve/router.py`` (the reference's ``tk8s route``;
here ``python -m triton_kubernetes_tpu_torch.tools.route``). It speaks HTTP
only and imports no torch, so it runs on a box with no accelerator stack.

The fleet layer of the serving stack:
one stable VIP fronting N :class:`~.server.ServeHTTPServer` replicas,
with three policies stacked in order:

1. **Consistent-hash session affinity.** A request's routing key is its
   ``session_id`` (multi-turn chat), falling back to a hash of its
   prompt tokens — so follow-up turns, and independent requests sharing
   a prompt, land on the replica already holding their KV pages in its
   radix prefix cache. The hash ring carries ``virtual_nodes`` points
   per replica, so adding/removing a replica remaps only ~1/N of keys
   (the classic consistent-hashing contract) instead of reshuffling
   every session's warm cache.
2. **Least-loaded spill.** Affinity is a preference, not a prison: when
   the affine replica already has ``spill_threshold`` router-tracked
   requests in flight, the request spills to the least-loaded healthy
   replica — it pays a cold prefill there rather than queueing behind a
   hot spot.
3. **Health-aware ejection.** A replica answering 503 (the engine-loop-
   death semantics of ``serve/server.py``) or refusing
   connections is ejected from rotation and its request retried on the
   next healthy choice — generation is deterministic and idempotent
   (seeded per-request sampling), so a re-landed request reproduces the
   exact tokens the dead replica would have produced. A background
   probe loop re-admits replicas whose ``/healthz`` recovers. A
   *per-request timeout* is NOT death: a slow replica is still holding
   the generation and its sessions' warm KV, so the caller gets a 504
   and the replica stays in rotation — ejecting on timeout would both
   drop every session's affinity and re-run the same long generation on
   a fresh replica (duplicate compute, cascading into a fleet-wide
   eject storm under a burst of long prompts).

4. **Disaggregated prefill/decode pools** (``decode_urls``): the
   replicas above become the prefill pool, every /generate rides in
   with ``handoff=True``, and the finished prefill's parked KV pages
   migrate (serve/migration.py wire unit) to a consistent-hashed
   decode replica that produces the token tail. Failures degrade,
   never drop: a refused transfer retries the next decode replica,
   then the source resumes and finishes colocated-style; a decode
   replica dying AFTER the import re-lands the whole request via
   deterministic recompute. ``drain_replica`` empties a live replica
   by shipping its sessions to pool peers — the migration half of the
   drain A/B (dead replicas still re-land via recompute).

Metrics: ``tk8s_route_requests_total{replica, reason=affine|spill|
eject|handoff}`` and ``tk8s_route_replica_healthy{replica}`` — the
scrape surface the autoscaler watches.

Threading shape: handler threads are independent (no single-owner
engine here); shared state (health flags, in-flight counts) sits behind
one lock, and no network call or sleep ever happens under it.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from http.server import ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlparse

from ..utils import metrics
from ..utils.trace import TRACE_HEADER, TraceWriter, mint_trace_id, \
    valid_trace_id
from ._http import JSONHandler


def _digest(key: str) -> int:
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring over replica names with virtual nodes."""

    def __init__(self, replicas: Sequence[str], virtual_nodes: int = 64):
        if not replicas:
            raise ValueError("need at least one replica")
        if virtual_nodes < 1:
            raise ValueError(
                f"virtual_nodes must be >= 1, got {virtual_nodes}")
        points: List[Tuple[int, str]] = []
        for name in replicas:
            for v in range(virtual_nodes):
                points.append((_digest(f"{name}#{v}"), name))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._names = [n for _, n in points]

    def owner(self, key: str, exclude: frozenset = frozenset()) -> str:
        """First replica clockwise from ``key``'s point, skipping
        ``exclude``; raises if every replica is excluded."""
        start = bisect.bisect(self._hashes, _digest(key))
        n = len(self._names)
        for step in range(n):
            name = self._names[(start + step) % n]
            if name not in exclude:
                return name
        raise LookupError("no replica available (all excluded)")


@dataclass
class ReplicaState:
    name: str
    url: str
    healthy: bool = True
    # Router-tracked OPEN PROXIED CONNECTIONS, by design: a timed-out
    # attempt decrements even though the replica may still be chewing on
    # it (the router cannot observe replica-side completion without its
    # cooperation). `timeouts` makes that blind spot visible in /stats;
    # replica-side queue depth is scrapeable from each replica's own
    # /stats for load decisions that need the truth.
    in_flight: int = 0
    requests: int = 0
    timeouts: int = 0


class Router:
    """Routing core, HTTP-free so tests drive it directly: pick a
    replica for a payload, forward with eject-and-retry, track health."""

    def __init__(
        self,
        replica_urls: Sequence[str],
        *,
        decode_urls: Optional[Sequence[str]] = None,
        spill_threshold: int = 4,
        virtual_nodes: int = 64,
        request_timeout_s: float = 120.0,
        health_timeout_s: float = 2.0,
        trace_seed: int = 0,
        trace: Optional[TraceWriter] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not replica_urls:
            raise ValueError("need at least one replica URL")
        if spill_threshold < 1:
            raise ValueError(
                f"spill_threshold must be >= 1, got {spill_threshold}")
        self.request_timeout_s = request_timeout_s
        self.health_timeout_s = health_timeout_s
        self.spill_threshold = spill_threshold
        # Trace minting: the router is where a fleet-wide trace id is
        # born (requests that arrive already carrying X-TK8S-Trace keep
        # theirs). Seeded so a replayed schedule mints the identical
        # ids; `trace` (a TraceWriter) additionally records each
        # placement as a route.place span on the merged timeline.
        self._trace_rng = random.Random(trace_seed)
        self.trace = trace
        self.clock = clock
        # Optional goodput ledger (GoodputRecorder, source="route"):
        # attach after construction, as on ServeEngine. Handler threads
        # overlap, so forward() uses the recorder's depth-counted
        # enter/exit edges — only the 0->1 and 1->0 crossings transition
        # between forward and idle, keeping the partition exact under
        # concurrency (the recorder carries its own lock).
        self.goodput: Optional[Any] = None
        self._lock = threading.Lock()
        # Requests currently inside forward(), keyed by a monotonic
        # ticket so concurrent requests sharing a trace id stay
        # distinct. abort_inflight() flushes these as route.abort
        # terminals when the router dies with requests mid-flight.
        self._inflight: Dict[int, str] = {}
        self._inflight_seq = 0
        self.replicas: Dict[str, ReplicaState] = {}
        for i, url in enumerate(replica_urls):
            name = f"r{i}"
            self.replicas[name] = ReplicaState(name=name,
                                               url=url.rstrip("/"))
        self.ring = HashRing(sorted(self.replicas), virtual_nodes)
        # Disaggregated mode: with a decode pool attached, the replicas
        # above become the PREFILL pool — /generate lands there with
        # handoff=True, and the finished prefill migrates to a decode
        # replica (its own affinity ring, named d0..dN) for the long
        # token-by-token tail. Empty decode pool = classic colocated
        # serving, byte-for-byte the old router.
        self.decode_replicas: Dict[str, ReplicaState] = {}
        for i, url in enumerate(decode_urls or ()):
            name = f"d{i}"
            self.decode_replicas[name] = ReplicaState(name=name,
                                                      url=url.rstrip("/"))
        self.decode_ring = (HashRing(sorted(self.decode_replicas),
                                     virtual_nodes)
                            if self.decode_replicas else None)
        for name in list(self.replicas) + list(self.decode_replicas):
            metrics.gauge("tk8s_route_replica_healthy").set(1, replica=name)

    # ------------------------------------------------------------ policy
    @staticmethod
    def route_key(payload: Dict[str, Any]) -> str:
        """The affinity key: the session when there is one, else the
        prompt itself — identical prompts then share a replica's radix
        cache instead of warming N copies of it."""
        sid = payload.get("session_id")
        if isinstance(sid, str) and sid:
            return f"session:{sid}"
        tokens = payload.get("tokens") or []
        return "tokens:" + hashlib.sha256(
            json.dumps(tokens).encode()).hexdigest()

    def pick(self, key: str,
             exclude: frozenset = frozenset()) -> Tuple[ReplicaState, str]:
        """(replica, reason) for one attempt. ``exclude`` carries the
        replicas this request already saw fail — routing away from the
        affine owner because it is excluded or unhealthy is an "eject",
        away because it is overloaded a "spill"."""
        with self._lock:
            down = frozenset(n for n, r in self.replicas.items()
                             if not r.healthy) | exclude
            candidates = [r for n, r in sorted(self.replicas.items())
                          if n not in down]
            if not candidates:
                raise LookupError("no healthy replica")
            owner_name = self.ring.owner(key)
            owner = self.replicas[owner_name]
            if owner_name in down:
                # Affine home is gone: consistent-hash to the next live
                # point so the session still has ONE stable fallback.
                return self.replicas[self.ring.owner(key, down)], "eject"
            if owner.in_flight >= self.spill_threshold:
                least = min(candidates, key=lambda r: (r.in_flight, r.name))
                # Spill only on a STRICT improvement: moving to an
                # equally loaded replica pays a cold prefill to stand in
                # an identical queue — worse than staying affine.
                if least.in_flight < owner.in_flight:
                    return least, "spill"
            return owner, "affine"

    # ----------------------------------------------------------- forward
    def forward(self, payload: Dict[str, Any],
                trace_id: Optional[str] = None,
                ) -> Tuple[int, Dict[str, Any]]:
        """Route one /generate payload: returns (status, body). Retries
        on a fresh replica after a connection failure or 503, marking
        the failed one unhealthy; client errors (4xx) pass through —
        they would fail identically anywhere; a per-attempt timeout is
        a 504 to the caller, never an ejection (the slow replica is
        still computing — see the module docstring).

        ``trace_id`` is the fleet-wide correlation id: the caller's
        (from the X-TK8S-Trace header) when present, freshly minted
        here otherwise. It is forwarded to the replica in the same
        header, recorded on every route.place span with the placement
        reason, and echoed in the response body."""
        if trace_id is None:
            with self._lock:
                trace_id = mint_trace_id(self._trace_rng)
        with self._lock:
            self._inflight_seq += 1
            ticket = self._inflight_seq
            self._inflight[ticket] = trace_id
        if self.goodput is not None:
            self.goodput.enter("forward")
        try:
            return self._forward(payload, trace_id)
        finally:
            with self._lock:
                self._inflight.pop(ticket, None)
            if self.goodput is not None:
                self.goodput.exit_idle()

    def _forward(self, payload: Dict[str, Any], trace_id: str,
                 ) -> Tuple[int, Dict[str, Any]]:
        key = self.route_key(payload)
        if self.decode_ring is not None:
            # Disaggregated: the prefill pool answers with the first
            # token and parks the KV pages for the migration that
            # _handoff orchestrates next.
            payload = dict(payload, handoff=True)
        body = json.dumps(payload).encode()
        tried: set = set()
        last: Tuple[int, Dict[str, Any]] = (503, {
            "type": "error", "message": "no healthy replica"})
        for _ in range(len(self.replicas)):
            try:
                replica, reason = self.pick(key, frozenset(tried))
            except LookupError as e:
                self._abort(trace_id, 503, str(e))
                return 503, {"type": "error", "message": str(e)}
            tried.add(replica.name)
            with self._lock:
                replica.in_flight += 1
                replica.requests += 1
            t0 = self.clock()
            try:
                status, out = self._post(replica.url + "/generate", body,
                                         trace_id)
            finally:
                with self._lock:
                    replica.in_flight -= 1
            if self.trace is not None:
                self.trace.event("route.place", t0, self.clock() - t0,
                                 trace=trace_id, replica=replica.name,
                                 reason=reason, status=status)
            if status == 503 or status == -1:
                # Failed attempts are not placements: the counter only
                # ever records requests a replica actually served.
                self._set_health(replica.name, False)
                last = (503, out if status == 503 else {
                    "type": "error",
                    "message": f"replica {replica.name} unreachable"})
                continue
            if status == -2 or status == 504:
                # A timeout — ours (-2) or the replica's own 504 — is
                # not death and not a placement: the replica is still
                # computing but never answered. Counting it would make
                # a drowning replica look well-served to the
                # autoscaler's scrape; ejecting it would re-run the
                # same long generation fleet-wide.
                with self._lock:
                    replica.timeouts += 1
                self._abort(trace_id, 504, "attempt timed out")
                return 504, out
            if not 200 <= status < 300:
                # 4xx pass-through: the replica rejected the request
                # before the engine ever saw it, so no serve.finish
                # will exist anywhere — terminate the placement here.
                self._abort(trace_id, status,
                            str(out.get("message", "client error"))
                            if isinstance(out, dict) else "client error")
                return status, out
            metrics.counter("tk8s_route_requests_total").inc(
                replica=replica.name, reason=reason)
            if isinstance(out, dict):
                out = dict(out, replica=replica.name, trace_id=trace_id)
            if (self.decode_ring is not None and isinstance(out, dict)
                    and out.get("finish_reason") == "handoff"):
                return self._handoff(key, payload, replica, out, trace_id)
            # A drained/rebalanced session answered "migrated" with a
            # forwarding address: follow it so the client still gets
            # the complete stream (bounded — a session can hop again).
            hops = 0
            while (isinstance(out, dict)
                   and out.get("finish_reason") == "migrated"
                   and out.get("migrated_to") and hops < 4):
                hops += 1
                astat, after = self._post_json(
                    str(out["migrated_to"]) + "/await",
                    {"request_id": out.get("dest_request_id")}, trace_id)
                if not (200 <= astat < 300 and isinstance(after, dict)):
                    break  # degrade: partial body, reason "migrated"
                out = dict(after, ttft_s=out.get("ttft_s"),
                           replica=replica.name, trace_id=trace_id)
            return status, out
        self._abort(trace_id, last[0], "every replica failed")
        return last

    # ------------------------------------------------- disaggregation
    def decode_pressure(self, exclude: frozenset = frozenset()
                        ) -> Dict[str, float]:
        """Windowed KV pressure per healthy decode replica, read from
        each replica's ``/stats`` (the engine's ``kv_pressure`` field: a
        windowed max of pool utilization, deterministic in its tick
        sequence). A replica whose ``/stats`` is unreachable or missing
        the field reports ``inf`` — still placeable, but only after
        every replica that answered (the handoff ladder's degrade-never-
        drop rule). All network happens OUTSIDE the router lock; the
        snapshot is taken under it."""
        with self._lock:
            candidates = [(n, r.url)
                          for n, r in sorted(self.decode_replicas.items())
                          if r.healthy and n not in exclude]
        pressure: Dict[str, float] = {}
        for name, url in candidates:
            status, st = self._get_json(url + "/stats")
            p = st.get("kv_pressure") if isinstance(st, dict) else None
            pressure[name] = (float(p)
                              if status == 200 and isinstance(p, (int, float))
                              else float("inf"))
        return pressure

    def pick_decode(self, key: str,
                    exclude: frozenset = frozenset()) -> ReplicaState:
        """The decode-pool target for a session key: LEAST windowed KV
        pressure (:meth:`decode_pressure`) — a handoff lands where its
        pages will contend least, instead of wherever the failure
        round-robin happened to stop. Ties (the common all-idle case)
        break FIRST to the consistent-hash owner — repeat turns of a
        session still land their migrations on the SAME decode replica,
        whose prefix cache absorbs the shipped pages by refcount
        instead of copy — then by name, so the pick is deterministic
        for any fixed set of ``/stats`` answers (pinned in
        tests/test_router.py)."""
        with self._lock:
            down = frozenset(n for n, r in self.decode_replicas.items()
                             if not r.healthy) | exclude
            if len(down) >= len(self.decode_replicas):
                raise LookupError("no healthy decode replica")
            affinity = self.decode_ring.owner(key, down)
        pressure = self.decode_pressure(exclude=down)
        if not pressure:
            raise LookupError("no healthy decode replica")
        best = min(pressure,
                   key=lambda n: (pressure[n], n != affinity, n))
        with self._lock:
            return self.decode_replicas[best]

    def _handoff(self, key: str, payload: Dict[str, Any],
                 source: ReplicaState, out: Dict[str, Any],
                 trace_id: str) -> Tuple[int, Dict[str, Any]]:
        """The ship half of prefill→decode: migrate the parked session
        to a decode replica and block on its completion. Every failure
        degrades, never drops: a refused transfer retries on the next
        decode replica; with none left the SOURCE resumes the session
        and finishes it colocated-style (slower, still correct)."""
        rid = out["request_id"]
        tried: set = set()
        for _ in range(len(self.decode_replicas)):
            try:
                dest = self.pick_decode(key, frozenset(tried))
            except LookupError:
                break
            tried.add(dest.name)
            with self._lock:
                dest.in_flight += 1
                dest.requests += 1
            t0 = self.clock()
            astat, body = 0, {}
            try:
                status, mig = self._post_json(
                    source.url + "/migrate/out",
                    {"request_id": rid, "dest": dest.url,
                     "reason": "handoff"}, trace_id)
                dest_rid = (mig.get("dest_request_id")
                            if isinstance(mig, dict) else None)
                if status == 200 and dest_rid:
                    astat, body = self._post_json(
                        dest.url + "/await",
                        {"request_id": dest_rid}, trace_id)
            finally:
                with self._lock:
                    dest.in_flight -= 1
            if self.trace is not None:
                self.trace.event("route.place", t0, self.clock() - t0,
                                 trace=trace_id, replica=dest.name,
                                 reason="handoff", status=status)
            if status != 200:
                # The transfer never committed (torn payload, dest
                # refused, dest down): the source still owns the parked
                # session. Mark an unreachable dest unhealthy and try
                # the next one.
                if status == -1:
                    self._set_health(dest.name, False)
                continue
            if 200 <= astat < 300 and isinstance(body, dict):
                metrics.counter("tk8s_route_requests_total").inc(
                    replica=dest.name, reason="handoff")
                # The decode body carries the FULL token stream (the
                # source's first token rode along in the wire unit);
                # TTFT is the prefill pool's — the client saw its first
                # token before the migration even started.
                return 200, dict(body, ttft_s=out.get("ttft_s"),
                                 replica=source.name,
                                 decode_replica=dest.name,
                                 trace_id=trace_id)
            # Committed but the decode never completed (dest died after
            # import): the source released the pages, so re-land via
            # RECOMPUTE — deterministic sampling reproduces the exact
            # stream from scratch.
            self._set_health(dest.name, False)
            status, body = self._post_json(
                source.url + "/generate",
                dict(payload, handoff=False), trace_id)
            if 200 <= status < 300 and isinstance(body, dict):
                return status, dict(body, replica=source.name,
                                    trace_id=trace_id)
            self._abort(trace_id, status, "recompute re-land failed")
            return status, body
        # No decode replica took the session: finish on the source.
        status, body = self._post_json(source.url + "/resume",
                                       {"request_id": rid}, trace_id)
        if 200 <= status < 300 and isinstance(body, dict):
            return status, dict(body, replica=source.name,
                                trace_id=trace_id)
        self._abort(trace_id, status,
                    "handoff failed and source could not resume")
        return status, body

    def drain_replica(self, name: str) -> Dict[str, Any]:
        """Drain a LIVE replica by migration instead of recompute: pull
        it from rotation, then ship every exportable session to its
        healthy pool peers (round-robin). The sessions keep decoding on
        their new homes with the prefill chip-seconds already banked —
        the cheaper half of a drain (recompute is the other). Dead
        replicas still re-land via recompute (there is nothing left to
        export)."""
        with self._lock:
            pool = (self.decode_replicas if name in self.decode_replicas
                    else self.replicas)
            if name not in pool:
                raise LookupError(f"unknown replica {name!r}")
            source = pool[name]
            peers = [r for n, r in sorted(pool.items())
                     if n != name and r.healthy]
        if not peers:
            raise LookupError(
                f"no healthy migration target for {name!r}")
        self._set_health(name, False)
        status, st = self._get_json(source.url + "/stats")
        if status != 200 or not isinstance(st, dict):
            return {"replica": name, "migrated": [], "failed": [],
                    "error": f"source /stats unavailable ({status})"}
        migrated: List[str] = []
        failed: List[str] = []
        for i, rid in enumerate(st.get("sessions", [])):
            dest = peers[i % len(peers)]
            mstat, _ = self._post_json(
                source.url + "/migrate/out",
                {"request_id": rid, "dest": dest.url,
                 "reason": "drain"}, None)
            (migrated if mstat == 200 else failed).append(rid)
        return {"replica": name, "migrated": migrated, "failed": failed}

    def _post_json(self, url: str, obj: Dict[str, Any],
                   trace_id: Optional[str] = None,
                   ) -> Tuple[int, Dict[str, Any]]:
        return self._post(url, json.dumps(obj).encode(), trace_id)

    def _get_json(self, url: str) -> Tuple[int, Dict[str, Any]]:
        try:
            with urllib.request.urlopen(
                    urllib.request.Request(url),
                    timeout=self.request_timeout_s) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            return e.code, {"type": "error", "message": str(e)}
        except (urllib.error.URLError, OSError, ValueError) as e:
            return -1, {"type": "error", "message": str(e)}

    def _abort(self, trace_id: str, status: int, error: str) -> None:
        """Record the router giving up on a request. route.place spans
        get a terminal child even when no replica produced one — the
        merged-timeline completeness rule ``validate_chaos_trace``
        enforces. Never called under the lock."""
        if self.trace is not None:
            self.trace.event("route.abort", self.clock(), trace=trace_id,
                             status=status, error=error)

    def abort_inflight(self, error: str) -> int:
        """Flush every request still inside :meth:`forward` as a
        ``route.abort`` terminal on the router's trace writer — the
        shutdown/SIGTERM seam. A request blocked on a replica when the
        router dies would otherwise leave a placement span with no
        terminal child in the merged timeline. Returns the number of
        lifecycles flushed."""
        with self._lock:
            pending = sorted(self._inflight.items())
            self._inflight.clear()
        if self.trace is not None:
            at = self.clock()
            for _, tid in pending:
                self.trace.event("route.abort", at, trace=tid, status=0,
                                 error=error)
            self.trace.flush()
        return len(pending)

    def _post(self, url: str, body: bytes, trace_id: Optional[str] = None,
              ) -> Tuple[int, Dict[str, Any]]:
        """(status, parsed body); -1 means unreachable (eject + retry),
        -2 means the attempt timed out on a live replica (504, no
        eject — the generation is still burning compute there)."""
        headers = {"Content-Type": "application/json"}
        if trace_id is not None:
            headers[TRACE_HEADER] = trace_id
        req = urllib.request.Request(url, data=body, headers=headers)
        try:
            with urllib.request.urlopen(
                    req, timeout=self.request_timeout_s) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read() or b"{}")
            except (ValueError, OSError):
                payload = {"type": "error", "message": str(e)}
            return e.code, payload
        except urllib.error.URLError as e:
            if isinstance(getattr(e, "reason", None),
                          (socket.timeout, TimeoutError)):
                return -2, {"type": "error", "message":
                            f"no completion within "
                            f"{self.request_timeout_s}s"}
            return -1, {"type": "error", "message": str(e)}
        except (socket.timeout, TimeoutError):
            return -2, {"type": "error", "message":
                        f"no completion within {self.request_timeout_s}s"}
        except (OSError, ValueError) as e:
            return -1, {"type": "error", "message": str(e)}

    # ------------------------------------------------------------ health
    def _set_health(self, name: str, healthy: bool) -> None:
        with self._lock:
            pool = (self.replicas if name in self.replicas
                    else self.decode_replicas)
            pool[name].healthy = healthy
            # Gauge write INSIDE the lock (it is in-process bookkeeping,
            # not I/O): written outside, two concurrent flips could land
            # their gauge writes in the opposite order of their state
            # writes and strand the scrape surface on the stale value.
            metrics.gauge("tk8s_route_replica_healthy").set(
                1 if healthy else 0, replica=name)

    def probe_once(self) -> None:
        """One /healthz sweep over every replica (no lock held across
        the network): 200 re-admits, anything else ejects."""
        for name, url in [(r.name, r.url)
                          for r in list(self.replicas.values())
                          + list(self.decode_replicas.values())]:
            req = urllib.request.Request(url + "/healthz")
            try:
                with urllib.request.urlopen(
                        req, timeout=self.health_timeout_s) as r:
                    self._set_health(name, r.status == 200)
            except (urllib.error.URLError, OSError):
                self._set_health(name, False)

    @property
    def any_healthy(self) -> bool:
        with self._lock:
            return any(r.healthy for r in self.replicas.values())

    def stats(self) -> Dict[str, Any]:
        def pool(replicas: Dict[str, ReplicaState]) -> Dict[str, Any]:
            return {
                n: {"url": r.url, "healthy": r.healthy,
                    "in_flight": r.in_flight, "requests": r.requests,
                    "timeouts": r.timeouts}
                for n, r in sorted(replicas.items())
            }

        with self._lock:
            out = {
                "spill_threshold": self.spill_threshold,
                "replicas": pool(self.replicas),
            }
            if self.decode_replicas:
                out["decode_replicas"] = pool(self.decode_replicas)
            return out


class _Handler(JSONHandler):
    server_version = "tk8s-route"
    route: "RouterHTTPServer"  # injected by RouterHTTPServer

    def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
        parsed = urlparse(self.path)
        path = parsed.path
        router = self.route.router
        if path == "/healthz":
            # The router is alive iff it can place a request somewhere.
            if router.any_healthy:
                self._json(200, {"ok": True,
                                 "replicas": len(router.replicas)})
            else:
                self._json(503, {"ok": False,
                                 "error": "no healthy replica"})
        elif path == "/metrics":
            self._metrics_response(metrics.get_registry(), parsed.query)
        elif path == "/stats":
            self._json(200, router.stats())
        else:
            self._json(404, {"type": "error", "message": "not found"})

    def do_POST(self) -> None:  # noqa: N802
        path = urlparse(self.path).path
        if path not in ("/generate", "/drain"):
            self._json(404, {"type": "error", "message": "not found"})
            return
        n = int(self.headers.get("Content-Length") or 0)
        try:
            payload = json.loads(self.rfile.read(n) if n else b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:
            self._json(400, {"type": "error", "message": str(e)})
            return
        if path == "/drain":
            try:
                out = self.route.router.drain_replica(
                    str(payload.get("replica", "")))
            except LookupError as e:
                self._json(404, {"type": "error", "message": str(e)})
                return
            self._json(200, out)
            return
        # An invalid header (shape-wise: hostile, truncated, binary) is
        # treated as absent — the router mints a fresh id rather than
        # letting arbitrary bytes ride into span fields and exemplars.
        upstream = self.headers.get(TRACE_HEADER)
        status, out = self.route.router.forward(
            payload,
            trace_id=upstream if valid_trace_id(upstream) else None)
        self._json(status, out)


class RouterHTTPServer:
    """Embeddable router endpoint: ``with RouterHTTPServer(urls) as url``
    in tests; ``serve_forever`` under the route entry point. A daemon probe
    thread sweeps replica health every ``health_interval_s``."""

    def __init__(self, replica_urls: Sequence[str],
                 host: str = "127.0.0.1", port: int = 0,
                 health_interval_s: float = 0.5, **router_kw: Any):
        self.router = Router(replica_urls, **router_kw)
        self.health_interval_s = health_interval_s
        self._stop = threading.Event()
        handler = type("Handler", (_Handler,), {"route": self})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._probe_thread: Optional[threading.Thread] = None
        self._http_thread: Optional[threading.Thread] = None

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            self.router.probe_once()

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "RouterHTTPServer":
        self._probe_thread = threading.Thread(target=self._probe_loop,
                                              daemon=True)
        self._probe_thread.start()
        self._http_thread = threading.Thread(
            target=lambda: self.httpd.serve_forever(poll_interval=0.05),
            daemon=True)
        self._http_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        # Daemon handler threads may still sit inside forward() blocked
        # on a replica: flush their lifecycles as route.abort terminals
        # before the trace writer goes away with the process.
        self.router.abort_inflight("router shutdown")
        for t in (self._probe_thread, self._http_thread):
            if t is not None:
                t.join(timeout=5)

    def serve_forever(self) -> None:
        """Foreground mode (the route entry point): probes on a daemon thread,
        HTTP on the caller's thread."""
        self._probe_thread = threading.Thread(target=self._probe_loop,
                                              daemon=True)
        self._probe_thread.start()
        try:
            self.httpd.serve_forever()
        finally:
            # SIGTERM lands here as SystemExit (the entry points'
            # sigterm_runs_finally seam): flush in-flight lifecycles
            # while the trace writer is still open.
            self._stop.set()
            self.router.abort_inflight("router shutdown")

    def __enter__(self) -> "RouterHTTPServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
