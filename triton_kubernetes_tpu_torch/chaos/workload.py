"""Workload fault arms: chaos for the serving data plane and training --
the port of ``triton_kubernetes_tpu/chaos/workload.py``.

A scenario may carry one ``workload`` fault drawn from the closed kind set
in :mod:`.corpus`. Each kind has one *arm* here that injects the fault
against the port's real subsystem -- live :class:`~..serve.ServeEngine`\\ s
behind real HTTP servers and the router, real checkpoint directories, the
multi-process launcher, a real ``tools.route`` subprocess -- and checks the
workload invariants:

* ``engine-parity`` / ``reland-parity`` -- outputs are bitwise identical
  to an unfaulted solo reference, whatever the fault did to scheduling;
* ``pool-convergence`` -- after drain + prefix release, zero KV pages
  remain allocated (the leak oracle);
* ``trace-valid`` -- every arm attaches trace writers, and
  :func:`~..utils.trace.validate_chaos_trace` then checks that every
  request the chaos touched ends span-complete with exact phase sums;
* ``migration-integrity`` -- a torn KV transfer is rejected on its digest
  with the destination untouched and the source still serving;
* ``ckpt-fallback`` / ``reshard-fallback`` -- a torn checkpoint is
  detected and restore falls back to the newest intact step (at its
  recorded mesh shape);
* ``train-resume`` -- after a rank death / coordinator loss, the resumed
  run lands on the uninterrupted reference's final loss;
* ``flush-clean`` -- a SIGTERMed router exits 143 with every placement
  flushed to its trace file.

Engines run on a :class:`~..serve.engine.ManualClock` (``ENGINE_CLOCK_TICK``
per read): scenario time is simulated.

**The model.** Every engine of every arm serves one model, set with
:func:`use_model` (which drops the cached engines and references). Without
one, the arms serve ``llama-test`` from the port's ``init_params(seed=0)``
on the device the caller names -- ``cuda`` unless it says ``cpu``; asking
for ``cuda`` without a card raises. On the card the engines run the
hand-written paged kernels; the arms' pools (block size 4) take their
CUDA-core designs (``ops/_kernels.paged_variant``).

**Worlds one device cannot host.** The train arms launch two trainer
ranks. Where the device cannot host them -- two NCCL ranks on one card --
the arm raises :class:`WorkloadArmSkipped` with the launcher's typed
reason (``parallel/multihost.REASON_RANKS_SHARE_CARD``), and
:func:`train_crash_resume` runs the same crash and resume as a world of
one.

Module-level imports are the standard library and the port's jax-free
trace and metrics modules; every arm imports the rest lazily. The
``_ARMS`` dict literal's keys equal ``WORKLOAD_FAULT_KINDS``.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import metrics
from ..utils.trace import (TRACE_HEADER, FlightRecorder, TraceWriter,
                           validate_chaos_trace, validate_goodput_trace)
from .corpus import WORKLOAD_DEFAULTS

#: Simulated seconds every engine ``clock()`` read advances. The soak
#: test raises this (module attribute, read per arm) to push hours of
#: simulated clock through the same scenarios in wall-seconds.
ENGINE_CLOCK_TICK = 0.002

#: The train arms' allowed distance between the resumed and the
#: uninterrupted final loss.
TRAIN_LOSS_TOL = 1e-6

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))


class WorkloadArmSkipped(RuntimeError):
    """This environment cannot run the arm (no multi-process collectives,
    or ranks that would share one card). Typed so sweeps skip LOUDLY,
    never vacuously pass."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


# --------------------------------------------------------------- caches
# Arms reuse engines across scenarios (a sweep would otherwise rebuild
# pools per scenario). Guarded for the odd concurrent caller; chaos
# sweeps themselves are serial.
_CACHE_LOCK = threading.Lock()
_MODEL: List[Any] = []                       # [(config, model, explicit)]
_ENGINES: Dict[Any, Tuple[Any, Any]] = {}    # key -> (engine, clock)
_REFERENCE: Dict[Any, List[int]] = {}        # solo-run output tokens
_TRAIN_REFERENCE: Dict[Any, Optional[float]] = {}  # -> final loss

#: Engine shapes. The preempt pool is deliberately tight (12 pages,
#: 3 slots) so a long chunked prefill plus a growing decode forces
#: preemption; replicas get the router-test shape.
_PREEMPT_KW = dict(block_size=4, num_blocks=12, max_batch=3,
                   max_model_len=48, prefill_chunk=8)
_REPLICA_KW = dict(block_size=4, num_blocks=32, max_batch=4,
                   max_model_len=64, prefill_chunk=8, prefix_cache=True)


def _clear_caches() -> None:
    _ENGINES.clear()
    _REFERENCE.clear()
    _TRAIN_REFERENCE.clear()


def use_model(config: Any = None, model: Any = None) -> None:
    """Serve ``model`` (a port ``Llama`` of ``config``) in every engine
    arm, on the device it lives on; ``use_model()`` goes back to the
    default (``llama-test``, ``init_params(seed=0)``). Either way the
    cached engines, solo references and train references are dropped."""
    if (config is None) != (model is None):
        raise ValueError("use_model takes a config and its model, or "
                         "neither")
    with _CACHE_LOCK:
        _clear_caches()
        _MODEL.clear()
        if model is not None:
            _MODEL.append((config, model, True))


def _model(device: Any):
    """(config, model) every engine arm serves, on ``device``."""
    from ..models import get_config, init_params
    from ..models.llama import resolve_device

    dev = resolve_device(device)
    with _CACHE_LOCK:
        if _MODEL:
            cfg, model, explicit = _MODEL[0]
            if model.device.type == dev.type:
                return cfg, model
            if explicit:
                raise ValueError(
                    f"the chaos arms' model lives on {model.device}, the "
                    f"arm was asked to run on {dev}")
        _clear_caches()
        _MODEL.clear()
        cfg = get_config("llama-test")
        _MODEL.append((cfg, init_params(cfg, seed=0, device=dev), False))
        return _MODEL[0][:2]


def _engine(key: Tuple[Any, ...], device: Any = "cuda"):
    """Cached (engine, ManualClock) for a shape key:
    ``("preempt", prefix_cache, spec_k)``, ``("replica", i)``,
    ``("mig-src",)``/``("mig-dst",)`` or ``("solo",)`` (the re-land
    reference twin of the replica shape)."""
    from ..serve.engine import ManualClock, ServeEngine

    cfg, model = _model(device)
    with _CACHE_LOCK:
        got = _ENGINES.get(key)
    if got is not None:
        return got
    if key[0] == "preempt":
        kw = dict(_PREEMPT_KW, prefix_cache=bool(key[1]),
                  spec_k=int(key[2]))
    else:
        kw = dict(_REPLICA_KW)
    clock = ManualClock(tick=ENGINE_CLOCK_TICK)
    engine = ServeEngine(model, cfg, clock=clock, device=model.device, **kw)
    with _CACHE_LOCK:
        _ENGINES.setdefault(key, (engine, clock))
        return _ENGINES[key]


def _reference_tokens(engine_key: Tuple[Any, ...], tokens: List[int],
                      max_new: int, seed: int,
                      device: Any = "cuda") -> List[int]:
    """Solo unfaulted run on the same engine shape -- the bitwise-parity
    oracle every faulted output is compared against. Cached: one solo
    run per distinct request across a whole sweep."""
    from ..serve.engine import Request

    key = (engine_key, tuple(tokens), max_new, seed)
    engine, _ = _engine(engine_key, device)
    with _CACHE_LOCK:
        if key in _REFERENCE:
            return _REFERENCE[key]
    assert engine.flight is None and not engine.has_work
    engine.submit(Request(f"wl-ref-{seed}-{len(tokens)}", list(tokens),
                          max_new, seed=seed))
    out = engine.run_until_idle()[0].tokens
    with _CACHE_LOCK:
        _REFERENCE[key] = out
    return out


def _drain(engine) -> int:
    """Quiesce a cached engine after a fault: finish leftovers silently
    (no recorder attached), drop cache-held pages, return the pages
    still allocated -- 0 unless something leaked."""
    engine.flight = None
    if engine.has_work:
        engine.run_until_idle()
    engine.release_prefix_cache()
    return engine.allocator.in_use


def _post(url: str, payload: Dict[str, Any], timeout: float = 60.0,
          ) -> Dict[str, Any]:
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ------------------------------------------------------- engine-preempt
def _arm_engine_preempt(cfg, spec, res, check, recorder, device) -> None:
    """Page pressure preempts a request mid-chunked-prefill (or
    mid-decode): a short prompt with a long decode grows into the pool a
    long prefill holds, the engine evicts the latest admission, and the
    victim recomputes. Outputs must not change; pages must converge; the
    trace must attribute every wait to ``queue``."""
    from ..serve.engine import Request

    mutation = spec.get("mutation")
    ekey = ("preempt", bool(cfg["prefix_cache"]), int(cfg["spec_k"]))
    engine, clock = _engine(ekey, device)
    clock.tick = ENGINE_CLOCK_TICK
    long_prompt = [(7 * i + 3) % 29 for i
                   in range(int(cfg["long_windows"]) * 8)]
    reqs = [("wl-grow", [3, 1, 4, 7], 12, 11),
            ("wl-long", long_prompt, 4, 12)]
    if int(cfg["requests"]) >= 3:
        reqs.append(("wl-peer", list(long_prompt), 4, 13))
    want = {rid: _reference_tokens(ekey, toks, mx, seed, device)
            for rid, toks, mx, seed in reqs}
    t0 = clock.now
    tmp = tempfile.mkdtemp(prefix="tk8s-chaos-wl-")
    path = os.path.join(tmp, "engine.jsonl")
    writer = TraceWriter(path, role="replica", clock=clock)
    engine.flight = FlightRecorder(writer=writer)
    finished: Dict[str, Any] = {}
    try:
        try:
            for rid, toks, mx, seed in reqs:
                engine.submit(Request(rid, list(toks), mx, seed=seed))
            abort_after = cfg.get("abort_after_steps")
            if abort_after:
                for _ in range(int(abort_after)):
                    for done in engine.step():
                        finished[done.request_id] = done
                # The injected mid-flight abort: the engine loop dies and
                # every live lifecycle must flush as aborted. The
                # swallowed-abort mutation skips the flush -- the trace
                # oracle must then report submitted-without-terminal.
                if mutation != "swallowed-abort":
                    engine.abort_inflight("chaos: injected abort")
            else:
                for done in engine.run_until_idle():
                    finished[done.request_id] = done
        finally:
            writer.close()
            leaked = _drain(engine) if mutation != "leaked-pages" \
                else engine.allocator.in_use
        res.stats["workload_preemptions"] = sum(
            d.preemptions for d in finished.values())
        bad = sorted(rid for rid, done in finished.items()
                     if done.tokens != want[rid])
        check(res, "engine-parity", not bad,
              f"outputs diverged from the solo reference under "
              f"preemption chaos: {bad}")
        if mutation == "leaked-pages":
            # Deliberately measured BEFORE the drain dropped cache pages
            # (then cleaned up so the cached engine stays reusable).
            check(res, "pool-convergence", leaked == 0,
                  f"{leaked} KV pages still allocated after the "
                  f"faulted run drained")
            _drain(engine)
        else:
            check(res, "pool-convergence", leaked == 0,
                  f"{leaked} KV pages still allocated after drain + "
                  f"prefix release")
        problems = validate_chaos_trace([path])
        check(res, "trace-valid", not problems,
              "; ".join(problems[:4]))
        recorder(max(0.0, clock.now - t0))
    finally:
        engine.flight = None
        shutil.rmtree(tmp, ignore_errors=True)


# -------------------------------------------------------- replica-death
def _arm_replica_death(cfg, spec, res, check, recorder, device) -> None:
    """Kill a replica mid-decode behind the live router: the session's
    in-flight request must re-land on a living replica with bitwise
    identical output, and every trace file must be complete -- the victim
    flushes the partial lifecycle as aborted, the router's placement
    spans all reach a terminal."""
    from ..serve.router import RouterHTTPServer
    from ..serve.server import ServeHTTPServer

    mutation = spec.get("mutation")
    n = int(cfg["replicas"])
    die_after = int(cfg["die_after_tokens"])
    prompt = [(5 * i + 7) % 29 for i in range(int(cfg["prompt_len"]))]
    max_new = int(cfg["max_new_tokens"])
    want = _reference_tokens(("solo",), prompt, max_new, 21, device)
    tmp = tempfile.mkdtemp(prefix="tk8s-chaos-wl-")
    router_path = os.path.join(tmp, "router.jsonl")
    paths = [router_path]
    engines: List[Tuple[Any, Any, float]] = []
    servers: List[Any] = []
    router = None
    route_writer = TraceWriter(router_path, role="router")
    try:
        for i in range(n):
            engine, clock = _engine(("replica", i), device)
            clock.tick = ENGINE_CLOCK_TICK
            p = os.path.join(tmp, f"replica-{i}.jsonl")
            engine.flight = FlightRecorder(
                writer=TraceWriter(p, role="replica", clock=clock))
            paths.append(p)
            engines.append((engine, clock, clock.now))
            servers.append(ServeHTTPServer(engine).start())
        router = RouterHTTPServer([s.url for s in servers],
                                  health_interval_s=10.0,
                                  trace=route_writer).start()
        probe = {"tokens": [7, 3, 9, 1], "max_new_tokens": 2,
                 "session_id": "chaos-victim"}
        first = _post(router.url, probe)
        victim_name = first["replica"]
        victim_url = router.router.replicas[victim_name].url
        victim = next(e for (e, _, _), s in zip(engines, servers)
                      if s.url == victim_url)
        orig_step = victim.step
        calls = {"n": 0}

        def dying_step():
            # Raises before the tick launches anything: the loop's death
            # leaves no kernel of this tick in flight.
            calls["n"] += 1
            if calls["n"] > die_after:
                raise RuntimeError("chaos: injected replica death")
            return orig_step()

        victim.step = dying_step
        slow = {"tokens": list(prompt), "max_new_tokens": max_new,
                "session_id": "chaos-victim"}
        got: Dict[str, Any] = {}

        def fire():
            try:
                got["out"] = _post(router.url, slow, timeout=90)
            except Exception as e:  # surfaced via the invariant detail
                got["error"] = f"{type(e).__name__}: {e}"

        t = threading.Thread(target=fire)
        t.start()
        t.join(timeout=120)
        victim.__dict__.pop("step", None)
        out = got.get("out") or {}
        tokens = out.get("tokens")
        if mutation == "dropped-reland" and tokens is not None:
            # The seeded harness self-test: pretend the router returned
            # the victim's partial generation instead of re-landing.
            tokens = tokens[:die_after]
        ok = (not t.is_alive() and tokens == want
              and out.get("replica") not in (None, victim_name))
        check(res, "reland-parity", ok,
              f"re-land after replica death diverged: got={tokens} "
              f"want={want} replica={out.get('replica')} "
              f"victim={victim_name} error={got.get('error')}")
    finally:
        if router is not None:
            router.stop()
        for s in servers:
            s.stop()
        route_writer.close()
        leaked = 0
        for engine, clock, t0 in engines:
            engine.__dict__.pop("step", None)
            flight, engine.flight = engine.flight, None
            if flight is not None:
                # The victim's server loop already flushed its dead
                # lifecycles; a no-op there and a guard everywhere else.
                flight.flush_aborted(clock(), "chaos: arm teardown")
                if flight.writer is not None:
                    flight.writer.close()
            # The replicas' loop threads have stopped: the drain runs on
            # this thread, on the device's default stream.
            leaked += _drain(engine)
            recorder(max(0.0, clock.now - t0))
    check(res, "pool-convergence", leaked == 0,
          f"{leaked} KV pages still allocated across replicas after "
          f"drain + prefix release")
    problems = validate_chaos_trace(paths)
    check(res, "trace-valid", not problems, "; ".join(problems[:4]))
    shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------- kv-migration-torn
def _arm_kv_migration_torn(cfg, spec, res, check, recorder, device) -> None:
    """Tear a KV-page migration mid-flight (cut or corrupted frame at a
    generated byte offset): the destination must reject the torn payload
    on its digest with ZERO pages allocated, the source must keep serving
    with the session still parked, and a retry with the intact bytes must
    land bitwise-identical to the never-migrated solo reference. The
    ``accepted-torn`` mutation pretends the destination imported the torn
    bytes -- migration-integrity must catch the phantom acceptance."""
    from ..serve.engine import Request
    from ..serve.migration import TornPayloadError, corrupt

    mutation = spec.get("mutation")
    prompt = [(11 * i + 5) % 29 for i in range(int(cfg["prompt_len"]))]
    max_new = int(cfg["max_new_tokens"])
    want = _reference_tokens(("solo",), prompt, max_new, 31, device)
    src, sclock = _engine(("mig-src",), device)
    dst, dclock = _engine(("mig-dst",), device)
    sclock.tick = dclock.tick = ENGINE_CLOCK_TICK
    t0s, t0d = sclock.now, dclock.now
    tmp = tempfile.mkdtemp(prefix="tk8s-chaos-wl-")
    src_path = os.path.join(tmp, "mig-src.jsonl")
    dst_path = os.path.join(tmp, "mig-dst.jsonl")
    src.flight = FlightRecorder(
        writer=TraceWriter(src_path, role="replica", clock=sclock))
    dst.flight = FlightRecorder(
        writer=TraceWriter(dst_path, role="replica", clock=dclock))
    rid = "wl-mig"
    try:
        src.submit(Request(rid, list(prompt), max_new, seed=31,
                           handoff=True))
        first = {d.request_id: d for d in src.run_until_idle()}
        parked = (first.get(rid) is not None
                  and first[rid].finish_reason == "handoff"
                  and rid in src.parked)
        blob = src.export_session(rid) if parked else b""
        torn = corrupt(blob, mode=cfg["cut"],
                       offset=int(float(cfg["offset_frac"]) * len(blob))
                       ) if parked else b""
        dest_before = dst.allocator.in_use
        rejected = False
        if parked:
            try:
                dst.import_session(torn, request_id=f"mig-{rid}")
            except TornPayloadError:
                rejected = True
            except Exception:  # wrong error class = wrong rejection
                rejected = False
        if mutation == "accepted-torn":
            # The seeded harness self-test: a receiver that swallowed
            # the digest mismatch and kept the torn pages.
            rejected = False
        # Source un-degraded after the torn attempt: the session is still
        # parked and a fresh request decodes bitwise-clean alongside it.
        probe_prompt = [3, 1, 4, 1, 5, 9, 2, 6]
        probe_want = _reference_tokens(("solo",), probe_prompt, 4, 32,
                                       device)
        src.submit(Request("wl-mig-probe", list(probe_prompt), 4,
                           seed=32))
        probe = {d.request_id: d for d in src.run_until_idle()}
        probe_done = probe.get("wl-mig-probe")
        check(res, "migration-integrity",
              parked and rejected and dst.allocator.in_use == dest_before
              and rid in src.parked
              and probe_done is not None
              and probe_done.tokens == probe_want,
              f"torn transfer ({cfg['cut']} at "
              f"{cfg['offset_frac']}): parked={parked} "
              f"rejected={rejected} dest pages "
              f"{dest_before}->{dst.allocator.in_use}, source probe "
              f"tokens={getattr(probe_done, 'tokens', None)} "
              f"(want {probe_want})")
        tokens = None
        if parked:
            new_rid = dst.import_session(blob, request_id=f"mig-{rid}")
            done = {d.request_id: d for d in dst.run_until_idle()}
            src.release_session(rid)
            got = done.get(new_rid)
            tokens = got.tokens if got is not None else None
        check(res, "engine-parity", tokens == want,
              f"retried migration diverged from the solo reference: "
              f"got={tokens} want={want}")
    finally:
        leaked = 0
        for eng, clock, t0 in ((src, sclock, t0s), (dst, dclock, t0d)):
            flight, eng.flight = eng.flight, None
            if flight is not None:
                flight.flush_aborted(clock(), "chaos: arm teardown")
                if flight.writer is not None:
                    flight.writer.close()
            # A failed arm may strand a parked session; release it so the
            # cached engine stays reusable (a buggy release still shows
            # up as leaked pages below).
            for leftover in list(eng.parked):
                try:
                    eng.release_session(leftover)
                except Exception:
                    pass
            leaked += _drain(eng)
            recorder(max(0.0, clock.now - t0))
    check(res, "pool-convergence", leaked == 0,
          f"{leaked} KV pages still allocated across source + "
          f"destination after release + drain")
    problems = validate_chaos_trace([src_path, dst_path])
    check(res, "trace-valid", not problems, "; ".join(problems[:4]))
    shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------ torn-checkpoint
def _ckpt_state(step: int, device: Any) -> Dict[str, Any]:
    """The arms' two-leaf train state at ``step``, on ``device`` (on the
    card a save stages it through the manager's pinned HostStaging)."""
    import torch

    return {"step": torch.tensor(step, dtype=torch.int32, device=device),
            "w": torch.tensor(step * 10.0, dtype=torch.float32,
                              device=device)}


def _arm_torn_checkpoint(cfg, spec, res, check, recorder, device) -> None:
    """Corrupt one committed step (truncated file, flipped bit, torn
    manifest) and resume: verification must reject exactly the torn step
    and restore must fall back to the newest intact one."""
    from ..models.llama import resolve_device
    from ..train.checkpoint import (CheckpointIntegrityError,
                                    CheckpointManager, MANIFEST_NAME)

    dev = resolve_device(device)
    keep = int(cfg["keep_steps"])
    torn = int(cfg["torn_step"])
    mode = cfg["corruption"]
    tmp = tempfile.mkdtemp(prefix="tk8s-chaos-wl-")
    try:
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"),
                                max_to_keep=keep + 1)
        for s in range(1, keep + 1):
            mgr.save(s, _ckpt_state(s, dev), wait=True)
        step_dir = os.path.join(tmp, "ckpt", str(torn))
        if mode == "torn-manifest":
            manifest = os.path.join(step_dir, MANIFEST_NAME)
            with open(manifest, "r+b") as f:
                f.truncate(max(os.path.getsize(manifest) // 2, 1))
        else:
            files = [os.path.join(root, fn)
                     for root, _, fns in os.walk(step_dir)
                     for fn in fns if fn != MANIFEST_NAME]
            target = max(files, key=os.path.getsize)
            with open(target, "r+b") as f:
                size = os.path.getsize(target)
                if mode == "truncate":
                    f.truncate(max(size // 2, 1))
                else:  # bitflip
                    f.seek(size // 2)
                    byte = f.read(1)
                    f.seek(size // 2)
                    f.write(bytes([byte[0] ^ 0xFF]))
        detected = False
        try:
            mgr.verify_step(torn)
        except CheckpointIntegrityError:
            detected = True
        expect = max(s for s in range(1, keep + 1) if s != torn)
        restored = mgr.restore(_ckpt_state(0, dev))
        landed = mgr.last_restored_step
        intact = float(restored["w"]) == expect * 10.0
        check(res, "ckpt-fallback",
              detected and landed == expect and intact,
              f"torn step {torn} ({mode}): detected={detected}, "
              f"restore landed on {landed} (want {expect}), "
              f"w={float(restored['w'])}")
        mgr.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------- reshard-torn-checkpoint
def _arm_reshard_torn_checkpoint(cfg, spec, res, check, recorder,
                                 device) -> None:
    """Tear the manifest mid 8->4 elastic reshard: the old 8-device fleet
    committed ``keep_steps`` checkpoints at its recorded shape, the new
    4-device fleet's save dies mid-manifest-write at a generated byte
    offset. Restore must fall back to the newest intact step *at its
    recorded shape*: the peek skips the torn manifest, negotiation
    reproduces the recorded mesh, restore lands the intact step's exact
    values. The ``adopt-torn-step`` mutation pretends restore landed the
    half-written step; the reshard-fallback oracle must catch it."""
    from ..models.llama import resolve_device
    from ..train.checkpoint import (CheckpointIntegrityError,
                                    CheckpointManager, MANIFEST_NAME,
                                    peek_newest_manifest)
    from ..train.resilience import negotiate_mesh_config

    dev = resolve_device(device)
    mutation = spec.get("mutation")
    keep = int(cfg["keep_steps"])
    frac = float(cfg["offset_frac"])
    torn = keep + int(cfg["torn_step"])  # the reshard-side save(s)
    spec8 = {"axes": {"data": 2, "stage": 1, "fsdp": 4, "seq": 1,
                      "expert": 1, "tensor": 1},
             "n_processes": 2, "n_devices": 8, "global_batch": 16}
    spec4 = {"axes": {"data": 1, "stage": 1, "fsdp": 4, "seq": 1,
                      "expert": 1, "tensor": 1},
             "n_processes": 1, "n_devices": 4, "global_batch": 16}
    tmp = tempfile.mkdtemp(prefix="tk8s-chaos-wl-")
    try:
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"),
                                max_to_keep=torn + 1, mesh_spec=spec8)
        for s in range(1, keep + 1):
            mgr.save(s, _ckpt_state(s, dev), wait=True)
        # The 8->4 reshard in progress: the smaller fleet's saves record
        # ITS shape -- and the one at `torn` dies mid-manifest-write.
        mgr.mesh_spec = spec4
        for s in range(keep + 1, torn + 1):
            mgr.save(s, _ckpt_state(s, dev), wait=True)
        manifest = os.path.join(tmp, "ckpt", str(torn), MANIFEST_NAME)
        size = os.path.getsize(manifest)
        with open(manifest, "r+b") as f:
            f.truncate(max(int(size * frac), 1))
        detected = False
        try:
            mgr.verify_step(torn)
        except CheckpointIntegrityError:
            detected = True
        expect = torn - 1
        peeked = peek_newest_manifest(os.path.join(tmp, "ckpt"))
        peek_step = peeked[0] if peeked else None
        recorded = peeked[1].get("mesh") if peeked else None
        expect_axes = spec4["axes"] if expect > keep else spec8["axes"]
        expect_fleet = (spec4 if expect > keep else spec8)
        shape_ok = (recorded is not None
                    and recorded.get("axes") == expect_axes)
        negotiated_ok = False
        if recorded is not None:
            try:
                neg = negotiate_mesh_config(
                    recorded,
                    n_processes=int(expect_fleet["n_processes"]),
                    n_devices=int(expect_fleet["n_devices"]))
                negotiated_ok = (
                    neg.data * neg.stage * neg.fsdp * neg.seq
                    * neg.expert * neg.tensor
                    == int(expect_fleet["n_devices"]))
            except Exception:
                negotiated_ok = False
        restored = mgr.restore(_ckpt_state(0, dev))
        landed = mgr.last_restored_step
        intact = float(restored["w"]) == expect * 10.0
        if mutation == "adopt-torn-step":
            # Harness self-test: model a restore that adopted the
            # half-committed reshard step -- the oracle below must bite.
            landed = torn
            intact = False
        check(res, "reshard-fallback",
              detected and landed == expect and peek_step == expect
              and shape_ok and negotiated_ok and intact,
              f"torn manifest at step {torn} (offset_frac {frac}): "
              f"detected={detected}, restore landed on {landed} "
              f"(want {expect}), peek saw step {peek_step}, "
              f"recorded-shape ok={shape_ok}, "
              f"negotiated ok={negotiated_ok}, "
              f"w={float(restored['w'])}")
        mgr.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------- rank-death/coordinator-loss
#: Ranks of the train arms' fleet.
TRAIN_WORLD = 2


def _train_args(steps: int, ckpt_dir: str, device: str,
                trace_jsonl: Optional[str] = None) -> List[str]:
    args = ["--model", "llama-test", "--batch-size", "8",
            "--seq-len", "32", "--steps", str(steps),
            "--sync-every", "1", "--checkpoint-dir", ckpt_dir,
            "--checkpoint-every", "1", "--resume", "--device", device]
    if trace_jsonl:
        # Every rank derives its own {root}.rankN.jsonl from this one
        # path (launch_trainers passes identical args to all ranks).
        args += ["--trace-jsonl", trace_jsonl]
    return args


def _train_reference(steps: int, device: str,
                     n_processes: int) -> Optional[float]:
    """Final loss of one uninterrupted run of the fleet -- the target
    every crash + resume run must reproduce (same seeds, same batch
    order)."""
    from ..parallel import multihost

    key = (steps, device, n_processes)
    with _CACHE_LOCK:
        if key in _TRAIN_REFERENCE:
            return _TRAIN_REFERENCE[key]
    tmp = tempfile.mkdtemp(prefix="tk8s-chaos-wl-")
    try:
        rep = multihost.launch_trainers(
            _train_args(steps, os.path.join(tmp, "ckpt"), device),
            n_processes=n_processes,
            run_dir=os.path.join(tmp, "run"), tag="chaos-ref",
            timeout=240)
        losses = (rep.report or {}).get("losses") or []
        final = float(losses[-1]) if rep.ok and losses else None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with _CACHE_LOCK:
        _TRAIN_REFERENCE[key] = final
    return final


def train_crash_resume(steps: int, crash_step: int, victim_rank: int,
                       device: str = "cuda",
                       n_processes: int = TRAIN_WORLD) -> Dict[str, Any]:
    """Kill trainer rank ``victim_rank`` at the first sync window at or
    past step ``crash_step`` (``TK8S_TEST_CRASH_STEP``), then relaunch
    with ``--resume``; and the uninterrupted run it must land on. Returns
    ``died`` (phase 1's victim exited 3), ``rcs``, ``resume_ok``,
    ``final``, ``reference``, ``ok`` (died, resumed, and the final loss
    within :data:`TRAIN_LOSS_TOL` of the reference), every rank trace's
    goodput problems, the resumed run's kernel launches (its report's
    ``kernel_launches``) and the two phases' wall seconds."""
    from ..parallel import multihost

    ref = _train_reference(steps, device, n_processes)
    tmp = tempfile.mkdtemp(prefix="tk8s-chaos-wl-")
    try:
        ckpt = os.path.join(tmp, "ckpt")
        rep1 = multihost.launch_trainers(
            _train_args(steps, ckpt, device,
                        trace_jsonl=os.path.join(tmp, "p1-trace.jsonl")),
            n_processes=n_processes,
            run_dir=os.path.join(tmp, "phase1"), tag="chaos-crash",
            timeout=240,
            env_extra={"TK8S_TEST_CRASH_STEP": str(crash_step),
                       "TK8S_TEST_CRASH_STEP_RANK": str(victim_rank)})
        died = (not rep1.ok
                and len(rep1.returncodes) > victim_rank
                and rep1.returncodes[victim_rank] == 3)
        rep2 = multihost.launch_trainers(
            _train_args(steps, ckpt, device,
                        trace_jsonl=os.path.join(tmp, "p2-trace.jsonl")),
            n_processes=n_processes,
            run_dir=os.path.join(tmp, "phase2"), tag="chaos-resume",
            timeout=240)
        losses = (rep2.report or {}).get("losses") or []
        final = float(losses[-1]) if rep2.ok and losses else None
        # Every rank's goodput ledger -- including the one the crash
        # killed mid-run -- must pass the partition oracle: the recorder
        # flushes each closed segment, so even an os._exit(3) rank leaves
        # a prefix of segments that tiles its recorded window exactly.
        traces = sorted(glob.glob(os.path.join(tmp, "p?-trace*.jsonl")))
        return {"died": died, "rcs": rep1.returncodes,
                "resume_ok": rep2.ok, "final": final, "reference": ref,
                "ok": (died and ref is not None and final is not None
                       and abs(final - ref) < TRAIN_LOSS_TOL),
                "traces": len(traces),
                "trace_problems": validate_goodput_trace(traces),
                "resume_launches": (rep2.report or {}).get(
                    "kernel_launches"),
                "wall_seconds": [rep1.wall_seconds, rep2.wall_seconds],
                "tails": [w.tail for w in rep1.workers + rep2.workers
                          if w.returncode not in (0, 3)]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _train_crash_arm(cfg, spec, res, check, recorder, device,
                     victim_rank: int) -> None:
    """Kill one trainer process at a generated step offset (rank 0 = the
    checkpoint/report coordinator), then relaunch with ``--resume``:
    phase 1 must actually die with the injected exit code (fail-fast
    reaps the peer), phase 2 must complete and land on the uninterrupted
    reference's final loss."""
    import torch

    from ..parallel import multihost

    try:
        multihost.require_multihost(torch.device(device).type,
                                    n_processes=TRAIN_WORLD)
    except multihost.MultiHostUnavailable as e:
        raise WorkloadArmSkipped(e.reason)
    crash = int(cfg["crash_step"])
    got = train_crash_resume(int(cfg["steps"]), crash, victim_rank,
                             str(device))
    check(res, "train-resume", got["ok"],
          f"rank {victim_rank} death at step +{crash}: "
          f"died={got['died']} (rcs={got['rcs']}), resume "
          f"ok={got['resume_ok']}, final={got['final']} vs "
          f"reference={got['reference']}")
    problems = got["trace_problems"]
    check(res, "trace-valid", bool(got["traces"]) and not problems,
          f"{got['traces']} trainer trace files: "
          + ("; ".join(problems[:4]) or "goodput partition OK"))
    recorder(sum(got["wall_seconds"]))


def _arm_rank_death(cfg, spec, res, check, recorder, device) -> None:
    _train_crash_arm(cfg, spec, res, check, recorder, device,
                     victim_rank=1)


def _arm_coordinator_loss(cfg, spec, res, check, recorder, device) -> None:
    _train_crash_arm(cfg, spec, res, check, recorder, device,
                     victim_rank=0)


# -------------------------------------------------------- sigterm-flush
class _StubReplica:
    """A model-free stand-in replica for the SIGTERM arm: answers
    /healthz and /generate like a serving pod and writes the full request
    lifecycle (keyed to the router's ``X-TK8S-Trace`` header) to its own
    trace file, so the cross-file completeness rule has a real
    ``serve.finish`` to find for every placement."""

    def __init__(self, path: str):
        self.writer = TraceWriter(path, role="replica")
        self.flight = FlightRecorder(writer=self.writer)
        self._n = 0
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _reply(self, status, obj):
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib naming)
                if self.path == "/healthz":
                    self._reply(200, {"ok": True})
                else:
                    self._reply(404, {"type": "error",
                                      "message": "not found"})

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length") or 0)
                try:
                    payload = json.loads(
                        self.rfile.read(length) or b"{}")
                except ValueError:
                    self._reply(400, {"type": "error",
                                      "message": "bad json"})
                    return
                self._reply(200, outer.generate(
                    payload, self.headers.get(TRACE_HEADER)))

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def generate(self, payload: Dict[str, Any],
                 trace_id: Optional[str]) -> Dict[str, Any]:
        with self._lock:
            self._n += 1
            rid = f"stub-{self._n}"
        clock = time.monotonic
        self.flight.begin(rid, trace_id, clock())
        self.flight.event(rid, "serve.admitted", clock(),
                          deferred=False)
        self.flight.event(rid, "serve.first_token", clock())
        self.flight.finish(rid, clock(), "length")
        return {"request_id": rid, "prompt_len":
                len(payload.get("tokens") or []),
                "tokens": [1, 2, 3], "finish_reason": "length"}

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)
        self.flight.flush_aborted(time.monotonic(), "stub shutdown")
        self.writer.close()


def _arm_sigterm_flush(cfg, spec, res, check, recorder, device) -> None:
    """SIGTERM a real ``tools.route`` subprocess after N proxied
    requests: it must exit 143 through the finally chain with every
    placement span flushed to the trace file (and the merged
    router + replica timeline span-complete). The router runs no model:
    ``device`` does not reach it."""
    n = int(cfg["after_requests"])
    tmp = tempfile.mkdtemp(prefix="tk8s-chaos-wl-")
    stub_path = os.path.join(tmp, "stub.jsonl")
    route_path = os.path.join(tmp, "route.jsonl")
    stub = _StubReplica(stub_path)
    proc = None
    detail = ""
    ok = False
    try:
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep \
            + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "triton_kubernetes_tpu_torch.tools.route",
             "--replica", stub.url,
             "--route-host", "127.0.0.1", "--port", "0",
             "--trace-jsonl", route_path],
            cwd=_REPO_ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        banner: Dict[str, str] = {}

        def read_banner():
            banner["line"] = proc.stdout.readline()

        t = threading.Thread(target=read_banner, daemon=True)
        t.start()
        t.join(timeout=60)
        m = re.search(r"on (http://[\d.]+:\d+)", banner.get("line") or "")
        if not m:
            detail = f"router never started: {banner.get('line')!r}"
        else:
            url = m.group(1)
            served = 0
            for i in range(n):
                out = _post(url, {"tokens": [1, 2, 3, 4],
                                  "max_new_tokens": 3,
                                  "session_id": "chaos-sigterm"},
                            timeout=30)
                served += 1 if out.get("finish_reason") else 0
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            places = [ev for ev in _read_jsonl(route_path)
                      if ev.get("name") == "route.place"
                      and (ev.get("fields") or {}).get("status") == 200]
            ok = rc == 143 and served == n and len(places) >= n
            detail = (f"SIGTERM mid-serve: rc={rc} (want 143), "
                      f"served={served}/{n}, {len(places)} flushed "
                      f"route.place spans (want >= {n})")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        if proc is not None:
            proc.stdout.close()
            proc.stderr.close()
        stub.close()
    check(res, "flush-clean", ok, detail)
    problems = validate_chaos_trace([route_path, stub_path])
    check(res, "trace-valid", not problems, "; ".join(problems[:4]))
    shutil.rmtree(tmp, ignore_errors=True)


#: kind -> arm. Dict literal by design: its keys equal
#: WORKLOAD_FAULT_KINDS -- an arm-less kind (or a kind-less arm) is the
#: "silently inert fault" bug class.
_ARMS = {
    "replica-death": _arm_replica_death,
    "engine-preempt": _arm_engine_preempt,
    "torn-checkpoint": _arm_torn_checkpoint,
    "rank-death": _arm_rank_death,
    "coordinator-loss": _arm_coordinator_loss,
    "sigterm-flush": _arm_sigterm_flush,
    "kv-migration-torn": _arm_kv_migration_torn,
    "reshard-torn-checkpoint": _arm_reshard_torn_checkpoint,
}


def run_workload_arm(spec: Dict[str, Any], res, check: Callable,
                     recorder: Callable[[float], None],
                     device: str = "cuda") -> None:
    """Dispatch a scenario's workload fault to its arm on ``device``.
    Field defaults come from :data:`~.corpus.WORKLOAD_DEFAULTS` (the spec
    overrides a subset). Every run is counted by kind and outcome; a skip
    is an outcome, never silence."""
    workload = spec["workload"]
    kind = workload["kind"]
    cfg = dict(WORKLOAD_DEFAULTS[kind])
    cfg.update({k: v for k, v in workload.items() if k != "kind"})
    res.stats["workload_kind"] = kind
    before = len(res.violations)
    status = "ok"
    try:
        _ARMS[kind](cfg, spec, res, check, recorder, device)
        if len(res.violations) > before:
            status = "violated"
    except WorkloadArmSkipped as e:
        status = "skipped"
        res.stats["workload_skipped"] = e.reason
    metrics.counter("tk8s_chaos_workload_arms_total").inc(
        kind=kind, status=status)
