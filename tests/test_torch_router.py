"""Port parity for the fleet layer: the hash ring, the router's policies,
the seeded load generator and the router over the port's replicas.

* The ring, ``route_key``, ``Router.pick`` and ``Router.pick_decode`` are
  host code: the same keys, scripted health, load and ``/stats`` answers
  through the reference's and the port's give the same owners and picks.
* Every loadgen schedule and ``percentile`` equal the reference's for
  several seeds (``random.Random`` in both: the identical stream).
* Port replicas (``ServeHTTPServer``, ``device="cpu"``) behind the port's
  router -- and behind the *reference's* ``RouterHTTPServer``, which is
  jax-free -- give the JAX engine's tokens exactly: routing, spill, eject,
  disaggregated handoff and drains never change a token, and the wire
  format is the same across the two packages.
* The router, loadgen and the route entry point import without torch.
"""

import json
import random
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu.serve import loadgen as jloadgen
from triton_kubernetes_tpu.serve import Request as JRequest
from triton_kubernetes_tpu.serve import ServeEngine as JServeEngine
from triton_kubernetes_tpu.serve.router import HashRing as JHashRing
from triton_kubernetes_tpu.serve.router import Router as JRouter
from triton_kubernetes_tpu.serve.router import \
    RouterHTTPServer as JRouterHTTPServer
from triton_kubernetes_tpu.utils import metrics as jmetrics
from triton_kubernetes_tpu_torch.models import from_numpy_params, get_config
from triton_kubernetes_tpu_torch.serve import (
    DiurnalSchedule,
    HashRing,
    PoissonSchedule,
    RepetitionSchedule,
    Router,
    RouterHTTPServer,
    ServeEngine,
    ServeHTTPServer,
    SessionSchedule,
    SharedPrefixSchedule,
    percentile,
)
from triton_kubernetes_tpu_torch.utils import metrics

ENGINE_KW = dict(block_size=4, num_blocks=64, max_batch=4, max_model_len=64,
                 prefill_chunk=8, prefix_cache=True)
PROMPTS = [
    ([5, 7, 9, 11, 2, 4, 6, 8], 12),
    ([3, 1, 4, 1, 5, 9, 2, 6], 10),
    ([2, 2, 2], 5),
    ([9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 1, 2, 3], 7),
]


@pytest.fixture(autouse=True)
def fresh_registries():
    metrics.configure()
    jmetrics.configure()
    yield
    metrics.configure()
    jmetrics.configure()


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("llama-test")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("llama-test")
    model = from_numpy_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return (jparams, jcfg), (model, cfg)


@pytest.fixture(scope="module")
def jax_tokens(models):
    """The JAX engine's tokens for a request run alone (memoized)."""
    (jparams, jcfg), _ = models
    engine = JServeEngine(jparams, jcfg, **ENGINE_KW)
    memo = {}

    def tokens(prompt, n, seed=0):
        key = (tuple(prompt), n, seed)
        if key not in memo:
            engine.submit(JRequest("ref", list(prompt), n, seed=seed))
            (done,) = engine.run_until_idle()
            memo[key] = done.tokens
        return memo[key]

    return tokens


def make_engine(models, **over):
    _, (model, cfg) = models
    return ServeEngine(model, cfg, device="cpu", **dict(ENGINE_KW, **over))


def _post(url, payload, timeout=60, path="/generate"):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


# ------------------------------------------------------------ hash ring
@pytest.mark.parametrize("names,vnodes", [
    (["r0", "r1", "r2"], 64),
    ([f"r{i}" for i in range(5)], 16),
    (["d0", "d1"], 1),
])
def test_hash_ring_owners_match_reference(names, vnodes):
    ring, jring = HashRing(names, vnodes), JHashRing(names, vnodes)
    keys = [f"session:{i}" for i in range(1000)] + [
        Router.route_key({"tokens": list(range(i))}) for i in range(50)]
    excludes = [frozenset()] + [frozenset({n}) for n in names] + [
        frozenset(names[:2])]
    for exclude in excludes:
        if exclude == frozenset(names):
            continue
        assert ([ring.owner(k, exclude) for k in keys]
                == [jring.owner(k, exclude) for k in keys]), exclude
    for r in (ring, jring):
        with pytest.raises(LookupError):
            r.owner("x", frozenset(names))
    with pytest.raises(ValueError):
        HashRing([])
    with pytest.raises(ValueError):
        HashRing(["r0"], virtual_nodes=0)


def test_route_key_matches_reference():
    payloads = [{"session_id": "s1", "tokens": [1, 2]},
                {"session_id": "", "tokens": [1, 2]},
                {"session_id": 7, "tokens": [3]},
                {"tokens": [1, 2, 3]}, {"tokens": []}, {}]
    for p in payloads:
        assert Router.route_key(p) == JRouter.route_key(p), p


# -------------------------------------------------------------- policy
@pytest.mark.parametrize("spill_threshold", [1, 2, 4])
def test_router_pick_matches_reference(spill_threshold):
    """The same scripted in-flight counts, health flags, exclusions and
    keys give the same (replica, reason) -- or both refuse."""
    urls = [f"http://127.0.0.1:{9000 + i}" for i in range(4)]
    router = Router(urls, spill_threshold=spill_threshold)
    jrouter = JRouter(urls, spill_threshold=spill_threshold)
    rng = random.Random(spill_threshold)
    reasons = set()
    for step in range(400):
        for name in router.replicas:
            load, healthy = rng.randrange(6), rng.random() > 0.2
            for r in (router, jrouter):
                r.replicas[name].in_flight = load
                r.replicas[name].healthy = healthy
        exclude = frozenset(n for n in router.replicas
                            if rng.random() < 0.1)
        key = f"session:{rng.randrange(50)}"
        try:
            want = jrouter.pick(key, exclude)
        except LookupError:
            with pytest.raises(LookupError, match="no healthy replica"):
                router.pick(key, exclude)
            continue
        got = router.pick(key, exclude)
        assert (got[0].name, got[1]) == (want[0].name, want[1]), step
        reasons.add(got[1])
    assert reasons == {"affine", "spill", "eject"}
    with pytest.raises(ValueError):
        Router([])
    with pytest.raises(ValueError):
        Router(["http://x"], spill_threshold=0)


def test_pick_decode_matches_reference():
    """Scripted ``/stats`` answers (pressures, unreachable replicas,
    missing fields) and health: the same decode replica, or both refuse."""
    decode = [f"http://d{i}:1" for i in range(4)]
    router = Router(["http://p:1"], decode_urls=decode)
    jrouter = JRouter(["http://p:1"], decode_urls=decode)
    rng = random.Random(5)
    for step in range(300):
        answers = {}
        for name, rep in router.decode_replicas.items():
            roll = rng.random()
            if roll < 0.15:
                continue  # unreachable
            body = ({} if roll < 0.25
                    else {"kv_pressure": rng.choice([0.0, 0.1, 0.5, 0.9])})
            answers[rep.url + "/stats"] = (200, body)
            healthy = rng.random() > 0.15
            router.decode_replicas[name].healthy = healthy
            jrouter.decode_replicas[name].healthy = healthy
        for r in (router, jrouter):
            r._get_json = lambda url: answers.get(url, (503, {}))
        exclude = frozenset(n for n in router.decode_replicas
                            if rng.random() < 0.1)
        key = f"session-{rng.randrange(40)}"
        try:
            want = jrouter.pick_decode(key, exclude).name
        except LookupError:
            with pytest.raises(LookupError):
                router.pick_decode(key, exclude)
            continue
        assert router.pick_decode(key, exclude).name == want, step


# ------------------------------------------------------------- loadgen
def _stream(schedule):
    return [(r.at, r.request_id, r.tokens, r.max_new_tokens, r.session_id)
            for r in schedule]


SCHEDULES = [
    ("PoissonSchedule", PoissonSchedule,
     dict(rate=2.0, n=48, vocab_size=128256, prompt_len_range=(200, 1000),
          max_new_tokens=32)),
    ("PoissonSchedule", PoissonSchedule, dict(rate=100.0, n=16,
                                              vocab_size=256)),
    ("SharedPrefixSchedule", SharedPrefixSchedule,
     dict(rate=10.0, n=12, vocab_size=50, num_prefixes=2, prefix_len=16)),
    ("RepetitionSchedule", RepetitionSchedule,
     dict(rate=4.0, n=10, vocab_size=300, prompt_len=40)),
    ("SessionSchedule", SessionSchedule,
     dict(rate=5.0, num_sessions=3, turns=4, vocab_size=50, prefix_len=8)),
    ("DiurnalSchedule", DiurnalSchedule,
     dict(base_rate=1.0, peak_rate=5.0, day_seconds=30.0, days=1.0)),
]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("i", range(len(SCHEDULES)),
                         ids=[f"{s[0]}-{j}" for j, s in enumerate(SCHEDULES)])
def test_loadgen_schedules_match_reference(i, seed):
    name, cls, kw = SCHEDULES[i]
    got, want = cls(seed=seed, **kw), getattr(jloadgen, name)(seed=seed, **kw)
    assert len(got) == len(want) > 0
    assert _stream(got) == _stream(want)
    for attr in ("prefixes", "prefix_of", "bursts"):
        assert getattr(got, attr, None) == getattr(want, attr, None)
    if name == "DiurnalSchedule":
        ts = [0.5 * k for k in range(60)]
        assert [got.rate_at(t) for t in ts] == [want.rate_at(t) for t in ts]


def test_loadgen_rejects_what_the_reference_rejects():
    bad = [(PoissonSchedule, dict(rate=0.0, n=4, vocab_size=16)),
           (SharedPrefixSchedule, dict(rate=1.0, n=4, vocab_size=16,
                                       num_prefixes=0)),
           (RepetitionSchedule, dict(rate=1.0, n=4, vocab_size=16,
                                     prompt_len=0)),
           (SessionSchedule, dict(rate=1.0, num_sessions=2, turns=0,
                                  vocab_size=16)),
           (DiurnalSchedule, dict(base_rate=2.0, peak_rate=1.0))]
    for cls, kw in bad:
        with pytest.raises(ValueError):
            getattr(jloadgen, cls.__name__)(**kw)
        with pytest.raises(ValueError):
            cls(**kw)


def test_percentile_matches_reference():
    rng = random.Random(3)
    cases = [[], [3.0], [1.0, 2.0, 3.0, 10.0],
             [float(i) for i in range(1, 101)]]
    cases += [[rng.random() for _ in range(rng.randrange(1, 60))]
              for _ in range(20)]
    for vals in cases:
        for p in (0, 1, 25, 50, 90, 99, 99.9, 100):
            assert percentile(vals, p) == jloadgen.percentile(vals, p)
    with pytest.raises(ValueError):
        percentile([1.0], 101)


# -------------------------------------------------------------- import
def test_router_and_loadgen_import_without_torch():
    """A router box has no accelerator stack: the router, loadgen, the
    serve package's eager slice and the route entry point load neither
    torch nor jax (the engine names resolve lazily)."""
    code = ("import sys; "
            "from triton_kubernetes_tpu_torch.serve.router import "
            "RouterHTTPServer; "
            "from triton_kubernetes_tpu_torch.serve.loadgen import "
            "PoissonSchedule; "
            "from triton_kubernetes_tpu_torch.serve import Router, "
            "SessionSchedule, SERVE_PORT, draft_ngram; "
            "import triton_kubernetes_tpu_torch.tools.route; "
            "print('torch' in sys.modules, 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False False"


# ---------------------------------------------------------- HTTP fleet
def test_router_affinity_and_jax_tokens(models, jax_tokens):
    """Two port replicas behind the port's router: every session's turns
    land on one replica and every output is the JAX engine's."""
    srvs = [ServeHTTPServer(make_engine(models)).start() for _ in range(2)]
    try:
        with RouterHTTPServer([s.url for s in srvs],
                              health_interval_s=0.2) as router:
            sched = SessionSchedule(rate=50.0, num_sessions=3, turns=3,
                                    vocab_size=50, prefix_len=8,
                                    max_new_tokens=4, seed=4)
            landed = {}
            for tr in sched:
                out = _post(router.url, {
                    "tokens": tr.tokens, "max_new_tokens": tr.max_new_tokens,
                    "session_id": tr.session_id})
                landed.setdefault(tr.session_id, set()).add(out["replica"])
                assert out["tokens"] == jax_tokens(tr.tokens,
                                                   tr.max_new_tokens)
            assert all(len(reps) == 1 for reps in landed.values()), landed
            affine = sum(metrics.counter("tk8s_route_requests_total").value(
                replica=f"r{i}", reason="affine") for i in range(2))
            assert affine == len(sched)
    finally:
        for s in srvs:
            s.stop()


@pytest.mark.parametrize("disaggregated", [False, True],
                         ids=["colocated", "prefill-decode"])
def test_reference_router_over_port_replicas(models, jax_tokens,
                                             disaggregated):
    """The wire format across the packages: the reference's router (jax-
    free) in front of port replicas gives the same tokens as the port's
    router in front of them, and both the JAX engine's -- colocated, and
    disaggregated (/generate with handoff, /migrate/out -> /migrate/in,
    /await) over a prefill and a decode replica."""
    srvs = [ServeHTTPServer(make_engine(models)).start() for _ in range(2)]
    urls = [s.url for s in srvs]
    kw = (dict(replica_urls=urls[:1], decode_urls=urls[1:])
          if disaggregated else dict(replica_urls=urls))
    try:
        results = {}
        for tag, cls, reg in (("port", RouterHTTPServer, metrics),
                              ("reference", JRouterHTTPServer, jmetrics)):
            with cls(health_interval_s=0.2, **kw) as router:
                outs = [None] * len(PROMPTS)

                def fire(i):
                    p, n = PROMPTS[i]
                    outs[i] = _post(router.url, {"tokens": p,
                                                 "max_new_tokens": n})

                threads = [threading.Thread(target=fire, args=(i,))
                           for i in range(len(PROMPTS))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
                assert not any(t.is_alive() for t in threads), tag
                results[tag] = [o["tokens"] for o in outs]
                if disaggregated:
                    assert all(o["decode_replica"] == "d0" for o in outs)
                    assert reg.counter("tk8s_route_requests_total").value(
                        replica="d0", reason="handoff") == len(PROMPTS)
        assert results["port"] == results["reference"]
        assert results["port"] == [jax_tokens(p, n) for p, n in PROMPTS]
        for s in srvs:
            assert s.loop_error is None
            s.engine.release_prefix_cache()
            assert s.engine.allocator.in_use == 0
            assert not s.engine.parked
    finally:
        for s in srvs:
            s.stop()


def _slow(engine, seconds=0.01):
    """Make each engine tick take at least ``seconds`` (so a request is
    still decoding when the test acts on it)."""
    step = engine.step

    def slow_step():
        time.sleep(seconds)
        return step()

    engine.step = slow_step
    return engine


def test_router_replica_death_relands_requests(models, jax_tokens):
    """A replica's engine loop dies mid-decode: the in-flight request gets
    503 there, re-lands on a healthy replica through the eject path and
    completes with the JAX engine's tokens; the session stays on a living
    replica and the router's /healthz stays 200."""
    srvs = [ServeHTTPServer(_slow(make_engine(models))).start()
            for _ in range(3)]
    try:
        with RouterHTTPServer([s.url for s in srvs],
                              health_interval_s=10.0) as router:
            probe = {"tokens": [7, 3, 9, 1], "max_new_tokens": 2,
                     "session_id": "victim-session"}
            first = _post(router.url, probe)
            victim_name = first["replica"]
            victim = next(s for s in srvs if s.url
                          == router.router.replicas[victim_name].url)
            slow = {"tokens": [7, 3, 9, 1, 5, 5], "max_new_tokens": 24,
                    "session_id": "victim-session"}
            got = {}
            t = threading.Thread(
                target=lambda: got.update(out=_post(router.url, slow,
                                                    timeout=90)))
            t.start()
            deadline = time.monotonic() + 30
            while not victim.engine.num_running:
                assert time.monotonic() < deadline, "never admitted"
                time.sleep(0.005)
            victim.engine.step = None  # the next tick raises
            t.join(timeout=90)
            assert not t.is_alive(), "re-landed request never completed"
            assert got["out"]["tokens"] == jax_tokens(slow["tokens"], 24)
            assert got["out"]["replica"] != victim_name
            ejects = sum(metrics.counter("tk8s_route_requests_total").value(
                replica=f"r{i}", reason="eject") for i in range(3))
            assert ejects >= 1
            assert metrics.gauge("tk8s_route_replica_healthy").value(
                replica=victim_name) == 0
            with urllib.request.urlopen(router.url + "/healthz",
                                        timeout=10) as r:
                assert r.status == 200
            again = _post(router.url, probe)
            assert again["tokens"] == first["tokens"]
            assert again["replica"] != victim_name
    finally:
        for s in srvs:
            s.stop()


def test_router_drain_keeps_the_stream(models, jax_tokens):
    """Drain a live replica through the router: its decoding session
    migrates to the peer, the original client's answer comes back
    "migrated" with the forwarding address, the router follows it, and
    the client gets the JAX engine's whole stream."""
    srvs = [ServeHTTPServer(_slow(make_engine(models))).start()
            for _ in range(2)]
    try:
        with RouterHTTPServer([s.url for s in srvs],
                              health_interval_s=10.0) as router:
            payload = {"tokens": [5, 7, 9, 11, 2], "max_new_tokens": 40,
                       "seed": 3, "session_id": "drained"}
            owner = router.router.pick(
                Router.route_key(payload))[0]
            src = next(s for s in srvs if s.url == owner.url)
            got = {}
            t = threading.Thread(
                target=lambda: got.update(out=_post(router.url, payload,
                                                    timeout=90)))
            t.start()
            deadline = time.monotonic() + 30
            while not _get(src.url + "/stats")["sessions"]:
                assert time.monotonic() < deadline, "never exportable"
                time.sleep(0.005)
            drained = router.router.drain_replica(owner.name)
            t.join(timeout=90)
            assert not t.is_alive()
            assert len(drained["migrated"]) == 1 and not drained["failed"]
            out = got["out"]
            assert out["tokens"] == jax_tokens(payload["tokens"], 40, seed=3)
            assert out["finish_reason"] == "length"
            assert metrics.counter("tk8s_serve_migrations_total").value(
                direction="out", reason="drain", status="ok") == 1
            for s in srvs:
                assert s.loop_error is None
                s.engine.release_prefix_cache()
                assert s.engine.allocator.in_use == 0
    finally:
        for s in srvs:
            s.stop()


def test_router_http_surface(models):
    """/stats, /metrics, and 400 passthrough for malformed bodies."""
    srv = ServeHTTPServer(make_engine(models)).start()
    try:
        with RouterHTTPServer([srv.url]) as router:
            stats = _get(router.url + "/stats")
            assert stats["replicas"]["r0"]["healthy"] is True
            assert set(stats) == {"spill_threshold", "replicas"}
            assert set(stats["replicas"]["r0"]) == {
                "url", "healthy", "in_flight", "requests", "timeouts"}
            with urllib.request.urlopen(router.url + "/metrics") as r:
                prom = r.read().decode()
            assert "tk8s_route_replica_healthy" in prom
            for bad in ({"tokens": [1, -4], "max_new_tokens": 2},
                        {"tokens": [1], "max_new_tokens": 2,
                         "session_id": 7}):
                with pytest.raises(urllib.error.HTTPError) as err:
                    _post(router.url, bad)
                assert err.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(router.url, {"replica": "r9"}, path="/drain")
            assert err.value.code == 404
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(router.url, {}, path="/nope")
            assert err.value.code == 404
    finally:
        srv.stop()


def test_router_trace_propagation_and_route_spans(models, tmp_path):
    """The router mints seeded trace ids for headerless requests,
    propagates a caller's X-TK8S-Trace untouched, and records each
    placement as a route.place span under the id the replica's own trace
    file carries too."""
    from triton_kubernetes_tpu_torch.utils.trace import (
        TraceWriter, mint_trace_id, read_trace_jsonl)

    srv = ServeHTTPServer(make_engine(models)).start()
    replica_jsonl = str(tmp_path / "replica.jsonl")
    replica_writer = TraceWriter(replica_jsonl, "replica-0")
    srv.engine.flight.writer = replica_writer
    router_jsonl = str(tmp_path / "router.jsonl")
    router_writer = TraceWriter(router_jsonl, "router")
    try:
        with RouterHTTPServer([srv.url], trace_seed=11,
                              trace=router_writer) as router:
            out = _post(router.url, {"tokens": [5, 7, 9],
                                     "max_new_tokens": 3})
            want = mint_trace_id(random.Random(11))
            assert out["trace_id"] == want
            assert out["phases"]["prefill_s"] > 0
            req = urllib.request.Request(
                router.url + "/generate",
                data=json.dumps({"tokens": [5, 7, 9],
                                 "max_new_tokens": 3}).encode(),
                headers={"Content-Type": "application/json",
                         "X-TK8S-Trace": "t-upstream"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert json.loads(r.read())["trace_id"] == "t-upstream"
    finally:
        srv.stop()
        replica_writer.close()
        router_writer.close()
    _, route_events = read_trace_jsonl(router_jsonl)
    places = [e for e in route_events if e["name"] == "route.place"]
    assert {e["trace"] for e in places} == {want, "t-upstream"}
    for e in places:
        assert e["fields"]["reason"] == "affine"
        assert e["fields"]["status"] == 200
    _, serve_events = read_trace_jsonl(replica_jsonl)
    assert {want, "t-upstream"} <= {e.get("trace") for e in serve_events}


def test_router_passes_replica_timeout_through_without_eject(models):
    """A replica's own 504 is slow, not dead: the router returns the 504,
    keeps the replica in rotation, counts no placement and surfaces the
    timeout in /stats."""
    srv = ServeHTTPServer(make_engine(models), request_timeout_s=0.01)
    srv.start()
    try:
        with RouterHTTPServer([srv.url], health_interval_s=10.0) as router:
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(router.url, {"tokens": [1, 2, 3],
                                   "max_new_tokens": 16})
            assert err.value.code == 504
            assert router.router.replicas["r0"].healthy is True
            assert router.router.replicas["r0"].timeouts == 1
            assert metrics.gauge("tk8s_route_replica_healthy").value(
                replica="r0") == 1
            assert metrics.counter("tk8s_route_requests_total").value(
                replica="r0", reason="affine") == 0
    finally:
        srv.stop()


def _events(path):
    with open(path) as f:
        return [rec for rec in map(json.loads, f)
                if rec.get("type") == "event"]


def test_router_abort_inflight_and_total_failure_terminate(tmp_path):
    """A request blocked in forward() when the router dies is flushed as a
    route.abort terminal; with every replica unreachable the failed
    placements end in one too -- the merged timeline stays complete."""
    from triton_kubernetes_tpu_torch.utils.trace import (
        TraceWriter, validate_chaos_trace)

    path = str(tmp_path / "router.jsonl")
    writer = TraceWriter(path, role="router")
    router = Router(["http://127.0.0.1:1"], trace=writer)
    flushed = []

    def post_then_die(url, body, trace_id=None):
        flushed.append(router.abort_inflight("router shutting down"))
        return 200, {"type": "generate", "tokens": [1]}

    router._post = post_then_die
    status, _ = router.forward({"tokens": [1, 2], "max_new_tokens": 1},
                               trace_id="cafe1234cafe1234")
    assert status == 200 and flushed == [1]
    dead = Router(["http://127.0.0.1:1", "http://127.0.0.1:2"],
                  trace=writer)
    dead._post = lambda url, body, trace_id=None: (
        -1, {"type": "error", "message": "unreachable"})
    status, _ = dead.forward({"tokens": [3], "max_new_tokens": 1},
                             trace_id="beef5678beef5678")
    assert status == 503
    assert all(not r.healthy for r in dead.replicas.values())
    writer.close()
    names = [(e["name"], e["trace"]) for e in _events(path)]
    assert names == [("route.abort", "cafe1234cafe1234"),
                     ("route.place", "cafe1234cafe1234"),
                     ("route.place", "beef5678beef5678"),
                     ("route.place", "beef5678beef5678"),
                     ("route.abort", "beef5678beef5678")]
    assert validate_chaos_trace([path]) == []
