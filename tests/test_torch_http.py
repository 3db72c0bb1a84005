"""Port parity for the serving HTTP front end (``serve/server.py``).

* Tokens through a port ``ServeHTTPServer`` (``device="cpu"``) equal the
  JAX engine's for the churn prompts, fired one at a time and all at once
  (continuous batching), on a roomy pool and on one tight enough to
  preempt: exact token equality, as in ``test_torch_serve.py``.
* The wire surface answers as the reference's does: the same status codes
  (400 on a bad body, 404, 503 after the engine loop dies, 504 on a
  request timeout, 502 when a migration's destination refuses, 409) with
  the same body keys; ``/metrics`` carries the JAX engine's families plus
  the HTTP counter; ``/stats`` the reference's keys (the port adds some).
* The migration plane between two port replicas: handoff -> ``/migrate/out``
  -> ``/await`` keeps the JAX engine's stream, a torn ``/migrate/in`` body
  is refused with 400, an unreachable destination degrades to
  ``/resume``; ``DcnTransferModel`` charges the reference's latencies.
* The engine loop refuses to run off the device's default stream.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu.serve import ManualClock as JClock
from triton_kubernetes_tpu.serve import Request as JRequest
from triton_kubernetes_tpu.serve import ServeEngine as JServeEngine
from triton_kubernetes_tpu.serve.server import \
    DcnTransferModel as JDcnTransferModel
from triton_kubernetes_tpu.serve.server import \
    _finished_body as j_finished_body
from triton_kubernetes_tpu.utils import metrics as jmetrics
from triton_kubernetes_tpu_torch.models import from_numpy_params, get_config
from triton_kubernetes_tpu_torch.serve import (
    DcnTransferModel,
    ManualClock,
    ServeEngine,
    ServeHTTPServer,
)
from triton_kubernetes_tpu_torch.serve import server as server_mod
from triton_kubernetes_tpu_torch.utils import metrics

ENGINE_KW = dict(block_size=4, num_blocks=40, max_batch=4, max_model_len=64)
CHURN = [
    ([5, 7, 9, 11, 2, 4, 6, 8], 16),
    ([3, 1, 4, 1, 5, 9, 2, 6], 16),
    ([2, 2, 2], 5),
    ([9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 1, 2, 3], 7),
]
# A pool tight enough that the two 16-token generators collide mid-decode.
TIGHT = dict(num_blocks=10, max_batch=3, max_model_len=32)
ERROR_KEYS = {"type", "message"}


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
def jax_solo(models):
    """The JAX engine's FinishedRequest for a request run alone."""
    (jparams, jcfg), _ = models
    engine = JServeEngine(jparams, jcfg, clock=JClock(tick=0.001),
                          **ENGINE_KW)
    memo = {}

    def run(prompt, n, seed=0):
        key = (tuple(prompt), n, seed)
        if key not in memo:
            engine.submit(JRequest("solo", list(prompt), n, seed=seed))
            (memo[key],) = engine.run_until_idle()
        return memo[key]

    return run


def make_engine(models, **over):
    _, (model, cfg) = models
    kw = dict(ENGINE_KW, clock=ManualClock(tick=0.001))
    kw.update(over)
    return ServeEngine(model, cfg, device="cpu", **kw)


def _post(url, payload, path="/generate", timeout=60.0, headers=None):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _refused(fn, *args, **kw):
    """(status, body) of a request that must fail."""
    with pytest.raises(urllib.error.HTTPError) as err:
        fn(*args, **kw)
    return err.value.code, json.loads(err.value.read())


# ---------------------------------------------------------------- tokens
@pytest.mark.parametrize("pool", ["roomy", "tight"])
def test_http_churn_tokens_match_jax_engine(models, jax_solo, pool):
    """Sequential, then all four at once (batched together by the engine
    loop; on the tight pool one is preempted): every stream is the JAX
    engine's."""
    want = [jax_solo(p, n).tokens for p, n in CHURN]
    engine = make_engine(models, **(TIGHT if pool == "tight" else {}))
    with ServeHTTPServer(engine) as srv:
        for (p, n), w in zip(CHURN, want):
            assert _post(srv.url, {"tokens": p, "max_new_tokens": n}
                         )["tokens"] == w
        outs = [None] * len(CHURN)
        step = engine.step

        def first_step_waits():
            # All four reach the loop before the batch gets going: on the
            # tight pool any three of them outgrow its 9 pages together.
            time.sleep(0.2)
            engine.step = step
            return step()

        engine.step = first_step_waits

        def hit(i):
            p, n = CHURN[i]
            outs[i] = _post(srv.url, {"tokens": p, "max_new_tokens": n})

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(CHURN))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "a request hung"
        assert [o["tokens"] for o in outs] == want
        assert srv.loop_error is None
    assert engine.allocator.in_use == 0
    if pool == "tight":
        assert metrics.counter("tk8s_serve_preemptions_total").value() >= 1


# --------------------------------------------------------- wire surface
def test_http_generate_healthz_metrics_stats(models, jax_solo):
    want = jax_solo([5, 7, 9, 11, 2], 6)
    metrics.configure()
    jmetrics.configure()
    (jparams, jcfg), _ = models
    jeng = JServeEngine(jparams, jcfg, clock=JClock(tick=0.001), **ENGINE_KW)
    jeng.submit(JRequest("req-0", [5, 7, 9, 11, 2], 6))
    jeng.run_until_idle()
    with ServeHTTPServer(make_engine(models)) as srv:
        out = _post(srv.url, {"tokens": [5, 7, 9, 11, 2],
                              "max_new_tokens": 6})
        assert out["tokens"] == want.tokens
        assert out["finish_reason"] == "length"
        assert out["ttft_s"] > 0
        # The tracing ride-alongs appear where a served engine has its
        # recorder: the reference's body keys with trace id and phases.
        assert set(out) == set(j_finished_body(want)) | {
            "trace_id", "phases", "e2e_s"}

        h = _get(srv.url + "/healthz")
        assert h == {"ok": True, "model": "llama-test"}

        stats = _get(srv.url + "/stats")
        assert stats["kv_blocks_in_use"] == 0
        assert set(jeng.stats()) <= set(stats)
        assert set(stats["kernel_launches"]) >= {
            "paged_decode", "paged_verify", "paged_prefill", "decode_gemm"}

        with urllib.request.urlopen(srv.url + "/metrics") as r:
            assert "version=0.0.4" in r.headers["Content-Type"]
            text = r.read().decode()
        assert "# TYPE tk8s_serve_ttft_seconds histogram" in text
        assert 'tk8s_serve_requests_total{outcome="length"} 1' in text
        assert "tk8s_serve_http_requests_total" in text
        for line in text.splitlines():
            assert line.startswith("#") or " " in line
        families = set(metrics.parse_prometheus(text))
        jfamilies = set(metrics.parse_prometheus(
            jmetrics.get_registry().render_prometheus()))
        assert families == jfamilies | {"tk8s_serve_http_requests_total"}


def test_http_rejects_bad_requests(models):
    with ServeHTTPServer(make_engine(models)) as srv:
        for payload in ({"tokens": "nope"},
                        {"tokens": [1], "max_new_tokens": 0},
                        {"tokens": [1] * 60, "max_new_tokens": 10},
                        {"tokens": [999999]},
                        {"tokens": [1], "temperature": None},
                        {"tokens": [1], "max_new_tokens": [5]},
                        {"tokens": [1], "eos_id": "x"},
                        {"tokens": [1], "session_id": 3},
                        [1, 2]):
            code, body = _refused(_post, srv.url, payload)
            assert code == 400 and set(body) == ERROR_KEYS, payload
        for method in ("GET", "POST"):
            req = urllib.request.Request(
                srv.url + "/nope", method=method,
                data=b"{}" if method == "POST" else None)
            code, body = _refused(urllib.request.urlopen, req)
            assert code == 404 and set(body) == ERROR_KEYS
    http = metrics.counter("tk8s_serve_http_requests_total")
    assert http.value(route="/generate", method="POST", code="400") == 9
    assert http.value(route="other", method="GET", code="404") == 1


def test_http_engine_loop_death_flips_healthz(models):
    """A crashed scheduler fails liveness and releases blocked clients as
    503 -- never a 200 from a zombie."""
    srv = ServeHTTPServer(make_engine(models))
    srv.engine.step = None  # the loop's next step() raises
    with srv:
        code, body = _refused(_post, srv.url,
                              {"tokens": [1, 2, 3], "max_new_tokens": 4})
        assert code == 503 and set(body) == ERROR_KEYS
        code, body = _refused(_get, srv.url + "/healthz")
        assert code == 503
        assert set(body) == {"ok", "error", "model"}
        assert body["ok"] is False and body["error"]
        # Later traffic, the migration plane included, is refused too.
        code, _ = _refused(_post, srv.url,
                           {"tokens": [1], "max_new_tokens": 1})
        assert code == 503
        code, _ = _refused(_post, srv.url, {"request_id": "req-0",
                                            "dest": "http://x"},
                           path="/migrate/out")
        assert code == 503


def test_http_loop_death_flushes_flight_recorder(models):
    """A dead engine loop keeps the killed requests' partial lifecycles:
    they land in the recorder as ``aborted`` traces."""
    srv = ServeHTTPServer(make_engine(models))
    srv.engine.step = None
    with srv:
        code, _ = _refused(_post, srv.url,
                           {"tokens": [1, 2, 3], "max_new_tokens": 4})
        assert code == 503
        flight = srv.engine.flight
        deadline = time.monotonic() + 5.0
        while not flight.finished and time.monotonic() < deadline:
            time.sleep(0.01)
        assert flight.finished, "no post-mortem trace flushed"
        rec = flight.finished[-1]
        assert rec.outcome == "aborted"
        assert any(e["name"] == "serve.abort" for e in rec.events)
        assert sum(rec.phases.values()) == pytest.approx(rec.e2e_s)


def test_http_request_timeout_is_504(models):
    """A per-request timeout is not engine death: 504, and the replica
    stays healthy."""
    with ServeHTTPServer(make_engine(models), request_timeout_s=0.01) as srv:
        code, body = _refused(_post, srv.url, {"tokens": [1, 2, 3],
                                               "max_new_tokens": 16})
        assert code == 504 and set(body) == ERROR_KEYS
        assert _get(srv.url + "/healthz")["ok"] is True


def test_http_trace_header_phases_and_exemplars(models):
    metrics.configure()
    with ServeHTTPServer(make_engine(models)) as srv:
        out = _post(srv.url, {"tokens": [5, 7, 9, 11, 2],
                              "max_new_tokens": 6},
                    headers={"X-TK8S-Trace": "t-wire-1"})
        assert out["trace_id"] == "t-wire-1"
        assert set(out["phases"]) == {"queue_s", "prefill_s", "decode_s",
                                      "recompute_s", "migrate_out_s",
                                      "migrate_in_s"}
        assert sum(out["phases"].values()) > 0
        # Headerless (and invalid-header) traffic traces under the local id.
        for headers in (None, {"X-TK8S-Trace": "bad id!"}):
            out2 = _post(srv.url, {"tokens": [5, 7, 9], "max_new_tokens": 2},
                         headers=headers)
            assert out2["trace_id"] == out2["request_id"]
        stats = _get(srv.url + "/stats")
        finished = stats["tracing"]["finished"]
        assert "t-wire-1" in {f["trace_id"] for f in finished}
        assert stats["tracing"]["in_flight"] == 0
        with urllib.request.urlopen(
                srv.url + "/metrics?format=openmetrics") as r:
            assert "openmetrics-text" in r.headers["Content-Type"]
            text = r.read().decode()
        assert text.rstrip().endswith("# EOF")
        assert "tk8s_serve_ttft_seconds_bucket" in text
        assert '# {trace_id="' in text
        with urllib.request.urlopen(srv.url + "/metrics") as r:
            plain = r.read().decode()
        assert "# {" not in plain
        metrics.parse_prometheus(plain)


def test_engine_loop_refuses_a_side_stream(models, monkeypatch):
    """The kernels' arrival counters are shared by every launch on a
    device: an engine loop whose current stream is not the device's
    default stream dies at once (503 and /healthz 503), before any tick."""
    engine = make_engine(models)
    engine.device = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: "side")
    monkeypatch.setattr(torch.cuda, "default_stream",
                        lambda d=None: "default")
    with ServeHTTPServer(engine) as srv:
        deadline = time.monotonic() + 5.0
        while srv.loop_error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert "default stream" in (srv.loop_error or "")
        code, _ = _refused(_get, srv.url + "/healthz")
        assert code == 503
    assert engine._steps == 0
    server_mod.require_default_stream(torch.device("cpu"))


# ------------------------------------------------------- migration plane
def test_http_handoff_migrate_await_roundtrip(models, jax_solo):
    want = jax_solo([5, 7, 9, 11, 2], 6, seed=4).tokens
    with ServeHTTPServer(make_engine(models)) as src, \
            ServeHTTPServer(make_engine(models)) as dst:
        out = _post(src.url, {"tokens": [5, 7, 9, 11, 2],
                              "max_new_tokens": 6, "seed": 4,
                              "handoff": True})
        assert out["finish_reason"] == "handoff"
        assert out["tokens"] == want[:1]
        mig = _post(src.url, {"request_id": out["request_id"],
                              "dest": dst.url, "reason": "handoff"},
                    path="/migrate/out")
        assert set(mig) == {"request_id", "dest_request_id", "bytes"}
        assert mig["bytes"] > 0
        awaited = _post(dst.url, {"request_id": mig["dest_request_id"]},
                        path="/await")
        assert awaited["tokens"] == want
        assert awaited["finish_reason"] in ("length", "eos")
        # Awaited once: the destination forgets it.
        code, body = _refused(_post, dst.url,
                              {"request_id": mig["dest_request_id"]},
                              path="/await")
        assert code == 404 and set(body) == ERROR_KEYS
        assert src.engine.allocator.in_use == 0 and not src.engine.parked


def test_http_migration_plane_status_codes(models):
    """Bad bodies are 400, unknown sessions 404, a session with a live
    client cannot be resumed by hand (404), a payload for another model
    409 -- the reference's codes."""
    with ServeHTTPServer(make_engine(models)) as srv, \
            ServeHTTPServer(make_engine(models, block_size=8)) as other:
        for path in ("/migrate/out", "/await", "/resume"):
            code, body = _refused(_post, srv.url, {}, path=path)
            assert code == 400 and set(body) == ERROR_KEYS, path
        code, _ = _refused(_post, srv.url, {"request_id": "nope",
                                            "dest": other.url},
                           path="/migrate/out")
        assert code == 404
        code, _ = _refused(_post, srv.url, {"request_id": "nope"},
                           path="/resume")
        assert code == 404
        out = _post(srv.url, {"tokens": [5, 7, 9, 11], "max_new_tokens": 4,
                              "handoff": True})
        mig_req = urllib.request.Request(
            other.url + "/migrate/in",
            data=srv.engine.export_session(out["request_id"]),
            headers={"Content-Type": "application/octet-stream"})
        code, body = _refused(urllib.request.urlopen, mig_req, timeout=30)
        assert code == 409 and body["torn"] is False


def test_http_torn_body_rejected_with_400(models):
    with ServeHTTPServer(make_engine(models)) as src, \
            ServeHTTPServer(make_engine(models)) as dst:
        out = _post(src.url, {"tokens": [5, 7, 9, 11], "max_new_tokens": 4,
                              "handoff": True})
        mig_req = urllib.request.Request(
            dst.url + "/migrate/in", data=b"TK8SKV1\n not a payload",
            headers={"Content-Type": "application/octet-stream"})
        code, body = _refused(urllib.request.urlopen, mig_req, timeout=30)
        assert code == 400
        assert set(body) == {"type", "torn", "message"}
        assert body["torn"] is True
        assert dst.engine.allocator.in_use == 0
        # The source still owns the session: /resume finishes locally.
        resumed = _post(src.url, {"request_id": out["request_id"]},
                        path="/resume")
        assert len(resumed["tokens"]) == 4


def test_http_unreachable_dest_degrades_to_resume(models, jax_solo):
    want = jax_solo([5, 7, 9, 11, 2], 6, seed=6).tokens
    with ServeHTTPServer(make_engine(models)) as src:
        out = _post(src.url, {"tokens": [5, 7, 9, 11, 2],
                              "max_new_tokens": 6, "seed": 6,
                              "handoff": True})
        code, body = _refused(_post, src.url,
                              {"request_id": out["request_id"],
                               "dest": "http://127.0.0.1:9",
                               "reason": "handoff"}, path="/migrate/out")
        assert code == 502
        assert set(body) == {"type", "error", "request_id", "resumed"}
        assert body["resumed"] is False  # parked, awaiting /resume
        resumed = _post(src.url, {"request_id": out["request_id"]},
                        path="/resume")
        assert resumed["tokens"] == want
    assert metrics.counter("tk8s_serve_migrations_total").value(
        direction="out", reason="handoff", status="error") == 1


def test_http_migration_charges_dcn_transfer_and_metric(models, jax_solo):
    """With a DcnTransferModel the ship charges rtt + bytes / bandwidth
    through the injected sleeper, the transfer-seconds histogram observes
    at least that, and the tokens are unchanged."""
    want = jax_solo([5, 7, 9, 11, 2], 6, seed=4).tokens
    slept = []
    dcn = DcnTransferModel(bytes_per_s=1e9, rtt_s=0.002, sleep=slept.append)
    with ServeHTTPServer(make_engine(models), dcn=dcn) as src, \
            ServeHTTPServer(make_engine(models)) as dst:
        out = _post(src.url, {"tokens": [5, 7, 9, 11, 2],
                              "max_new_tokens": 6, "seed": 4,
                              "handoff": True})
        mig = _post(src.url, {"request_id": out["request_id"],
                              "dest": dst.url, "reason": "handoff"},
                    path="/migrate/out")
        awaited = _post(dst.url, {"request_id": mig["dest_request_id"]},
                        path="/await")
        assert awaited["tokens"] == want
    assert slept == [0.002 + mig["bytes"] / 1e9]
    h = metrics.histogram("tk8s_serve_migration_transfer_seconds")
    assert h.count() == 1


def test_dcn_transfer_model_matches_reference():
    """The same parameters and seed charge the reference's latencies, in
    the same sequence (seeded jitter), and round-trip the same dicts."""
    specs = [dict(), dict(bytes_per_s=1e9), dict(rtt_s=0.004),
             dict(bytes_per_s=2.5e8, rtt_s=0.001, jitter_s=0.003, seed=7)]
    sizes = [0, 1, 37_600_000, 73_400_000, 123]
    for spec in specs:
        got, want = [], []
        model = DcnTransferModel(sleep=got.append, **spec)
        jmodel = JDcnTransferModel(sleep=want.append, **spec)
        charged = [model.apply(n) for n in sizes]
        assert charged == [jmodel.apply(n) for n in sizes]
        assert got == want
        assert model.to_dict() == jmodel.to_dict()
        again = DcnTransferModel.from_dict(model.to_dict())
        assert again.to_dict() == model.to_dict()
    for bad in (dict(bytes_per_s=-1), dict(rtt_s=-1), dict(jitter_s=-1)):
        with pytest.raises(ValueError):
            DcnTransferModel(**bad)
