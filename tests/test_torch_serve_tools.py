"""The serve and route entry points of the port, and the pieces they pin.

* ``python -m triton_kubernetes_tpu_torch.tools.serve --device cpu`` and
  ``tools.route`` over it, as subprocesses: each prints its URL line,
  serves ``/healthz``, ``/generate`` and ``/metrics``, and on SIGTERM exits
  143 with its ``--trace-jsonl`` closed (the goodput ledger validates).
* The serve entry point's validation exits (2) are the reference's.
* ``constants.py`` and the HTTP and router metric families equal the
  reference's; the serve package exports every name the reference's does.
* The entry point's default window (256 tokens) is wider than
  ``llama-test``'s 128 positions: the port's engine gives the JAX engine's
  tokens there too (the reference's gather clamps the pad rows' positions).
"""

import json
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

import triton_kubernetes_tpu.constants as jconstants
import triton_kubernetes_tpu.serve as jserve
from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu.serve import Request as JRequest
from triton_kubernetes_tpu.serve import ServeEngine as JServeEngine
from triton_kubernetes_tpu.utils import metrics as jmetrics
import triton_kubernetes_tpu_torch.constants as constants
import triton_kubernetes_tpu_torch.serve as serve
from triton_kubernetes_tpu_torch.models import (
    from_numpy_params,
    get_config,
    init_params,
)
from triton_kubernetes_tpu_torch.serve import Request, ServeEngine
from triton_kubernetes_tpu_torch.tools import route as route_tool
from triton_kubernetes_tpu_torch.tools import serve as serve_tool
from triton_kubernetes_tpu_torch.utils import metrics
from triton_kubernetes_tpu_torch.utils.trace import (
    read_trace_jsonl,
    validate_goodput_trace,
)

ROOT = Path(__file__).resolve().parent.parent
PROMPTS = [([5, 7, 9, 11, 2, 4, 6, 8], 6), ([3, 1, 4], 5)]


def _post(url, payload):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _start(module, *args):
    """A long-running entry point and the URL from its first line."""
    proc = subprocess.Popen(
        [sys.executable, "-m", f"triton_kubernetes_tpu_torch.tools.{module}",
         *args], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    line = proc.stdout.readline()
    if " on http://" not in line:
        proc.kill()
        raise AssertionError(f"{module}: {line!r} {proc.stderr.read()}")
    return proc, line.split(" on ")[1].split()[0]


def test_serve_and_route_entry_points(tmp_path):
    serve_jsonl, route_jsonl = tmp_path / "s.jsonl", tmp_path / "r.jsonl"
    procs = []
    try:
        srv, url = _start("serve", "--device", "cpu", "--model", "llama-test",
                          "--port", "0", "--trace-jsonl", str(serve_jsonl))
        procs.append(srv)
        rt, rurl = _start("route", "--replica", url, "--port", "0",
                          "--trace-jsonl", str(route_jsonl))
        procs.append(rt)
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True,
                                            "model": "llama-test"}
        # The replica's model is the port's init at --seed 0 under the
        # entry point's defaults.
        cfg = get_config("llama-test")
        engine = ServeEngine(init_params(cfg, seed=0, device="cpu"), cfg,
                             num_blocks=256, max_batch=8, prefill_chunk=256,
                             prefix_cache=True, device="cpu")
        for i, (p, n) in enumerate(PROMPTS):
            engine.submit(Request(f"r{i}", p, n))
        want = {d.request_id: d.tokens for d in engine.run_until_idle()}
        for i, (p, n) in enumerate(PROMPTS):
            direct = _post(url, {"tokens": p, "max_new_tokens": n})
            routed = _post(rurl, {"tokens": p, "max_new_tokens": n})
            assert direct["tokens"] == routed["tokens"] == want[f"r{i}"]
            assert routed["replica"] == "r0"
        for u, family in ((url, "tk8s_serve_http_requests_total"),
                          (rurl, "tk8s_route_requests_total")):
            with urllib.request.urlopen(u + "/metrics", timeout=30) as r:
                assert family in metrics.parse_prometheus(
                    r.read().decode())
        for proc in (rt, srv):
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 143
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            proc.stdout.close()
            proc.stderr.close()
    # Closed on SIGTERM: the ledgers partition each process's wall window.
    assert validate_goodput_trace([str(serve_jsonl)]) == []
    assert validate_goodput_trace([str(route_jsonl)]) == []
    _, events = read_trace_jsonl(str(route_jsonl))
    assert sum(e["name"] == "route.place" for e in events) == len(PROMPTS)
    _, events = read_trace_jsonl(str(serve_jsonl))
    assert sum(e["name"] == "serve.finish" for e in events) == 2 * len(
        PROMPTS)


@pytest.mark.parametrize("argv", [
    ["--prefill-chunk", "5"],
    ["--prefill-chunk", "-16"],
    ["--prefill-chunk", "0", "--prefix-cache"],
    ["--spec-k", "-1"],
], ids=["not-a-block-multiple", "negative-chunk", "prefix-without-chunk",
        "negative-spec-k"])
def test_serve_entry_point_refuses_bad_flags(argv, capsys):
    assert serve_tool.main(["--device", "cpu", *argv]) == 2
    assert "(kind=ValueError)" in capsys.readouterr().err


def test_entry_points_refuse_unknown_model_and_bad_router():
    assert serve_tool.main(["--device", "cpu", "--model", "nope"]) == 1
    assert route_tool.main(["--replica", "http://127.0.0.1:1", "--port",
                            "0", "--spill-threshold", "0"]) == 2


def test_constants_match_reference():
    for name in ("SERVE_PORT", "ROUTE_PORT", "KV_DTYPES", "WEIGHT_DTYPES",
                 "MATMUL_DTYPES"):
        assert getattr(constants, name) == getattr(jconstants, name), name
    assert serve.SERVE_PORT == jserve.SERVE_PORT


@pytest.mark.parametrize("family", [
    "tk8s_serve_http_requests_total", "tk8s_route_requests_total",
    "tk8s_route_replica_healthy"])
def test_http_and_route_families_match_reference_catalog(family):
    assert metrics.CATALOG[family] == jmetrics.CATALOG[family]


def test_serve_package_exports_match_reference():
    assert set(jserve.__all__) <= set(serve.__all__)
    for name in jserve.__all__:
        assert getattr(serve, name) is not None, name


def test_window_wider_than_model_matches_jax_engine():
    """block 16, prefill_chunk 256 and the prefix cache (the entry point's
    defaults) on a model of 128 positions: the JAX engine's tokens."""
    jcfg = jget_config("llama-test")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("llama-test")
    model = from_numpy_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    kw = dict(block_size=16, num_blocks=64, max_batch=4, prefill_chunk=256,
              prefix_cache=True)
    jeng = JServeEngine(jparams, jcfg, **kw)
    teng = ServeEngine(model, cfg, device="cpu", **kw)
    for i, (p, n) in enumerate(PROMPTS + [(list(range(1, 100)), 20)]):
        jeng.submit(JRequest(f"r{i}", p, n))
        teng.submit(Request(f"r{i}", p, n))
    want = {d.request_id: d.tokens for d in jeng.run_until_idle()}
    got = {d.request_id: d.tokens for d in teng.run_until_idle()}
    assert got == want
