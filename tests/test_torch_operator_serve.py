"""The port's operator against what it acts on, on the CPU.

* ``http_rebalancer`` against two port ``ServeHTTPServer`` replicas at
  ``llama-test``: the reconciler's rebalance leg moves a decode-ready
  session from the pressured replica to the idle one over
  ``/migrate/out``, and the moved session's tokens are the JAX engine's
  for the same request run alone; its ``noop`` and ``failed`` answers
  are the reference's on the same replicas.
* a local train actuator (``relaunch_actuator`` below, as the reference's
  evidence harness relaunches): the train-fleet policy replaces a gloo
  world of 2, shrinks it to 1 after a loss and regrows it to 2 through
  ``parallel/multihost.launch_trainers``, each launch resuming the
  previous one's checkpoint (``--resume --elastic``).
* The pool repair (``workflows/repair.py``): a preempted GPU pool comes
  back with its labels; the reference's typed refusals.
* ``tools.operate`` in-process: a local-backend document converges; a
  bad flag or an unknown document exits 2; the operator endpoint, the
  JSONL journal and the trace spans on the injected clock.
* ``jobset_actuator`` renders the resized Job of a GPU pool with the
  elastic resume command; ``file_train_status`` reads a torn file as no
  signal.
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from triton_kubernetes_tpu import operator as jop
from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu.serve import ManualClock as JClock
from triton_kubernetes_tpu.serve import Request as JRequest
from triton_kubernetes_tpu.serve import ServeEngine as JServeEngine
from triton_kubernetes_tpu.utils import metrics as jmetrics
from triton_kubernetes_tpu_torch import operator as pop
from triton_kubernetes_tpu_torch.backends import LocalBackend, MemoryBackend
from triton_kubernetes_tpu_torch.executor import LocalExecutor
from triton_kubernetes_tpu_torch.executor import engine as pengine
from triton_kubernetes_tpu_torch.executor.cloudsim import CloudSimulator
from triton_kubernetes_tpu_torch.executor.dagspec import document_from_spec
from triton_kubernetes_tpu_torch.executor.engine import (
    load_executor_state,
    save_executor_state,
)
from triton_kubernetes_tpu_torch.models import from_numpy_params, get_config
from triton_kubernetes_tpu_torch.serve import (
    ManualClock,
    ServeEngine,
    ServeHTTPServer,
)
from triton_kubernetes_tpu_torch.tools import operate as operate_tool
from triton_kubernetes_tpu_torch.utils import metrics
from triton_kubernetes_tpu_torch.utils.logging import Logger
from triton_kubernetes_tpu_torch.workflows import (
    NoPreemptedSlicesError,
    WorkflowError,
    repair_slice_auto,
)

ENGINE_KW = dict(block_size=4, num_blocks=40, max_batch=4, max_model_len=64)
TOPO = {"manager": {"provider": "bare-metal", "name": "m1"},
        "clusters": [{"provider": "gcp-gpu", "name": "ml",
                      "pools": [{"name": "pool0",
                                 "accelerator": "h100-16"}]}]}


@pytest.fixture(autouse=True)
def fresh_registries():
    """Fresh metrics registries, and the executor's in-process state
    store emptied for the test and given back after it."""
    saved = dict(pengine._MEMORY_STATES)
    pengine._MEMORY_STATES.clear()
    metrics.configure()
    jmetrics.configure()
    yield
    metrics.configure()
    jmetrics.configure()
    pengine._MEMORY_STATES.clear()
    pengine._MEMORY_STATES.update(saved)


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("llama-test")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("llama-test")
    model = from_numpy_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return (jparams, jcfg), (model, cfg)


def make_engine(models):
    _, (model, cfg) = models
    return ServeEngine(model, cfg, device="cpu",
                       clock=ManualClock(tick=0.001), **ENGINE_KW)


def _post(url, payload, path="/generate"):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def quiet_executor():
    return LocalExecutor(log=lambda m: None,
                         logger=Logger(stream=io.StringIO()))


def world(name, topo=TOPO):
    backend = MemoryBackend()
    backend.persist(document_from_spec(topo, name))
    return backend, quiet_executor()


def counting_clock():
    ticks = iter(range(1, 100000))
    return lambda: float(next(ticks))


def replica_source(engine):
    """One replica's KV pressure as Prometheus text: the replicas share
    this process's registry, so each source renders its own engine's
    utilization gauge."""
    def render():
        reg = metrics.MetricsRegistry()
        reg.gauge("tk8s_serve_kv_block_utilization").set(
            engine.allocator.in_use / max(1, engine.allocator.capacity))
        reg.gauge("tk8s_serve_queue_depth").set(len(engine.waiting))
        return reg.render_prometheus()
    return render


# ---------------------------------------------------------- rebalance


def test_http_rebalancer_moves_a_decode_ready_session(models):
    (jparams, jcfg), _ = models
    prompt, n, seed = [5, 7, 9, 11, 2, 4, 6, 8, 3], 8, 4
    jeng = JServeEngine(jparams, jcfg, clock=JClock(tick=0.001),
                        **ENGINE_KW)
    jeng.submit(JRequest("solo", prompt, n, seed=seed))
    (want,) = jeng.run_until_idle()
    with ServeHTTPServer(make_engine(models)) as src, \
            ServeHTTPServer(make_engine(models)) as dst:
        urls = [src.url + "/metrics", dst.url + "/metrics"]
        # Nothing exportable yet: both packages' rebalancers say noop,
        # and an index past the URL list is a failure.
        for i, op in enumerate((jop, pop)):
            act = op.http_rebalancer(urls)
            decision = op.RebalanceDecision(0, 1, 0.5)
            assert act(decision) == {
                "status": "noop", "error": "no exportable session on source"}
            assert act(op.RebalanceDecision(0, 5, 0.5))["status"] == "failed"
        dead = pop.http_rebalancer(["http://127.0.0.1:9/metrics", urls[1]],
                                   timeout_s=2.0)
        assert dead(pop.RebalanceDecision(0, 1, 0.5))["status"] == "failed"
        # A handed-off session: prefilled, parked, decode-ready.
        out = _post(src.url, {"tokens": prompt, "max_new_tokens": n,
                              "seed": seed, "handoff": True})
        assert out["finish_reason"] == "handoff"
        backend, ex = world("op-rebalance", {"manager": TOPO["manager"]})
        rec = pop.Reconciler(
            backend, ex, "op-rebalance",
            metrics_sources=[replica_source(src.engine),
                             replica_source(dst.engine)],
            rebalancer=pop.http_rebalancer(urls), rebalance_gap=0.05,
            rebalance_high=0.05, clock=counting_clock(),
            sleep=lambda s: None, log=lambda m: None)
        first = rec.tick()   # converges the manager: no rebalance
        assert first.outcome == "acted" and len(first.actions) == 1
        t = rec.tick()
        (action,) = t.actions
        assert action["rule"] == "rebalance" and action["status"] == "ok"
        assert (action["source"], action["target"]) == (0, 1)
        assert action["request_id"] == out["request_id"]
        assert t.outcome == "acted"
        assert metrics.counter("tk8s_operator_rebalances_total").value(
            status="ok") == 1
        sessions = json.loads(urllib.request.urlopen(
            dst.url + "/stats", timeout=30).read())["sessions"]
        assert len(sessions) == 1 and src.engine.allocator.in_use == 0
        awaited = _post(dst.url, {"request_id": sessions[0]},
                        path="/await")
        assert awaited["tokens"] == want.tokens
        # Moved: the pressure is the other way round, and nothing is
        # left on the source to move back.
        t = rec.tick()
        assert [a["status"] for a in t.actions] in ([], ["noop"])


# ------------------------------------------------------- train fleet


def relaunch_actuator(trainer_args, run_dir, steps):
    """A train actuator relaunching the fleet as ``decision.workers``
    local ranks through ``launch_trainers``, each launch with ``--resume
    --elastic`` and ``--steps steps[direction]``, in ``run_dir/launch-N``;
    it waits for the world to end. Its ``reports`` list holds each
    launch's ``LaunchReport``."""
    from triton_kubernetes_tpu_torch.parallel.multihost import launch_trainers

    reports = []

    def actuate(decision):
        out = f"{run_dir}/launch-{len(reports) + 1}"
        args = list(trainer_args) + ["--steps", str(steps[decision.direction]),
                                     "--resume", "--elastic"]
        rep = launch_trainers(args, n_processes=decision.workers,
                              run_dir=out, tag=f"op-local-{len(reports)}",
                              timeout=300, pin_cores=False)
        reports.append(rep)
        if not rep.ok:
            return {"status": "failed", "error": "\n".join(
                f"worker {w.process_id} rc={w.returncode}:\n{w.tail}"
                for w in rep.workers)[-2000:]}
        return {"status": "ok", "workers": decision.workers}

    actuate.reports = reports
    return actuate


def test_local_actuator_shrinks_a_gloo_world_and_regrows_it(tmp_path):
    """Replace at 2 (fresh), shrink to 1 after the loss, regrow to 2: each
    launch is a gloo world that resumes the checkpoint of the one before
    and trains on to its phase's step target."""
    status_path = tmp_path / "train-status.json"
    ckpt = str(tmp_path / "ckpt")
    steps = {"replace": 2, "shrink": 3, "regrow": 4}
    actuator = relaunch_actuator(
        ["--device", "cpu", "--model", "llama-test", "--batch-size", "4",
         "--seq-len", "16", "--log-every", "1", "--json-logs",
         "--checkpoint-dir", ckpt, "--checkpoint-every", "1"],
        str(tmp_path / "runs"), steps)
    backend, ex = world("op-train", {"manager": TOPO["manager"]})
    rec = pop.Reconciler(
        backend, ex, "op-train", clock=counting_clock(),
        sleep=lambda s: None, log=lambda m: None,
        train_policy=pop.TrainFleetPolicy(pop.TrainFleetConfig(
            desired_workers=2, min_workers=1, regrow_cooldown_s=0.0)),
        train_status=pop.file_train_status(str(status_path)),
        train_actuator=actuator)

    def tick(**status):
        status_path.write_text(json.dumps(status))
        return rec.tick()

    ticks = [tick(running_workers=0, capacity_workers=2),
             tick(running_workers=0, capacity_workers=1),
             tick(running_workers=1, capacity_workers=2),
             tick(running_workers=2, capacity_workers=2, done=True)]
    assert [(t.train_decision["direction"], t.train_decision["workers"])
            for t in ticks] == [("replace", 2), ("shrink", 1),
                                ("regrow", 2), ("hold", 0)]
    for t in ticks[:3]:
        (action,) = [a for a in t.actions if a["rule"] == "train-resize"]
        assert action["ok"], action
    reports = actuator.reports
    assert [len(r.returncodes) for r in reports] == [2, 1, 2]
    got = [(r.report["start_step"], r.report["steps"]) for r in reports]
    assert got == [(0, 2), (2, 1), (3, 1)]
    assert all(r.report["elastic"] for r in reports[1:])
    assert metrics.gauge("tk8s_operator_train_workers").value() == 2


def test_jobset_actuator_renders_the_elastic_resume_job(tmp_path):
    from triton_kubernetes_tpu_torch.topology.gpus import GpuPoolSpec
    from triton_kubernetes_tpu_torch.topology.jobset import HOST_LAUNCH

    act = pop.jobset_actuator(str(tmp_path), "train",
                              GpuPoolSpec.from_accelerator("h100-16"),
                              "img")
    out = act(pop.TrainDecision("shrink", 1, "shrink-instead-of-wait"))
    assert out["status"] == "ok" and out["workers"] == 1
    job = json.loads(open(out["path"]).read())
    container = job["spec"]["template"]["spec"]["containers"][0]
    assert container["command"] == HOST_LAUNCH + [
        "python", "-m", "triton_kubernetes_tpu_torch.train", "--resume",
        "--elastic"]
    env = {e["name"]: e.get("value") for e in container["env"]}
    assert (env["NUM_TPU_WORKERS"], env["GPUS_PER_HOST"]) == ("1", "8")
    bad = act(pop.TrainDecision("shrink", 0, "x"))
    assert bad["status"] == "failed" and "workers=0" in bad["error"]


def test_file_train_status_reads_torn_files_as_no_signal(tmp_path):
    path = tmp_path / "s.json"
    read = pop.file_train_status(str(path))
    assert read() is None
    path.write_text('{"running_workers": 1, "capa')
    assert read() is None
    path.write_text("[1, 2]")
    assert read() is None
    path.write_text(json.dumps({"running_workers": 1, "capacity_workers": 2,
                                "step": 5}))
    assert read().to_dict() == {"running_workers": 1, "capacity_workers": 2,
                                "step": 5}


# -------------------------------------------------------------- repair


def preempt(doc, slice_id):
    est = load_executor_state(doc)
    sim = CloudSimulator(est.cloud)
    sim.preempt_slice(slice_id)
    est.cloud = sim.to_dict()
    save_executor_state(doc, est)


def test_pool_repair_restores_the_pool_and_its_labels():
    from triton_kubernetes_tpu_torch.topology.gpus import GpuPoolSpec
    from triton_kubernetes_tpu_torch.topology.labels import \
        host_labels_for_pool

    backend, ex = world("rp")
    doc = backend.state("rp")
    ex.apply(doc)
    backend.persist(doc)
    with pytest.raises(NoPreemptedSlicesError):
        repair_slice_auto(backend, ex, "rp", "ml")
    for manager, cluster, msg in (("nope", "ml", "does not exist"),
                                  ("rp", "other", "A cluster named")):
        with pytest.raises(WorkflowError, match=msg):
            repair_slice_auto(backend, ex, manager, cluster)
    with pytest.raises(WorkflowError, match="does not match any pool"):
        repair_slice_auto(backend, ex, "rp", "ml", slice_id="ml-nope")
    preempt(doc, "ml-pool0")
    view = ex.cloud_view(doc)
    node = view.get_resource("gke_cluster", "ml")["node_pools"]["pool0"][
        "nodes"][0]
    assert node["labels"] == {} and node["preempted"]
    assert repair_slice_auto(backend, ex, "rp", "ml") == \
        "node_gcp-gpu_ml_pool0"
    view = ex.cloud_view(backend.state("rp"))
    pool = view.get_resource("gke_cluster", "ml")["node_pools"]["pool0"]
    assert [n["labels"] for n in pool["nodes"]] == host_labels_for_pool(
        GpuPoolSpec.from_accelerator("h100-16"), "ml-pool0")
    assert view.preempted_slices() == {}
    assert metrics.counter("tk8s_repairs_total").value(
        kind="slice", outcome="failed") == 4


def test_last_pool_destroy_removes_its_daemonsets_only():
    backend, ex = world("ds")
    doc = backend.state("ds")
    ex.apply(doc)
    cid = ex.output(doc, "cluster_gcp-gpu_ml")["cluster_id"]
    view = ex.cloud_view(doc)
    view.apply_manifest(cid, {"apiVersion": "apps/v1", "kind": "DaemonSet",
                              "metadata": {"name": "gpu-mine"}})
    est = load_executor_state(doc)
    est.cloud = view.to_dict()
    save_executor_state(doc, est)
    names = sorted(m["metadata"]["name"] for m in
                   ex.cloud_view(doc).get_manifests(cid, "DaemonSet"))
    assert len(names) == 4
    ex.destroy(doc, targets=["node_gcp-gpu_ml_pool0"])
    assert [m["metadata"]["name"] for m in
            ex.cloud_view(doc).get_manifests(cid, "DaemonSet")] == [
        "gpu-mine"]


# ----------------------------------------------------- tools.operate


def local_world(tmp_path, name="m1"):
    backend = LocalBackend(tmp_path / "state")
    backend.persist(document_from_spec(
        TOPO, name, backend=backend.executor_backend_config(name)))
    return backend


def test_operate_entry_point_converges_a_local_document(tmp_path, capsys):
    backend = local_world(tmp_path)
    journal = tmp_path / "j.jsonl"
    rc = operate_tool.main(["--state-dir", str(tmp_path / "state"),
                            "--until-converged", "--interval", "0",
                            "--journal-out", str(journal),
                            "--autoscale-cluster", "ml", "--max-ticks", "5"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "operating manager m1 (no endpoint)"
    assert out[-1] == "operate: stopped after 2 ticks (converged=True)"
    doc = backend.state("m1")
    doc.set_backend_config(backend.executor_backend_config("m1"))
    assert "node_gcp-gpu_ml_pool0" in load_executor_state(doc).modules
    ticks = [json.loads(line) for line in journal.read_text().splitlines()]
    assert [t["outcome"] for t in ticks] == ["acted", "noop"]
    assert ticks[1]["decision"]["reason"] == "no-signal"


@pytest.mark.parametrize("argv, msg", [
    (["--autoscale-cluster", "ml", "--min-pools", "0"], "min_pools"),
    (["--rebalance-gap", "0.2"], "--rebalance-gap needs"),
    (["--train-desired", "2"], "--train-desired needs"),
    (["--cluster-manager", "nope"], "does not exist"),
], ids=["bad-autoscaler", "rebalance-blind", "train-blind", "no-document"])
def test_operate_entry_point_refuses(tmp_path, capsys, argv, msg):
    local_world(tmp_path)
    rc = operate_tool.main(["--state-dir", str(tmp_path / "state"),
                            "--max-ticks", "1"] + argv)
    assert rc == 2
    assert msg in capsys.readouterr().err


def test_operator_endpoint_journal_and_trace(tmp_path):
    from triton_kubernetes_tpu_torch.utils.trace import (
        TraceWriter,
        merge_trace_files,
        read_trace_jsonl,
        validate_chrome_trace,
    )

    backend, ex = world("op-http")
    clock = counting_clock()
    writer = TraceWriter(str(tmp_path / "op.jsonl"), "operator",
                         clock=clock, wall=lambda: 1000.0)
    rec = pop.Reconciler(backend, ex, "op-http", clock=clock,
                         sleep=lambda s: None, log=lambda m: None,
                         trace=writer)
    assert rec.run(max_ticks=5, until_converged=True) == 2
    writer.close()
    meta, events = read_trace_jsonl(str(tmp_path / "op.jsonl"))
    ticks = [e for e in events if e["name"] == "operator.tick"]
    assert [t["fields"]["outcome"] for t in ticks] == ["acted", "noop"]
    assert ticks[0]["at"] == pytest.approx(rec.journal[0].at)
    assert validate_chrome_trace(merge_trace_files(
        [str(tmp_path / "op.jsonl")])) == []
    with pop.OperatorHTTPServer(rec, port=0) as srv:
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            fams = metrics.parse_prometheus(r.read().decode())
        assert fams["tk8s_operator_reconciles_total"]["series"]
        with urllib.request.urlopen(srv.url + "/stats", timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["ticks"] == 2 and stats["converged"] is True
        with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as r:
            assert r.status == 200
        srv.set_liveness(lambda: False)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(srv.url + "/healthz", timeout=10)
        assert err.value.code == 503
    with pytest.raises(pop.OperatorError, match="no-such-doc"):
        pop.Reconciler(backend, ex, "no-such-doc", log=lambda m: None).tick()


def test_operate_entry_point_takes_every_reference_flag():
    """Every option of the reference's ``tk8s operate`` parser is one of
    ``tools.operate``'s, with the same default but where the default names
    the accelerator or its image (``h100-16``, the torch/CUDA runtime)."""
    import argparse

    from triton_kubernetes_tpu.cli.main import build_parser

    sub = next(a for a in build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    ref = {a.dest: a for a in sub.choices["operate"]._actions
           if a.option_strings and a.dest != "help"}
    port = {a.dest: a for a in operate_tool._parser()._actions
            if a.option_strings and a.dest != "help"}
    assert set(ref) <= set(port)
    for dest, action in ref.items():
        assert port[dest].option_strings == action.option_strings
        if dest not in ("train_accelerator", "train_image"):
            assert port[dest].default == action.default, dest
    assert set(port) - set(ref) == {"cluster_manager", "state_dir"}
    assert port["train_accelerator"].default == "h100-16"
