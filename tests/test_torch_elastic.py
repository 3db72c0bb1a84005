"""Elastic restart, the goodput harness and the AOT-compile names of the
port, against the JAX package's, on the CPU.

The fleets are the port's trainer as gloo worlds of CPU processes
(``parallel.multihost.launch_trainers``, ``llama-test``):

1. F7: a world of 2 at ``fsdp`` 2 resumes under ``--elastic`` on 2
   processes (the reference's negotiation, asked with the fleet as one
   host of ``n`` devices, since every axis of the port spans processes);
   a recorded ``fsdp`` 2 onto one process is still a config error;
2. ``elastic_restart``: world 4 (``data`` 2 x ``fsdp`` 2), then 2, then
   4; the restores book ``reshard``, the resumed steps' losses equal an
   uninterrupted world-4 run's within 1e-5 relative (the global batch
   and the schedule are the same: warmup 100 keeps every phase's learning
   rates those of the uninterrupted run);
3. ``run_goodput`` at world 2: a kill after the first scheduled save, an
   emergency save, a verified resume; the report's keys are JAX's
   ``GoodputReport().to_json()``'s;
4. the AOT-compile names, as the reference's
   ``tests/test_step_pipeline.py:308-345`` checks them.

Every fleet runs with the trainer's default ``--prefetch`` (2): the
producer thread is joined at close, which ended the rare abort at exit.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from triton_kubernetes_tpu_torch.constants import EXIT_CONFIG  # noqa: E402
from triton_kubernetes_tpu_torch.parallel import multihost  # noqa: E402
from triton_kubernetes_tpu_torch.parallel.multihost import (  # noqa: E402
    ElasticPhase, GoodputReport, MultiHostUnavailable, elastic_restart,
    run_goodput)

TIMEOUT = 120
BASE = ["--device", "cpu", "--model", "llama-test", "--batch-size", "8",
        "--seq-len", "16", "--log-every", "1", "--json-logs"]


def _ok(rep):
    assert rep.ok, [(w.returncode, w.tail) for w in rep.workers]


def _lines(path):
    return [json.loads(x) for x in open(path) if x.startswith("{")]


def test_f7_sharded_world_resumes_under_elastic(tmp_path):
    """A world of 2 at ``fsdp`` 2 checkpoints, and the same fleet resumes
    with ``--resume --elastic``: the negotiation keeps ``fsdp`` 2, the
    restore is no reshard, training goes on to the new target. On one
    process the same checkpoint is a config error (exit 2)."""
    from triton_kubernetes_tpu_torch.train.__main__ import main

    ckpt = str(tmp_path / "ckpt")
    reports = elastic_restart(
        BASE + ["--fsdp", "2", "--steps", "2", "--checkpoint-dir", ckpt],
        phases=[ElasticPhase(2), ElasticPhase(2, extra_args=("--steps",
                                                            "3"))],
        run_dir=str(tmp_path / "run"), tag="t-f7", timeout=TIMEOUT,
        pin_cores=False)
    assert len(reports) == 2
    for rep in reports:
        _ok(rep)
    rep = reports[1].report
    assert rep["mesh"] == "mesh(fsdp=2)"
    assert (rep["start_step"], rep["steps"]) == (2, 1)
    assert rep["elastic"] is True and rep["reshard"] is None
    log = _lines(reports[1].workers[0].log_path)
    negotiated = [x for x in log if x["msg"] == "elastic mesh negotiated"]
    assert negotiated and negotiated[0]["reshaped"] is False
    rc = main(BASE + ["--steps", "3", "--checkpoint-dir", ckpt, "--resume",
                      "--elastic"])
    assert rc == EXIT_CONFIG


def test_elastic_restart_reshards_4_2_4_with_the_uninterrupted_losses(
        tmp_path):
    """``elastic_restart`` through worlds of 4 (``data`` 2 x ``fsdp`` 2),
    2 (``fsdp`` 2) and 4: every phase exits 0, the two restores book
    ``reshard`` (report and goodput ledger), the steps add up, and every
    phase's losses are the uninterrupted world-4 run's at the same
    steps."""
    ckpt = str(tmp_path / "ckpt")
    args = BASE + ["--fsdp", "2", "--checkpoint-dir", ckpt]
    phases = [ElasticPhase(4, extra_args=("--steps", "2")),
              ElasticPhase(2, extra_args=("--steps", "4")),
              ElasticPhase(4, extra_args=("--steps", "6"))]
    phases = [ElasticPhase(p.n_processes, extra_args=tuple(p.extra_args) + (
        "--trace-jsonl", str(tmp_path / f"trace{i}.jsonl")))
        for i, p in enumerate(phases)]
    reports = elastic_restart(args, phases=phases,
                              run_dir=str(tmp_path / "run"), tag="t-424",
                              timeout=TIMEOUT, pin_cores=False)
    assert len(reports) == 3
    for rep in reports:
        _ok(rep)
    whole = multihost.launch_trainers(
        BASE + ["--fsdp", "2", "--steps", "6"], n_processes=4,
        run_dir=str(tmp_path / "whole"), tag="t-whole", timeout=TIMEOUT,
        pin_cores=False)
    _ok(whole)
    want = whole.report["losses"]
    assert whole.report["mesh"] == "mesh(data=2, fsdp=2)"
    meshes = ["mesh(data=2, fsdp=2)", "mesh(fsdp=2)", "mesh(data=2, fsdp=2)"]
    for i, (rep, mesh) in enumerate(zip(reports, meshes)):
        r = rep.report
        assert r["mesh"] == mesh
        assert (r["start_step"], r["steps"]) == (2 * i, 2)
        np.testing.assert_allclose(r["losses"], want[2 * i:2 * i + 2],
                                   rtol=1e-5)
        if i:
            assert r["reshard"]["step"] == 2 * i
            assert r["reshard"]["from_processes"] == (4, 2)[i - 1]
            assert r["reshard"]["to_processes"] == (2, 4)[i - 1]
            assert r["goodput"]["seconds"]["reshard"] > 0
        else:
            assert r["reshard"] is None
            assert "reshard" not in r["goodput"]["seconds"]


def test_run_goodput_kills_resumes_and_reports_the_references_keys(
        tmp_path):
    """One kill -> emergency save -> verified resume cycle at world 2:
    every step is useful or replayed, the resume starts at the emergency
    step, and ``to_json`` has the reference's keys."""
    from triton_kubernetes_tpu.parallel.multihost import \
        GoodputReport as JGoodputReport

    rep = run_goodput(
        BASE + ["--checkpoint-dir", str(tmp_path / "ckpt"),
                "--checkpoint-every", "2", "--device-ms-per-row", "60"],
        n_processes=2, run_dir=str(tmp_path / "run"), target_steps=10,
        timeout=TIMEOUT)
    out = rep.to_json()
    assert set(out) == set(JGoodputReport().to_json())
    assert out["useful_steps"] == out["target_steps"] == 10
    assert out["resumed_step"] == out["emergency_step"] >= 2
    assert out["wasted_steps"] == 0
    assert out["phases"][0]["returncodes"] == [75, 75]
    assert out["phases"][1]["returncodes"] == [0, 0]
    assert 0 < out["goodput_steps_per_sec"] and out["wall_seconds"] > 0


def test_one_device_per_process_is_typed():
    """A fleet shape of two devices a process is refused before anything
    launches, with the typed reason."""
    for call in (
            lambda: elastic_restart(BASE, phases=[ElasticPhase(1, 2)],
                                    run_dir="unused"),
            lambda: run_goodput(BASE, devices_per_process=2,
                                run_dir="unused", target_steps=2)):
        with pytest.raises(MultiHostUnavailable) as e:
            call()
        assert e.value.reason == "one-device-per-process"
    assert not os.path.exists("unused")


def test_elastic_phase_and_goodput_report_fields_are_the_references():
    from dataclasses import fields

    from triton_kubernetes_tpu.parallel import multihost as jmultihost

    for ours, theirs in ((ElasticPhase, jmultihost.ElasticPhase),
                         (GoodputReport, jmultihost.GoodputReport)):
        assert [(f.name, f.default) for f in fields(ours)] == [
            (f.name, f.default) for f in fields(theirs)]
    assert GoodputReport().to_json() == jmultihost.GoodputReport().to_json()


# ------------------------------------------------------ the trainer's --expert

@pytest.mark.parametrize("expert", [2, 4])
def test_trainer_trains_mixtral_expert_parallel(tmp_path, expert):
    """``--expert 2`` and ``--expert 4`` train ``mixtral-test`` in gloo
    worlds of as many processes: the mesh report and the manifest record
    the expert axis, the default global batch is 4 (one data x fsdp
    shard), and the losses and grad norms are the one-process ``--expert
    1`` run's (the same init and batches) within 1e-5 relative."""
    args = ["--device", "cpu", "--model", "mixtral-test", "--seq-len", "32",
            "--steps", "3", "--log-every", "1", "--warmup-steps", "1",
            "--json-logs", "--model-opt", "capacity_factor=1.0"]
    one = tmp_path / "one.json"
    from triton_kubernetes_tpu_torch.train.__main__ import main

    assert main(args + ["--report-json", str(one)]) == 0
    want = json.loads(one.read_text())
    ckpt = str(tmp_path / "ckpt")
    rep = multihost.launch_trainers(
        args + ["--expert", str(expert), "--checkpoint-dir", ckpt],
        n_processes=expert, run_dir=str(tmp_path / "run"),
        tag=f"t-expert{expert}", timeout=TIMEOUT, pin_cores=False)
    _ok(rep)
    got = rep.report
    assert got["mesh"] == f"mesh(expert={expert})"
    assert got["expert"] == expert and got["global_batch"] == 4
    assert got["mesh_axes"]["expert"] == expert
    for key in ("losses", "grad_norms", "aux_losses"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)
    manifest = json.loads(open(os.path.join(ckpt, "3",
                                            "manifest.json")).read())
    assert manifest["mesh"]["axes"]["expert"] == expert


# ------------------------------------------------------------ AOT names

def test_aot_compile_names_are_exported_timed_and_equal_the_plain_step(
        tmp_path):
    """``CompileTimings``, ``aot_compile_step`` and
    ``enable_compile_cache`` are exported as the reference's; on the CPU
    the step launches no kernel, so nothing is built (``cache_dir`` None,
    ``lower_seconds`` 0), the gauge carries the timings under the
    reference's labels, and the returned step's loss equals the plain
    step's. ``enable_compile_cache`` moves the kernels' build
    directory."""
    import triton_kubernetes_tpu.train as jtrain
    from triton_kubernetes_tpu_torch import train
    from triton_kubernetes_tpu_torch.models import get_config
    from triton_kubernetes_tpu_torch.ops import _kernels
    from triton_kubernetes_tpu_torch.train.data import synthetic_batches
    from triton_kubernetes_tpu_torch.utils import metrics as metrics_mod

    for name in ("CompileTimings", "aot_compile_step",
                 "enable_compile_cache"):
        assert name in train.__all__ and name in jtrain.__all__
    assert [f for f in train.CompileTimings.__dataclass_fields__] == [
        f for f in jtrain.CompileTimings.__dataclass_fields__]
    registry = metrics_mod.get_registry()
    metrics_mod.configure()
    try:
        _aot_checks(train, _kernels, metrics_mod, get_config,
                    synthetic_batches)
    finally:
        metrics_mod.configure(registry)

    before = _kernels.BUILD_DIR
    try:
        out = train.enable_compile_cache(str(tmp_path / "cache"))
        assert out == str(tmp_path / "cache")
        assert (tmp_path / "cache").is_dir()
        assert _kernels.BUILD_DIR == (tmp_path / "cache").resolve()
        assert _kernels._library_path("flash_fwd").parent == \
            _kernels.BUILD_DIR
    finally:
        _kernels.BUILD_DIR = before


def _aot_checks(train, _kernels, metrics_mod, get_config,
                synthetic_batches):
    import torch

    cfg = get_config("llama-test")
    opt = train.make_optimizer(warmup_steps=1, decay_steps=10)
    step = train.make_train_step(cfg, opt)
    batch = next(synthetic_batches(cfg.vocab_size, 2, 16))
    state = train.init_state(cfg, opt, device="cpu")
    compiled, timings = train.aot_compile_step(step, state, batch,
                                               config_name="llama-test")
    assert timings.lower_seconds == 0.0 and timings.compile_seconds >= 0
    assert timings.cache_dir is None
    assert timings.total_seconds == pytest.approx(
        timings.lower_seconds + timings.compile_seconds)
    gauge = metrics_mod.gauge("tk8s_train_compile_seconds")
    assert gauge.value(config="llama-test", phase="lower") == 0.0
    assert gauge.value(config="llama-test", phase="compile") == \
        timings.compile_seconds
    _, got = compiled(state, batch)
    plain = train.init_state(cfg, opt, device="cpu")
    _, want = step(plain, batch)
    assert float(got["loss"]) == float(want["loss"])
    _step_kernel_checks(train, _kernels, get_config, cfg, opt, step,
                        state)


def _step_kernel_checks(train, _kernels, get_config, cfg, opt, step, state):
    """The kernels the compile builds are those of the attention the step
    resolved: the flash kernels for the model's flash attention (on a
    rank's heads too), none for the ring or the dense einsum, and none
    off the card."""
    from types import SimpleNamespace

    import torch

    from triton_kubernetes_tpu_torch.parallel.mesh import Mesh

    kernels = train.trainer.step_kernels
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    assert set(flash) <= set(_kernels.KERNELS)
    assert kernels(step, state.model) == ()
    cuda = torch.device("cuda")
    card = SimpleNamespace(config=cfg, device=cuda)
    assert kernels(step, card) == flash
    for sizes, want in ((dict(tensor=2), flash), (dict(data=2), flash),
                        (dict(seq=2), ())):
        mesh_step = train.make_train_step(cfg, opt,
                                          mesh=Mesh(sizes, 0, "cuda"))
        assert kernels(mesh_step, card) == want, sizes
    dense = get_config("llama-test", attention="dense")
    assert kernels(train.make_train_step(dense, opt),
                   SimpleNamespace(config=dense, device=cuda)) == ()


def test_trainer_compile_cache_dir(tmp_path, capsys):
    """``--compile-cache-dir`` goes through ``enable_compile_cache`` and
    the first step's log carries the compile split."""
    from triton_kubernetes_tpu_torch.ops import _kernels
    from triton_kubernetes_tpu_torch.train.__main__ import main

    before = _kernels.BUILD_DIR
    try:
        rc = main(BASE + ["--steps", "1", "--batch-size", "2",
                          "--compile-cache-dir", str(tmp_path / "cc")])
    finally:
        _kernels.BUILD_DIR = before
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().err.splitlines()
             if x.startswith("{")]
    cache = [x for x in lines if x["msg"] == "persistent compile cache"]
    assert cache and cache[0]["dir"] == str(tmp_path / "cc")
    compiled = [x for x in lines if x["msg"] == "train step compiled"][0]
    assert compiled["cache_dir"] == "" and compiled["compile_s"] >= 0
