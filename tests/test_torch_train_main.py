"""``python -m triton_kubernetes_tpu_torch.train`` -- the port's trainer
entry point with its durability flags, on the CPU at ``llama-test``.

Mirrors the single-card cases of ``tests/test_train_main.py``: a
synthetic run in JSON logs, a packed ``--data-dir`` with a checkpoint
and a resume, the checkpoint cadence split out of a wider sync window, a
profile of a one-window run, a zero-step run logging "n/a", the anomaly
and emergency flags on a clean run, the precision and remat flags, and
bad flags exiting 2. Then the port's own: the report carries the
preemption outcome and the resume step; ``--elastic`` on a checkpoint
whose recorded mesh one card cannot hold exits 2; an anomaly budget run
out exits 4. Against the JAX package: ``constants`` hold its values, the
logger writes its lines (text and JSON, the timestamp aside), and
``auto_attention("cuda")``'s flash path computes its causal attention
within 1e-5 relative (f32 on the CPU).

Losses are compared exactly (f32 on the CPU): an in-process run with
``--checkpoint-dir --checkpoint-every`` stopped at a checkpoint and
resumed gives bitwise the uninterrupted run's per-step losses, and so
does the subprocess kill-and-resume (as the reference's
``test_trainer_sigterm_kill_and_resume_matches_uninterrupted``, at S 16):
SIGTERM goes straight to the trainer's pid after it logs a step past its
first checkpoint; it must land an emergency save and exit 75, and a
``--resume`` run over both directories must restore that step and finish
with the uninterrupted run's losses. The subprocesses carry a
``timeout``.
"""

import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from triton_kubernetes_tpu import constants as jconstants
from triton_kubernetes_tpu.ops.attention import causal_attention
from triton_kubernetes_tpu.utils import logging as jlogging
from triton_kubernetes_tpu_torch import constants
from triton_kubernetes_tpu_torch.constants import (
    EXIT_ANOMALY, EXIT_CONFIG, EXIT_RESUME)
from triton_kubernetes_tpu_torch.ops.attention import auto_attention
from triton_kubernetes_tpu_torch.ops.flash_attention import (
    NEG_INF, flash_attention)
from triton_kubernetes_tpu_torch.utils import logging as tlogging
from triton_kubernetes_tpu_torch.train.__main__ import main
from triton_kubernetes_tpu_torch.train.checkpoint import (
    MANIFEST_NAME, CheckpointManager, mesh_spec_of)
from triton_kubernetes_tpu_torch.train.data import write_packed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--model", "llama-test", "--batch-size", "2",
        "--seq-len", "16", "--warmup-steps", "1", "--json-logs"]


def _run(capsys, argv):
    rc = main(argv)
    err = capsys.readouterr().err
    return rc, [json.loads(l) for l in err.splitlines()
                if l.startswith("{")]


def _train(lines):
    return [l for l in lines if l["msg"] == "train"]


def test_constants_are_the_references():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert names and [getattr(constants, n) for n in names] == \
        [getattr(jconstants, n) for n in names]
    assert NEG_INF == -1e30


@pytest.mark.parametrize("json_mode", [False, True])
def test_logger_writes_the_references_lines(json_mode):
    import io
    import re

    def lines(mod):
        out = io.StringIO()
        log = mod.Logger(out, json_mode=json_mode, level="info")
        log.bind(process=0)
        log.log("debug", "hidden")
        log.log("info", "train", step=2, loss=1.5)
        log.warn("preempted", step=3)
        with log.span("phase", k=1):
            log.error("inner", why="x")
        with pytest.raises(ValueError, match="unknown log level"):
            log.log("loud", "x")
        # The wall clock and the span's duration (rounded to 1 ms, which
        # a loaded host can pass) are the two fields that are not format.
        got = re.sub(r'"ts": [0-9.]+', '"ts": 0', out.getvalue())
        return re.sub(r'duration_s(": |=)[0-9.]+', r'duration_s\g<1>0', got)
    got = lines(tlogging)
    assert got == lines(jlogging) and "train" in got
    assert tlogging.configure(json_mode=True) is tlogging.get_logger()


def test_auto_attention_is_flash_on_the_card_only():
    import torch

    assert auto_attention("cpu") is None and auto_attention("tpu") is None
    fn = auto_attention("cuda")
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, h, 16), generator=g) for h in (4, 2, 2))
    assert torch.equal(fn(q, k, v, None), flash_attention(q, k, v))
    want = np.asarray(causal_attention(q.numpy(), k.numpy(), v.numpy()))
    np.testing.assert_allclose(fn(q, k, v, None).numpy(), want,
                               rtol=1e-5, atol=1e-6)


def test_synthetic_smoke(capsys):
    rc, lines = _run(capsys, TINY + ["--steps", "4", "--log-every", "2"])
    assert rc == 0
    train = _train(lines)
    assert [l["step"] for l in train] == [2, 4]
    assert np.isfinite(train[-1]["loss"])
    assert any(l["msg"] == "trainer done" for l in lines)
    assert any(l["msg"] == "train step compiled" for l in lines)


def test_data_dir_and_checkpoint_resume(tmp_path, capsys):
    rng = np.random.default_rng(0)
    write_packed(str(tmp_path / "data" / "shard0.bin"),
                 rng.integers(0, 256, size=4096).astype(np.int32))
    ckpt = tmp_path / "ckpt"
    common = TINY + ["--data-dir", str(tmp_path / "data"),
                     "--checkpoint-dir", str(ckpt), "--log-every", "1"]
    rc, _ = _run(capsys, common + ["--steps", "2"])
    assert rc == 0
    rc, lines = _run(capsys, common + ["--steps", "4", "--resume"])
    assert rc == 0
    assert any(l["msg"] == "resumed" and l["step"] == 2 for l in lines)
    assert _train(lines)[-1]["step"] == 4
    man = json.loads((ckpt / "4" / MANIFEST_NAME).read_text())
    assert man["kind"] == "final" and man["mesh"] == mesh_spec_of(
        None, 1, 2)


def test_checkpoint_cadence_not_quantized_by_sync_window(tmp_path, capsys):
    rc, lines = _run(capsys, TINY + [
        "--steps", "4", "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--checkpoint-every", "2", "--log-every", "4"])
    assert rc == 0
    assert [l["step"] for l in lines
            if l["msg"] == "checkpoint saved"] == [2, 4]
    assert [l["step"] for l in _train(lines)] == [2, 4]


def test_profile_dir_traces_single_window_run(tmp_path, capsys):
    rc, lines = _run(capsys, TINY + [
        "--steps", "2", "--log-every", "10",
        "--profile-dir", str(tmp_path / "prof")])
    assert rc == 0
    assert any(l["msg"] == "profiler trace written" for l in lines)
    trace = json.loads((tmp_path / "prof" / "train_trace.json").read_text())
    assert trace["traceEvents"]


def test_zero_step_run_reports_na_not_nan(capsys):
    rc, lines = _run(capsys, TINY + ["--steps", "0"])
    assert rc == 0
    done = [l for l in lines if l["msg"] == "trainer done"]
    assert done and done[0]["final_loss"] == "n/a"


def test_anomaly_and_emergency_flags_clean_run(tmp_path, capsys):
    common = TINY + [
        "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--checkpoint-every", "2", "--emergency-dir",
        str(tmp_path / "emergency"), "--anomaly-factor", "25",
        "--max-rollbacks", "2", "--log-every", "1"]
    rc, _ = _run(capsys, common + ["--steps", "2"])
    assert rc == 0
    rc, lines = _run(capsys, common + ["--steps", "4", "--resume"])
    assert rc == 0
    assert any(l["msg"] == "resumed" and l["step"] == 2
               and l["emergency"] is False for l in lines)
    train = _train(lines)
    assert train[-1]["step"] == 4 and np.isfinite(train[-1]["loss"])


def test_precision_and_remat_flags(tmp_path, capsys):
    rc, lines = _run(capsys, TINY + [
        "--steps", "2", "--precision", "bf16", "--remat-policy", "dots",
        "--log-every", "1", "--report-json", str(tmp_path / "r.json")])
    assert rc == 0
    pol = [l for l in lines if l["msg"] == "precision policy"][0]
    assert (pol["policy"], pol["compute_dtype"], pol["param_dtype"],
            pol["remat"]) == ("bf16", "bfloat16", "float32", "dots")
    compiled = [l for l in lines if l["msg"] == "train step compiled"][0]
    assert "temp_mib" not in compiled  # measured on the card only
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["memory"] is None
    assert all(np.isfinite(report["losses"] + report["grad_norms"]))


@pytest.mark.parametrize("flags", [
    ["--batch-size", "-1"], ["--checkpoint-every", "-2"],
    ["--seq-len", "4096"], ["--sync-every", "-1"]])
def test_bad_flags_exit_config(flags, capsys):
    rc, lines = _run(capsys, TINY + ["--steps", "1"] + flags)
    assert rc == EXIT_CONFIG == 2
    assert any(l["msg"] == "bad flags" for l in lines)


def test_elastic_reshape_error_exits_config(tmp_path, capsys):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), mesh_spec=mesh_spec_of(
        {"fsdp": 4}, 1, 16))
    mgr.save(1, {"w": np.zeros(2, np.float32)}, wait=True)
    mgr.close()
    rc, lines = _run(capsys, TINY + [
        "--steps", "2", "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--resume", "--elastic"])
    assert rc == EXIT_CONFIG
    assert any(l["msg"] == "elastic shape negotiation failed"
               for l in lines)


def test_elastic_takes_the_recorded_batch(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    rc, _ = _run(capsys, TINY + ["--steps", "2", "--batch-size", "3",
                                 "--checkpoint-dir", ckpt])
    assert rc == 0
    argv = [a for a in TINY if a not in ("--batch-size", "2")]
    rc, lines = _run(capsys, argv + ["--steps", "3", "--checkpoint-dir",
                                     ckpt, "--resume", "--elastic"])
    assert rc == 0
    start = [l for l in lines if l["msg"] == "trainer starting"][0]
    assert start["batch"] == 3
    assert any(l["msg"] == "elastic mesh negotiated"
               and l["reshaped"] is False for l in lines)


def test_exhausted_rollback_budget_exits_anomaly(tmp_path, capsys,
                                                 monkeypatch):
    """A NaN welded to a step: the guard rolls back max-rollbacks times,
    then the trainer exits 4 with the report's outcome."""
    from triton_kubernetes_tpu_torch.train import trainer

    make = trainer.make_train_step

    def poisoned(config, opt):
        step = make(config, opt)

        def run(state, batch):
            state, metrics = step(state, batch)
            if state.step == 3:
                metrics = dict(metrics, loss=metrics["loss"] * float("nan"))
            return state, metrics
        return run

    # The entry point imports make_train_step when it runs.
    monkeypatch.setattr(trainer, "make_train_step", poisoned)
    report = tmp_path / "r.json"
    rc, lines = _run(capsys, TINY + [
        "--steps", "6", "--log-every", "2", "--checkpoint-dir",
        str(tmp_path / "ckpt"), "--checkpoint-every", "2",
        "--anomaly-factor", "10", "--max-rollbacks", "2",
        "--report-json", str(report)])
    assert rc == EXIT_ANOMALY == 4
    assert any(l["msg"] == "anomaly guard aborted the run" for l in lines)
    assert json.loads(report.read_text())["outcome"] == "anomaly-abort"


def test_checkpointed_resume_losses_bitwise_uninterrupted(tmp_path, capsys):
    """In process, f32 on the CPU: stop at a checkpoint, resume, and the
    per-step losses are the uninterrupted run's bit for bit (the step
    count sets the schedule, so every run asks for the same 6 steps)."""
    rep = {k: tmp_path / f"{k}.json" for k in ("ref", "first", "resumed")}
    common = TINY + ["--steps", "6", "--log-every", "2"]
    assert main(common + ["--report-json", str(rep["ref"])]) == 0
    ckpt = ["--checkpoint-dir", str(tmp_path / "ckpt"),
            "--checkpoint-every", "2"]
    # A run asking for fewer steps would train under another learning-rate
    # schedule, so the interrupted run is a full one whose last checkpoint
    # is then moved away: the newest left is step 4.
    assert main(common + ckpt + ["--report-json", str(rep["first"])]) == 0
    os.rename(tmp_path / "ckpt" / "6", tmp_path / "gone-6")
    assert main(common + ckpt + ["--resume", "--report-json",
                                 str(rep["resumed"])]) == 0
    capsys.readouterr()
    ref, first, resumed = (json.loads(rep[k].read_text())
                           for k in ("ref", "first", "resumed"))
    assert first["losses"] == ref["losses"]
    assert resumed["start_step"] == 4 and resumed["resumed"]["step"] == 4
    assert resumed["losses"] == ref["losses"][4:]
    assert resumed["grad_norms"] == ref["grad_norms"][4:]


# ------------------------------------------------- the subprocess kill


def _popen(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-m", "triton_kubernetes_tpu_torch.train"] + args,
        cwd=REPO, env=env, stderr=subprocess.PIPE,
        stdout=subprocess.DEVNULL, text=True)


def _lines(err):
    return [json.loads(l) for l in err.splitlines() if l.startswith("{")]


def test_trainer_sigterm_kill_and_resume_matches_uninterrupted(tmp_path):
    common = TINY + ["--steps", "12", "--sync-every", "2",
                     "--log-every", "2"]
    ref = _popen(common + ["--report-json", str(tmp_path / "a.json")])
    _, ref_err = ref.communicate(timeout=240)
    assert ref.returncode == 0, ref_err
    ref_losses = {l["step"]: l["loss"] for l in _lines(ref_err)
                  if l["msg"] == "train"}
    a = json.loads((tmp_path / "a.json").read_text())

    ckpt_args = ["--checkpoint-dir", str(tmp_path / "ckpt"),
                 "--checkpoint-every", "4",
                 "--emergency-dir", str(tmp_path / "emergency")]
    child = _popen(common + ckpt_args + ["--report-json",
                                         str(tmp_path / "b.json")])
    seen, sent = [], False
    watchdog = threading.Timer(240, child.kill)
    watchdog.start()
    try:
        for line in child.stderr:  # to EOF: the signal goes in mid-read
            seen.append(line)
            if not sent and line.startswith("{"):
                rec = json.loads(line)
                if rec["msg"] == "train" and rec["step"] >= 6:
                    child.send_signal(signal.SIGTERM)
                    sent = True
        child.wait(timeout=240)
    finally:
        watchdog.cancel()
        if child.poll() is None:
            child.kill()
    err = "".join(seen)
    assert child.returncode == EXIT_RESUME, err
    lines = _lines(err)
    assert any(l["msg"] == "emergency checkpoint saved" for l in lines), err
    b = json.loads((tmp_path / "b.json").read_text())
    assert b["outcome"] == "preempted" and b["interrupted"]
    em = b["emergency_step"]
    assert em >= 6
    assert (tmp_path / "emergency" / str(em) / MANIFEST_NAME).exists()
    assert b["losses"] == a["losses"][:len(b["losses"])]
    for l in _train(lines):
        assert l["loss"] == ref_losses.get(l["step"], l["loss"])

    resumed = _popen(common + ckpt_args + ["--resume", "--report-json",
                                           str(tmp_path / "c.json")])
    _, err2 = resumed.communicate(timeout=240)
    assert resumed.returncode == 0, err2
    at = [l for l in _lines(err2) if l["msg"] == "resumed"]
    assert at and at[0]["step"] == em and at[0]["emergency"] is True
    c = json.loads((tmp_path / "c.json").read_text())
    assert c["start_step"] == em and c["steps"] == 12 - em
    assert c["losses"] == a["losses"][em:]
    assert _train(_lines(err2))[-1]["step"] == 12
