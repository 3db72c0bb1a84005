"""The port's resilient loop (``train/resilience.py``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_resilience.py``'s loop cases on the same fake
workload (a state ``{"step", "w"}`` where batch i carries the value i, so
``w`` proves which batches trained): a real SIGTERM to our own pid, the
emergency save and the resume, preemption before any step, rollback to
the resume point, NaN and spike rollbacks, the abort budget (also far
from the checkpoint), skipping a poisoned window once and twice, the
guard's history reset; and, at ``llama-test`` on the port's train step,
``run_pipelined``'s stop flag and the guarded path's losses bitwise the
bare loop's.

Against the reference: the same scripted loss sequences give the same
``Anomaly`` from both ``LossAnomalyGuard.screen``\\ s, and ``run_resilient``
under the same NaN, spike, poison-batch and preemption schedules (the
reference over its orbax ``CheckpointManager``, the port over its own)
gives the same ``ResilienceReport`` field by field -- steps, per-step
losses, rollbacks, anomalies, restored steps, sync points, the
emergency step -- and the same data offsets: the sequence of batches
every step consumed, rolled-back ones included, and the final ``w``.
Everything is compared exactly (NaN equal to NaN): no tolerance.
"""

import math
import os
import signal
import time

import numpy as np
import pytest

from triton_kubernetes_tpu.train import checkpoint as jckpt
from triton_kubernetes_tpu.train import resilience as jres
from triton_kubernetes_tpu_torch.constants import EXIT_RESUME as C_RESUME
from triton_kubernetes_tpu_torch.models import get_config
from triton_kubernetes_tpu_torch.train import (
    CheckpointManager,
    init_state,
    make_optimizer,
    make_train_step,
    run_pipelined,
)
from triton_kubernetes_tpu_torch.train.data import synthetic_batches
from triton_kubernetes_tpu_torch.train.resilience import (
    EXIT_RESUME,
    Anomaly,
    AnomalyAbortedError,
    LossAnomalyGuard,
    PreemptionGuard,
    ResilienceReport,
    run_resilient,
)
from triton_kubernetes_tpu_torch.utils import metrics as metrics_mod


@pytest.fixture()
def fresh_registry():
    old = metrics_mod.get_registry()
    reg = metrics_mod.configure()
    yield reg
    metrics_mod.configure(old)


def _fake_state(step=0, w=0.0):
    return {"step": np.asarray(step, np.int32),
            "w": np.asarray(w, np.float32)}


def _fake_batches(start):
    def gen():
        i = start
        while True:
            i += 1
            yield {"x": np.asarray(float(i), np.float32)}
    return gen()


def _fake_step(loss_for=None, consumed=None):
    """w accumulates batch values; loss is 1/step unless ``loss_for``
    overrides it; ``consumed`` records every batch value trained."""
    def step_fn(state, batch):
        s = int(state["step"]) + 1
        x = float(batch["x"])
        if consumed is not None:
            consumed.append(x)
        loss = 1.0 / s
        if loss_for is not None:
            override = loss_for(s, x)
            if override is not None:
                loss = override
        return ({"step": np.asarray(s, np.int32),
                 "w": np.asarray(state["w"] + batch["x"], np.float32)},
                {"loss": np.asarray(loss, np.float32)})
    return step_fn


def test_exit_code_and_names():
    assert EXIT_RESUME == C_RESUME == jres.EXIT_RESUME == 75
    assert [f.name for f in ResilienceReport.__dataclass_fields__.values()] \
        == [f.name for f in jres.ResilienceReport.__dataclass_fields__
            .values()]


# -------------------------------------------------------- preemption guard

def test_preemption_guard_real_sigterm_sets_flag():
    guard = PreemptionGuard()
    before = signal.getsignal(signal.SIGTERM)
    with guard:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5.0
        while not guard.requested and time.time() < deadline:
            time.sleep(0.01)
        assert guard.requested and guard.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) == before  # handlers restored


def _tiny():
    cfg = get_config("llama-test")
    opt = make_optimizer(learning_rate=1e-2, warmup_steps=2, decay_steps=100)
    gen = synthetic_batches(cfg.vocab_size, 2, 16)
    return cfg, opt, make_train_step(cfg, opt), [next(gen)
                                                 for _ in range(8)]


def test_run_pipelined_should_stop_syncs_partial_window(fresh_registry):
    cfg, opt, step, batches = _tiny()
    state = init_state(cfg, opt, device="cpu")
    flag = {"stop": False}
    state, report = run_pipelined(
        step, state, batches, sync_every=3, max_steps=8,
        on_sync=lambda n, st, losses, dt: flag.__setitem__("stop", n >= 3),
        should_stop=lambda: flag["stop"])
    assert report.interrupted
    assert report.steps == 3 and len(report.losses) == 3
    assert state.step == 3


def test_guarded_clean_path_bitwise_identical_to_pipelined(tmp_path,
                                                           fresh_registry):
    cfg, opt, step, batches = _tiny()
    state = init_state(cfg, opt, device="cpu")
    state, ref = run_pipelined(step, state, list(batches[:6]), sync_every=2,
                               max_steps=6)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    state2 = init_state(cfg, opt, device="cpu")
    state2, rep = run_resilient(
        step, state2, lambda start: iter(batches[start:6]), ckpt=ckpt,
        target_step=6, sync_every=2, checkpoint_every=2,
        guard=LossAnomalyGuard(factor=100.0, min_history=2))
    assert rep.rollbacks == 0
    assert rep.losses == ref.losses  # bitwise, no tolerance
    ckpt.close()


def test_nan_rollback_restores_the_train_state_from_disk(tmp_path,
                                                         fresh_registry):
    """A NaN window on the real train state: the rollback restores the
    checkpoint into the live tensors and the replay gives the clean run's
    losses exactly."""
    cfg, opt, step, batches = _tiny()
    state = init_state(cfg, opt, device="cpu")
    state, ref = run_pipelined(step, state, list(batches[:6]), sync_every=2,
                               max_steps=6)
    armed = {"on": True}

    def glitchy(st, batch):
        st, metrics = step(st, batch)
        if st.step == 4 and armed["on"]:
            armed["on"] = False
            metrics = dict(metrics, loss=metrics["loss"] * float("nan"))
        return st, metrics

    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    state2 = init_state(cfg, opt, device="cpu")
    state2, rep = run_resilient(
        glitchy, state2, lambda start: iter(batches[start:6]), ckpt=ckpt,
        target_step=6, sync_every=2, checkpoint_every=2,
        guard=LossAnomalyGuard(factor=0.0))
    assert rep.rollbacks == 1 and rep.restored_steps == [2]
    assert rep.losses == ref.losses
    ckpt.close()


def test_run_resilient_preemption_emergency_save_then_resume(
        tmp_path, fresh_registry):
    state, rep = run_resilient(
        _fake_step(), _fake_state(), _fake_batches, target_step=10,
        sync_every=2)
    ref_w, ref_losses = float(state["w"]), rep.losses

    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    guard = PreemptionGuard()
    with guard:
        def on_sync(gstep, st, losses, dt):
            if gstep == 4:
                os.kill(os.getpid(), signal.SIGTERM)
        state, rep = run_resilient(
            _fake_step(), _fake_state(), _fake_batches, ckpt=ckpt,
            target_step=10, sync_every=2, preemption=guard, on_sync=on_sync)
    assert rep.interrupted and rep.emergency_step == 4
    assert rep.steps == 4
    assert ckpt.latest_verified_step() == 4
    assert metrics_mod.counter(
        "tk8s_train_checkpoint_emergency_saves_total").value() == 1
    assert ckpt.manifest(4)["kind"] == "emergency"

    restored = ckpt.restore(_fake_state())
    start = int(restored["step"])
    assert start == 4
    state2, rep2 = run_resilient(
        _fake_step(), restored, _fake_batches, ckpt=ckpt,
        target_step=10, start_step=start, sync_every=2)
    assert float(state2["w"]) == ref_w
    assert rep.losses + rep2.losses == ref_losses
    ckpt.close()


def test_preemption_before_any_step_keeps_durable_checkpoint_intact(
        tmp_path, fresh_registry):
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(4, _fake_state(4, w=4.0), wait=True)
    guard = PreemptionGuard()
    guard.trip()
    restored = ckpt.restore(_fake_state())
    state, rep = run_resilient(
        _fake_step(), restored, _fake_batches, ckpt=ckpt,
        target_step=10, start_step=4, sync_every=2, preemption=guard)
    assert rep.interrupted and rep.steps == 0
    assert rep.emergency_step is None
    assert ckpt.all_steps() == [4]
    assert not (tmp_path / "ckpt" / "quarantine").exists()
    assert metrics_mod.counter(
        "tk8s_train_checkpoint_emergency_saves_total").value() == 0
    ckpt.close()


def test_anomaly_guard_screens_nan_inf_and_spike():
    guard = LossAnomalyGuard(factor=4.0, min_history=3)
    assert guard.screen([1.0, 0.9, 1.1], 1) is None
    hit = guard.screen([1.0, float("nan"), 0.9], 4)
    assert isinstance(hit, Anomaly)
    assert (hit.step, hit.reason) == (5, "non-finite")
    assert guard.screen([float("inf")], 7).reason == "non-finite"
    spike = guard.screen([1.05, 50.0], 8)
    assert spike.reason == "spike" and spike.step == 9
    assert spike.median == pytest.approx(1.0, abs=0.2)
    lax = LossAnomalyGuard(factor=0.0, min_history=1)
    assert lax.screen([1.0, 1e9], 1) is None
    assert lax.screen([float("nan")], 3).reason == "non-finite"


def _key(x):
    """A comparable form: NaN as a string, dataclasses as tuples."""
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, (list, tuple)):
        return [_key(v) for v in x]
    if hasattr(x, "__dataclass_fields__"):
        return [type(x).__name__] + [_key(getattr(x, f))
                                     for f in x.__dataclass_fields__]
    return x


@pytest.mark.parametrize("factor,min_history,windows", [
    (4.0, 3, [[1.0, 0.9, 1.1], [1.0, float("nan"), 0.9], [float("inf")],
              [1.05, 50.0], [0.95, 3.9, 4.5]]),
    (0.0, 1, [[1.0, 1e9], [float("-inf")], [2.0]]),
    (10.0, 4, [[5.0, 4.0], [3.0, 100.0], [2.9, 2.8, 31.0], [1.0]]),
])
def test_screen_gives_the_references_anomalies(factor, min_history,
                                               windows):
    ours = LossAnomalyGuard(factor=factor, min_history=min_history,
                            history=4)
    theirs = jres.LossAnomalyGuard(factor=factor, min_history=min_history,
                                   history=4)
    start = 1
    for w in windows:
        got, want = ours.screen(w, start), theirs.screen(w, start)
        assert _key(got) == _key(want)
        start += len(w)
    ours.reset_history([1.0, 2.0, 3.0, 4.0, 5.0])
    theirs.reset_history([1.0, 2.0, 3.0, 4.0, 5.0])
    assert list(ours._hist) == list(theirs._hist)


def test_rollback_resets_guard_history():
    guard = LossAnomalyGuard(factor=4.0, min_history=2)
    assert guard.screen([1.0, 1.1, 0.9, 1.0], 1) is None
    assert len(guard._hist) == 4
    guard.reset_history([1.0, 1.1])
    assert list(guard._hist) == [1.0, 1.1]
    assert guard.screen([0.9, 1.0], 3) is None
    assert list(guard._hist) == [1.0, 1.1, 0.9, 1.0]


# ------------------------- fault schedules: the port and the reference


def _once(at_step, value):
    armed = {"on": True}

    def loss_for(step, x):
        if step == at_step and armed["on"]:
            armed["on"] = False
            return value
        return None
    return loss_for


SCHEDULES = {
    # name: (loss_for factory, run_resilient kwargs, start state)
    "transient-nan": (lambda: _once(6, float("nan")), dict(
        target_step=10, sync_every=2, checkpoint_every=4,
        guard=(10.0, 2), max_rollbacks=3), (0, 0.0)),
    "spike": (lambda: _once(5, 1000.0), dict(
        target_step=8, sync_every=2, checkpoint_every=2,
        guard=(10.0, 2)), (0, 0.0)),
    "persistent-nan": (lambda: (lambda s, x: float("nan") if s == 4
                                else None), dict(
        target_step=8, sync_every=2, checkpoint_every=2,
        guard=(0.0, 4), max_rollbacks=2), (0, 0.0)),
    "persistent-far": (lambda: (lambda s, x: float("nan") if s == 7
                                else None), dict(
        target_step=10, sync_every=2, checkpoint_every=4,
        guard=(0.0, 4), max_rollbacks=2), (0, 0.0)),
    "poison-batch": (lambda: (lambda s, x: float("nan") if x == 4.0
                              else None), dict(
        target_step=8, sync_every=2, checkpoint_every=2,
        guard=(0.0, 4), max_rollbacks=2, skip_anomalous_window=True),
        (0, 0.0)),
    "two-poison-batches": (lambda: (lambda s, x: float("nan")
                                    if x in (4.0, 9.0) else None), dict(
        target_step=8, sync_every=2, checkpoint_every=2,
        guard=(0.0, 4), max_rollbacks=2, skip_anomalous_window=True),
        (0, 0.0)),
    "rollback-after-resume": (lambda: _once(6, float("nan")), dict(
        target_step=8, start_step=4, sync_every=2, checkpoint_every=4,
        guard=(0.0, 4), max_rollbacks=2), (4, float(sum(range(1, 5))))),
    "preempted-at-6": (lambda: None, dict(
        target_step=10, sync_every=2, checkpoint_every=4,
        preempt_at=6), (0, 0.0)),
    "clean": (lambda: None, dict(
        target_step=7, sync_every=3, checkpoint_every=2,
        guard=(25.0, 2)), (0, 0.0)),
}


def _run_schedule(pkg, name, tmp_path):
    make_loss, kw, (s0, w0) = SCHEDULES[name]
    kw = dict(kw)
    res, Manager = ((jres, jckpt.CheckpointManager) if pkg == "ref"
                    else (__import__(
                        "triton_kubernetes_tpu_torch.train.resilience",
                        fromlist=["x"]), CheckpointManager))
    consumed = []
    if "guard" in kw:
        factor, min_history = kw.pop("guard")
        kw["guard"] = res.LossAnomalyGuard(factor=factor,
                                           min_history=min_history)
    preempt_at = kw.pop("preempt_at", None)
    on_sync = None
    if preempt_at is not None:
        kw["preemption"] = res.PreemptionGuard()

        def on_sync(gstep, st, losses, dt):
            if gstep >= preempt_at:
                kw["preemption"].trip()
    ckpt = Manager(str(tmp_path / pkg))
    if s0:
        ckpt.save(s0 - 2, _fake_state(s0 - 2, w=999.0), wait=True)  # stale
    out = dict(consumed=consumed)
    try:
        state, rep = res.run_resilient(
            _fake_step(make_loss(), consumed), _fake_state(s0, w0),
            _fake_batches, ckpt=ckpt, on_sync=on_sync, **kw)
        out.update(report=_key(rep), w=float(state["w"]),
                   step=int(state["step"]))
    except res.AnomalyAbortedError as e:
        out.update(aborted=_key(e.anomaly), message=str(e))
    ckpt.close()
    out["steps_on_disk"] = ckpt.all_steps()
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_fault_schedules_give_the_references_report(name, tmp_path,
                                                    fresh_registry):
    ours = _run_schedule("port", name, tmp_path)
    theirs = _run_schedule("ref", name, tmp_path)
    assert ours == theirs


def test_schedule_outcomes_are_the_documented_ones(tmp_path,
                                                   fresh_registry):
    """The reference test file's assertions, on the port's runs."""
    out = _run_schedule("port", "transient-nan", tmp_path / "a")
    rep = dict(zip(ResilienceReport.__dataclass_fields__, out["report"][1:]))
    assert rep["rollbacks"] == 1 and rep["restored_steps"] == [4]
    assert out["w"] == sum(range(1, 11)) and rep["steps"] == 10
    assert rep["losses"] == [pytest.approx(1.0 / s) for s in range(1, 11)]
    assert metrics_mod.counter("tk8s_train_anomaly_rollbacks_total").value(
        reason="non-finite") == 1
    out = _run_schedule("port", "persistent-far", tmp_path / "b")
    assert "consecutive" in out["message"]
    assert metrics_mod.counter("tk8s_train_anomaly_aborts_total").value() == 1
    out = _run_schedule("port", "two-poison-batches", tmp_path / "c")
    assert out["w"] == 1 + 2 + sum(range(5, 9)) + 11 + 12
    out = _run_schedule("port", "rollback-after-resume", tmp_path / "d")
    rep = dict(zip(ResilienceReport.__dataclass_fields__, out["report"][1:]))
    assert rep["restored_steps"] == [4] and rep["steps"] == 4
    assert out["w"] == sum(range(1, 9))
    out = _run_schedule("port", "preempted-at-6", tmp_path / "e")
    rep = dict(zip(ResilienceReport.__dataclass_fields__, out["report"][1:]))
    assert rep["interrupted"] and rep["emergency_step"] == 6
    with pytest.raises(AnomalyAbortedError, match="no checkpoint manager"):
        run_resilient(_fake_step(_once(2, float("nan"))), _fake_state(),
                      _fake_batches, target_step=4, sync_every=2,
                      guard=LossAnomalyGuard(factor=0.0))
