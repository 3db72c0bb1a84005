"""Survive the step: preemption-aware saves and loss-anomaly rollback --
the port of ``triton_kubernetes_tpu/train/resilience.py``, wrapping the
step-pipelined loop (``train/pipeline.py`` ``run_pipelined``) with the
reference's three protections:

1. **Preemption-aware emergency save** -- :class:`PreemptionGuard` turns
   SIGTERM/SIGINT into a flag the loop polls before each dispatch; on
   trip the partial window is synced, a synchronous emergency checkpoint
   is written (``kind="emergency"``, manifest-committed), and the trainer
   exits with :data:`EXIT_RESUME` so a restart policy resumes the job.
2. **Loss-anomaly guard with rollback** -- at each sync window the
   already-fetched losses are screened for NaN/Inf and for a spike over a
   running median (:class:`LossAnomalyGuard`). On trip the loop restores
   the last verified checkpoint (from disk, never from a copy kept in
   memory), rebuilds the data stream at the restored step, optionally
   skips the offending window's batches, and gives up with
   :class:`AnomalyAbortedError` after ``max_rollbacks`` consecutive trips.
3. **Verified restore under everything** -- rollbacks go through
   ``CheckpointManager.restore``, which quarantines torn steps and falls
   back (``train/checkpoint.py``).

The non-tripping path adds one host-side screen per window over floats
already fetched, so per-step losses stay bitwise those of the bare loop.
"""

from __future__ import annotations

import math
import signal
import statistics
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# EX_TEMPFAIL, the "resume me" exit code (single-sourced in constants.py).
from ..constants import EXIT_RESUME
from .pipeline import run_pipelined


class AnomalyAbortedError(RuntimeError):
    """The guarded loop gave up: ``max_rollbacks`` consecutive anomaly
    trips without a clean window in between. Carries the last anomaly."""

    def __init__(self, message: str, anomaly: "Anomaly"):
        super().__init__(message)
        self.anomaly = anomaly


#: Mesh axes whose product must fit within one process's local devices
#: (ICI), vs the DCN axes (data, stage) that span processes -- the
#: reference's split (``parallel/mesh.create_hybrid_mesh``).
_ICI_AXES = ("fsdp", "seq", "expert", "tensor")


@dataclass(frozen=True)
class MeshAxes:
    """Axis sizes of a negotiated mesh -- the fields of the reference's
    ``parallel.mesh.MeshConfig`` (the port builds no mesh: one card)."""

    data: int = 1
    stage: int = 1
    fsdp: int = 1
    seq: int = 1
    expert: int = 1
    tensor: int = 1


def negotiate_mesh_config(saved: Optional[Dict[str, Any]], *,
                          n_processes: int, n_devices: int) -> MeshAxes:
    """Elastic shape negotiation, as pure arithmetic: the axis sizes a
    restart should use, from the manifest-v2 ``mesh`` section of the
    newest surviving checkpoint and the fleet that came up.

    The recorded ICI block (fsdp x seq x expert x tensor) and the stage
    axis are kept -- they partition *model* dimensions -- and the data
    axis absorbs the fleet delta: ``data = n_devices / (ici x stage)``.
    For one device: data 1 when the saved ICI x stage block is 1,
    :class:`~.checkpoint.ReshapeError` otherwise."""
    from .checkpoint import ReshapeError

    fleet = f"{n_devices} devices / {n_processes} processes"
    if not saved or not saved.get("axes"):
        raise ReshapeError(
            f"cannot negotiate a mesh for {fleet}: the checkpoint "
            f"manifest records no mesh (format-1 manifest from a "
            f"pre-elastic writer) — pass the mesh flags explicitly")
    axes = {str(k): int(v) for k, v in saved["axes"].items()}
    stage = axes.get("stage", 1)
    ici = 1
    for name in _ICI_AXES:
        ici *= axes.get(name, 1)
    saved_shape = "x".join(f"{k}={v}" for k, v in sorted(axes.items())
                           if v != 1) or "single-device"
    if ici * stage <= 0 or n_devices % (ici * stage):
        raise ReshapeError(
            f"cannot negotiate a mesh for {fleet}: the recorded ICI "
            f"block (ici={ici}, stage={stage}) of saved mesh "
            f"[{saved_shape}] does not divide {n_devices} devices — "
            f"resume on a multiple of {ici * stage} devices or reshard "
            f"offline")
    data = n_devices // (ici * stage)
    if (data * stage) % max(n_processes, 1):
        raise ReshapeError(
            f"cannot negotiate a mesh for {fleet}: DCN axes "
            f"(data={data}, stage={stage}) cannot span {n_processes} "
            f"processes evenly (saved mesh [{saved_shape}])")
    if n_processes > 1:
        local = n_devices // n_processes
        if local <= 0 or local % ici:
            raise ReshapeError(
                f"cannot negotiate a mesh for {fleet}: the recorded "
                f"ICI block (ici={ici}) no longer fits one process's "
                f"{local} local devices (saved mesh [{saved_shape}])")
    return MeshAxes(data=data, stage=stage,
                    fsdp=axes.get("fsdp", 1), seq=axes.get("seq", 1),
                    expert=axes.get("expert", 1),
                    tensor=axes.get("tensor", 1))


class PreemptionGuard:
    """SIGTERM/SIGINT -> a flag the training loop polls.

    Signal handlers must be installed from the main thread; ``install``
    raises ``ValueError`` elsewhere (callers may then run unguarded).
    ``trip()`` sets the flag programmatically; the signal path and it are
    equivalent.
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT)):
        self.signals = signals
        self.signum: Optional[int] = None
        self._event = threading.Event()
        self._prev: Dict[int, Any] = {}

    def install(self) -> "PreemptionGuard":
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        while self._prev:
            sig, prev = self._prev.popitem()
            signal.signal(sig, prev)

    def _handle(self, signum, frame) -> None:
        self.signum = signum
        self._event.set()

    def trip(self) -> None:
        self._event.set()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


@dataclass(frozen=True)
class Anomaly:
    """One tripped loss: which step, what value, why."""

    step: int          # absolute (global) step of the offending loss
    loss: float
    reason: str        # "non-finite" | "spike"
    median: float      # running median at screening time (nan for n-f)


class LossAnomalyGuard:
    """Screens per-window losses for NaN/Inf and median-relative spikes.

    Only healthy losses enter the running-median history, so a slow ramp
    cannot drag the baseline up to meet the spike it should have caught.
    ``factor`` <= 0 disables the spike rule (non-finite always trips);
    ``min_history`` healthy losses are required before spikes arm.
    """

    def __init__(self, factor: float = 10.0, min_history: int = 4,
                 history: int = 256):
        self.factor = factor
        self.min_history = min_history
        self._hist: deque = deque(maxlen=history)

    def screen(self, losses: List[float], start_step: int) -> Optional[Anomaly]:
        """First anomalous loss of a window (absolute steps start at
        ``start_step`` for ``losses[0]``), or None; healthy prefix values
        are absorbed into the history either way."""
        for i, loss in enumerate(losses):
            if not math.isfinite(loss):
                return Anomaly(start_step + i, loss, "non-finite",
                               float("nan"))
            if self.factor > 0 and len(self._hist) >= self.min_history:
                med = statistics.median(self._hist)
                if loss > med * self.factor:
                    return Anomaly(start_step + i, loss, "spike", med)
            self._hist.append(loss)
        return None

    def reset_history(self, losses: List[float]) -> None:
        """Replace the running-median history (rollback support: replayed
        windows must not enter the history twice and skew the median)."""
        self._hist.clear()
        self._hist.extend(losses[-(self._hist.maxlen or len(losses)):])


@dataclass
class ResilienceReport:
    """What one ``run_resilient`` call did, on the host."""

    steps: int = 0                      # accepted steps past start_step
    losses: List[float] = field(default_factory=list)  # accepted, in order
    rollbacks: int = 0
    anomalies: List[Anomaly] = field(default_factory=list)
    interrupted: bool = False           # preemption flag tripped
    emergency_step: Optional[int] = None
    restored_steps: List[int] = field(default_factory=list)  # rollback targets
    sync_points: int = 0


class _AnomalyTrip(Exception):
    """Internal unwind from the sync callback to the segment driver."""


def run_resilient(
    step_fn: Callable[[Any, Any], Tuple[Any, Dict[str, Any]]],
    state: Any,
    make_batches: Callable[[int], Any],
    *,
    ckpt: Any = None,                   # train.checkpoint.CheckpointManager
    emergency_ckpt: Any = None,         # defaults to ckpt
    target_step: int,
    start_step: int = 0,
    sync_every: int = 8,
    checkpoint_every: int = 0,
    guard: Optional[LossAnomalyGuard] = None,
    max_rollbacks: int = 3,
    skip_anomalous_window: bool = False,
    start_is_checkpointed: bool = False,
    preemption: Optional[PreemptionGuard] = None,
    tokens_per_step: int = 0,
    config_name: str = "",
    on_sync: Optional[Callable[[int, Any, List[float], float], None]] = None,
    on_checkpoint: Optional[Callable[[int, str], None]] = None,
    step_floor_seconds: float = 0.0,
    goodput: Any = None,
) -> Tuple[Any, ResilienceReport]:
    """Drive ``run_pipelined`` to ``target_step`` under the guards.

    ``make_batches(step)`` returns a fresh batch iterable positioned so
    its first batch is the one step ``step + 1`` consumes -- the trainer's
    deterministic stream replay; it may return ``(iterable, prefetch)``
    to keep ``DevicePrefetch`` wait accounting flowing. Each segment's
    iterable is closed (if closeable) when the segment ends.

    Checkpoints are cadenced at absolute ``checkpoint_every`` multiples
    (windows force-split there) and are what rollback restores; with a
    ``guard`` and no verified checkpoint at ``start_step``, a baseline
    save is taken first so the very first window is already protected.
    ``on_sync(gstep, state, window_losses, dt)`` fires per clean window
    with *absolute* steps; ``on_checkpoint(gstep, kind)`` after each save.

    A rollback restores ``ckpt.restore(state, step=...)``: the port's
    restore copies the checkpoint into the live state's tensors in place
    (the reference restores into an abstract template instead).

    ``goodput`` is an optional :class:`..utils.trace.GoodputRecorder`
    (``train`` vocabulary): the inner loop books ``step``/``data_wait``/
    ``host_sync``; this driver adds ``checkpoint`` across every save,
    ``rollback_replay`` from an anomaly trip through the restore and
    across the replayed steps up to the tripped window, and
    ``preempted_lost`` from the preemption flag to the end. Segments
    close exactly when the next opens, so the ledger partitions wall time
    whatever the fault schedule does.
    """
    from ..utils import metrics as _metrics

    if emergency_ckpt is None:
        emergency_ckpt = ckpt
    report = ResilienceReport()
    done = start_step        # accepted model step
    data_pos = start_step    # data-stream position (diverges under skip)
    # Model step -> data-stream position when that step's checkpoint was
    # taken: skips move data_pos ahead of done, so a rollback must land
    # the stream where it was at the restored step.
    data_at: Dict[int, int] = {start_step: start_step}
    consecutive = 0
    trip_high = start_step  # furthest window a trip has reached
    rollback_counter = _metrics.counter("tk8s_train_anomaly_rollbacks_total")

    if (guard is not None and ckpt is not None
            and not start_is_checkpointed):
        # Rollback needs a landing spot AT start_step in the scheduled
        # dir; ``start_is_checkpointed`` (the caller just restored this
        # exact step from ``ckpt``) skips the re-hash.
        if ckpt.latest_verified_step() != start_step:
            if goodput is not None:
                goodput.transition("checkpoint")
            ckpt.save(start_step, state, wait=True)
            if goodput is not None:
                goodput.transition("idle")
            if on_checkpoint is not None:
                on_checkpoint(start_step, "scheduled")

    while done < target_step:
        if preemption is not None and preemption.requested:
            report.interrupted = True
            break
        made = make_batches(data_pos)
        batches, prefetch = made if isinstance(made, tuple) else (made, None)
        seg_base = done
        seg_data = data_pos  # step s of this segment reads data index
        #                      seg_data + (s - seg_base)
        last_mark = seg_base // checkpoint_every if checkpoint_every else 0
        trip: Dict[str, Any] = {}

        def _on_sync(seg_done: int, cur_state: Any,
                     window_losses: List[float], dt: float) -> None:
            nonlocal consecutive, last_mark
            gstep = seg_base + seg_done
            if guard is not None:
                anomaly = guard.screen(
                    window_losses, gstep - len(window_losses) + 1)
                if anomaly is not None:
                    trip["anomaly"] = anomaly
                    trip["window_end"] = gstep
                    raise _AnomalyTrip()
            if gstep > trip_high:
                # Only progress PAST the furthest trip resets the abort
                # budget: replayed clean windows behind a recurring
                # anomaly must not refill it.
                consecutive = 0
            report.losses.extend(window_losses)
            report.sync_points += 1
            if ckpt is not None and checkpoint_every:
                mark = gstep // checkpoint_every
                if mark > last_mark:
                    last_mark = mark
                    prev = None
                    if goodput is not None:
                        t0 = goodput.clock()
                        prev = goodput.state
                        goodput.transition("checkpoint", t0)
                    ckpt.save(gstep, cur_state)
                    data_at[gstep] = seg_data + (gstep - seg_base)
                    if goodput is not None:
                        t1 = goodput.clock()
                        if goodput.writer is not None:
                            goodput.writer.event(
                                "train.checkpoint", t0, t1 - t0,
                                step=gstep, kind="scheduled")
                        if prev is not None:
                            goodput.transition(prev, t1)
                    if on_checkpoint is not None:
                        on_checkpoint(gstep, "scheduled")
            if on_sync is not None:
                on_sync(gstep, cur_state, window_losses, dt)

        force_sync = None
        if checkpoint_every:
            force_sync = (
                lambda n, base=seg_base: (base + n) % checkpoint_every == 0)
        should_stop = (
            (lambda: preemption.requested) if preemption is not None else None)
        # After a rollback, steps at or below the tripped window re-execute
        # work a fault already paid for: booked rollback_replay, not step.
        step_category = None
        if goodput is not None and trip_high > seg_base:
            step_category = (
                lambda n, base=seg_base, high=trip_high:
                "rollback_replay" if base + n <= high else "step")
        try:
            state, seg = run_pipelined(
                step_fn, state, batches,
                sync_every=sync_every, max_steps=target_step - seg_base,
                tokens_per_step=tokens_per_step, config_name=config_name,
                on_sync=_on_sync, force_sync=force_sync,
                should_stop=should_stop, prefetch=prefetch,
                step_floor_seconds=step_floor_seconds,
                goodput=goodput, goodput_step_category=step_category)
        except _AnomalyTrip:
            anomaly: Anomaly = trip["anomaly"]
            report.anomalies.append(anomaly)
            trip_high = max(trip_high, trip["window_end"])
            consecutive += 1
            if consecutive > max_rollbacks:
                _metrics.counter("tk8s_train_anomaly_aborts_total").inc()
                raise AnomalyAbortedError(
                    f"aborting after {max_rollbacks} consecutive "
                    f"loss-anomaly rollbacks without a clean window "
                    f"(last: {anomaly.reason} loss={anomaly.loss} at step "
                    f"{anomaly.step})", anomaly)
            if ckpt is None:
                _metrics.counter("tk8s_train_anomaly_aborts_total").inc()
                raise AnomalyAbortedError(
                    f"loss anomaly at step {anomaly.step} "
                    f"({anomaly.reason}, loss={anomaly.loss}) with no "
                    f"checkpoint manager to roll back to", anomaly)
            report.rollbacks += 1
            rollback_counter.inc(reason=anomaly.reason)
            # Newest checkpoint THIS RUN anchored at/below the tripped
            # window; restore still falls back further if it fails
            # verification.
            target = max(s for s in data_at if s <= trip["window_end"])
            if goodput is not None:
                t0 = goodput.clock()
                goodput.transition("rollback_replay", t0)
                if goodput.writer is not None:
                    goodput.writer.event(
                        "train.rollback", t0,
                        window_end=trip["window_end"], target=target)
            state = ckpt.restore(state, step=target)
            good = ckpt.last_restored_step
            if goodput is not None and goodput.writer is not None:
                goodput.writer.event("train.restore", goodput.clock(),
                                     step=good, rollback=True)
            report.restored_steps.append(good)
            del report.losses[max(good - start_step, 0):]
            guard.reset_history(report.losses)  # replays must not re-enter
            done = good
            # Both branches work in DATA space, honouring earlier skips:
            # resume the stream where the restored step left it, or just
            # past the offending window's last consumed batch.
            data_pos = (seg_data + (trip["window_end"] - seg_base)
                        if skip_anomalous_window
                        else data_at.get(good, good))
            continue
        finally:
            close = getattr(batches, "close", None) or getattr(
                prefetch, "close", None)
            if close is not None:
                close()
        done = seg_base + seg.steps
        data_pos += seg.steps
        if seg.interrupted:
            report.interrupted = True
            break
        if seg.steps < target_step - seg_base:
            break  # data exhausted: a short epoch, reported not raised

    report.steps = done - start_step
    if report.interrupted:
        if goodput is not None:
            # No-op when the inner loop already opened it; covers the
            # flag tripping between segments.
            goodput.transition("preempted_lost")
            if goodput.writer is not None:
                goodput.writer.event("train.preempt", goodput.clock(),
                                     step=done)
        # Nothing new trained => the state at ``done`` is already durable
        # (or a deterministic re-init): saving again would only
        # quarantine-and-rewrite a good on-disk step inside the kill
        # window. Skip; exit-for-resume is still correct.
        if emergency_ckpt is not None and done > start_step:
            t0 = goodput.clock() if goodput is not None else 0.0
            if goodput is not None:
                goodput.transition("checkpoint", t0)
            emergency_ckpt.save(done, state, kind="emergency")
            if goodput is not None:
                t1 = goodput.clock()
                if goodput.writer is not None:
                    goodput.writer.event("train.checkpoint", t0, t1 - t0,
                                         step=done, kind="emergency")
                goodput.transition("preempted_lost", t1)
            report.emergency_step = done
            if on_checkpoint is not None:
                on_checkpoint(done, "emergency")
    return state, report


__all__ = [
    "EXIT_RESUME", "AnomalyAbortedError", "Anomaly", "LossAnomalyGuard",
    "MeshAxes", "PreemptionGuard", "ResilienceReport",
    "negotiate_mesh_config", "run_resilient",
]
