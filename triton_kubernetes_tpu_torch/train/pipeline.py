"""The step-pipelined training loop -- the port of ``run_pipelined`` in
``triton_kubernetes_tpu/train/pipeline.py`` (its GPipe schedule is the
distributed slice's work).

PyTorch queues CUDA work asynchronously, so the fast loop is the one that
never forces a device->host sync: steps are issued back to back, their
metrics stay device scalars, and the host syncs once per window of
``sync_every`` steps -- one transfer of the window's metrics, which also
drains the queue and so bounds how far the host runs ahead. Per-step
losses are the same whatever the cadence; only when the host waits moves.

With a ``GoodputRecorder("train")`` the loop partitions its own wall time
as the reference's does: ``data_wait`` while pulling the next batch, the
step's category (``step``, or what ``goodput_step_category`` says) across
its dispatch, ``host_sync`` across each window's drain, ``idle`` at the
end, and one ``train.window`` span per window on the recorder's writer.
Host time: a step's device work lands in whichever category the host is
in when it blocks, the window's ``host_sync`` as a rule.

The loop's other hooks are the reference's: ``force_sync`` closes a window
early at caller boundaries (checkpoint multiples), ``should_stop`` ends
the loop after syncing the partial window (the preemption path of
``train/resilience.py``), ``prefetch`` names the ``DevicePrefetch``
whose wait is mirrored into ``tk8s_train_prefetch_wait_seconds``, and
``step_floor_seconds`` paces dispatch to a modelled device time.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..utils import metrics as _metrics


@dataclass
class LoopReport:
    """What one ``run_pipelined`` call did, on the host."""

    steps: int = 0
    losses: List[float] = field(default_factory=list)  # per step, in order
    history: List[Dict[str, float]] = field(default_factory=list)
    windows: List[Tuple[int, float]] = field(default_factory=list)
    sync_points: int = 0
    interrupted: bool = False  # should_stop tripped; partial window synced
    wall_seconds: float = 0.0
    steps_per_sec: float = 0.0
    tokens_per_sec: float = 0.0
    prefetch_wait_seconds: float = 0.0
    last_metrics: Dict[str, float] = field(default_factory=dict)


def run_pipelined(
    step_fn: Callable[[Any, Any], Tuple[Any, Dict[str, torch.Tensor]]],
    state: Any,
    batches: Iterable[Any],
    *,
    sync_every: int = 8,
    max_steps: Optional[int] = None,
    tokens_per_step: int = 0,
    config_name: str = "",
    on_sync: Optional[Callable[[int, Any, List[float], float], None]] = None,
    force_sync: Optional[Callable[[int], bool]] = None,
    should_stop: Optional[Callable[[], bool]] = None,
    prefetch: Any = None,
    clock: Optional[Callable[[], float]] = None,
    step_floor_seconds: float = 0.0,
    goodput: Any = None,
    goodput_step_category: Optional[Callable[[int], str]] = None,
) -> Tuple[Any, LoopReport]:
    """Issue every step, sync every ``sync_every``.

    ``batches`` is any iterable of step inputs (a list/tuple is cycled --
    pass ``max_steps`` then); a finite iterator ends the loop early.
    ``on_sync(step, state, window_losses, window_seconds)`` runs at each
    sync point, the only place for logging. Each window's metrics (every
    key of every step) come back in one transfer: ``report.history`` holds
    them per step, ``report.windows`` each window's (steps, seconds).

    ``force_sync(steps_done)`` may close a window early at
    caller-meaningful boundaries (checkpoint multiples) without shrinking
    ``sync_every`` for every other window. ``should_stop()`` is polled
    before each dispatch (a host flag read); when it turns true the loop
    syncs the partial window and returns with ``report.interrupted`` set:
    that sync point is where an emergency checkpoint is safe to take.
    ``prefetch`` names the :class:`.data.DevicePrefetch` feeding
    ``batches`` when the iterable wraps it, so its input wait still
    reaches the gauge (and ``report.prefetch_wait_seconds``).

    ``step_floor_seconds`` is a deterministic per-step device-time floor:
    the host sleeps only the remainder of the floor after each dispatch,
    so real (async) compute overlaps it and per-step wall converges to
    ``max(floor, compute)``; losses are untouched. 0 disables it.

    ``clock`` times the loop (default: the goodput recorder's clock when
    one is given, else ``time.perf_counter``). ``goodput`` is an optional
    :class:`..utils.trace.GoodputRecorder` (``train`` vocabulary) sharing
    that clock: the loop books ``data_wait``, the step's category,
    ``host_sync`` and, from the moment ``should_stop`` trips,
    ``preempted_lost``, segments closing exactly when the next opens.
    ``goodput_step_category(n)`` (``n`` = 1-based step index within this
    call) books a step under another category than ``step`` (the trainer
    books its first step, which builds the kernels, as ``compile``; the
    resilient driver books replayed steps as ``rollback_replay``)."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    if isinstance(batches, (list, tuple)):
        if max_steps is None:
            raise ValueError(
                "a list of batches is cycled forever; pass max_steps")
        batches_it: Iterable[Any] = itertools.cycle(batches)
    else:
        batches_it = batches
    if max_steps is not None:
        batches_it = itertools.islice(batches_it, max_steps)

    hist = _metrics.histogram("tk8s_train_step_duration_seconds")
    tokens_total = _metrics.counter("tk8s_train_tokens_total")
    syncs_total = _metrics.counter("tk8s_train_host_syncs_total")
    wait_gauge = _metrics.gauge("tk8s_train_prefetch_wait_seconds")
    inflight_gauge = _metrics.gauge("tk8s_train_steps_in_flight")

    if clock is None:
        clock = goodput.clock if goodput is not None else time.perf_counter
    report = LoopReport()
    window: List[Dict[str, torch.Tensor]] = []
    t_start = clock()
    t_window = t_start

    def sync() -> None:
        nonlocal t_window
        if not window:
            return
        if goodput is not None and not report.interrupted:
            # An interrupted partial window drains under the category
            # should_stop opened (preempted_lost): that drain is recovery
            # work, not a routine host sync.
            goodput.transition("host_sync")
        inflight_gauge.set(len(window))
        # THE host sync: one transfer of every metric of the window
        # (device scalars as a rule; host scalars pass through).
        keys = sorted(window[0])
        rows = torch.stack([torch.stack([torch.as_tensor(m[k]).float()
                                         for k in keys])
                            for m in window]).tolist()
        dt = clock() - t_window
        steps = [dict(zip(keys, row)) for row in rows]
        window_losses = [s["loss"] for s in steps]
        report.history.extend(steps)
        report.losses.extend(window_losses)
        report.last_metrics = steps[-1]
        report.windows.append((len(window), dt))
        report.sync_points += 1
        for _ in window:
            hist.observe(dt / len(window), config=config_name)
        if tokens_per_step:
            tokens_total.inc(tokens_per_step * len(window),
                             config=config_name)
        syncs_total.inc(config=config_name)
        wait = getattr(prefetch if prefetch is not None else batches,
                       "wait_seconds", None)
        if wait is not None:
            report.prefetch_wait_seconds = float(wait)
            wait_gauge.set(float(wait))
        inflight_gauge.set(0)
        n_window = len(window)
        window.clear()
        if goodput is not None and goodput.writer is not None:
            goodput.writer.event("train.window", t_window, dt,
                                 steps=n_window, loss=window_losses[-1])
        if on_sync is not None:
            on_sync(report.steps, state, window_losses, dt)
        t_window = clock()

    t_dispatch = clock()
    it = iter(batches_it)
    _end = object()
    while True:
        if goodput is not None:
            goodput.transition("data_wait")
        batch = next(it, _end)
        if batch is _end:
            break
        if should_stop is not None and should_stop():
            if goodput is not None:
                goodput.transition("preempted_lost")
            report.interrupted = True
            break
        if goodput is not None:
            goodput.transition(
                goodput_step_category(report.steps + 1)
                if goodput_step_category is not None else "step")
        if step_floor_seconds > 0.0:
            # Pace dispatch to the floor; sleeping frees the core for the
            # steps already queued, so compute overlaps the modelled time.
            remain = step_floor_seconds - (clock() - t_dispatch)
            if remain > 0:
                time.sleep(remain)
            t_dispatch = clock()
        state, step_metrics = step_fn(state, batch)
        window.append(step_metrics)
        report.steps += 1
        if len(window) >= sync_every or (
                force_sync is not None and force_sync(report.steps)):
            sync()
    sync()
    if goodput is not None and not report.interrupted:
        goodput.transition("idle")
    report.wall_seconds = max(clock() - t_start, 1e-9)
    report.steps_per_sec = report.steps / report.wall_seconds
    report.tokens_per_sec = (
        report.steps * tokens_per_step / report.wall_seconds)
    return state, report
