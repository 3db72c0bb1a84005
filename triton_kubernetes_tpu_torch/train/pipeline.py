"""The step-pipelined training loop -- the port of ``run_pipelined`` in
``triton_kubernetes_tpu/train/pipeline.py`` (its GPipe schedule is the
distributed slice's work).

PyTorch queues CUDA work asynchronously, so the fast loop is the one that
never forces a device->host sync: steps are issued back to back, their
metrics stay device scalars, and the host syncs once per window of
``sync_every`` steps -- one transfer of the window's metrics, which also
drains the queue and so bounds how far the host runs ahead. Per-step
losses are the same whatever the cadence; only when the host waits moves.
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
    wall_seconds: float = 0.0
    steps_per_sec: float = 0.0
    tokens_per_sec: float = 0.0
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
) -> Tuple[Any, LoopReport]:
    """Issue every step, sync every ``sync_every``.

    ``batches`` is any iterable of step inputs (a list/tuple is cycled --
    pass ``max_steps`` then); a finite iterator ends the loop early.
    ``on_sync(step, state, window_losses, window_seconds)`` runs at each
    sync point, the only place for logging. Each window's metrics (every
    key of every step) come back in one transfer: ``report.history`` holds
    them per step, ``report.windows`` each window's (steps, seconds)."""
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
    inflight_gauge = _metrics.gauge("tk8s_train_steps_in_flight")

    report = LoopReport()
    window: List[Dict[str, torch.Tensor]] = []
    t_start = time.perf_counter()
    t_window = t_start

    def sync() -> None:
        nonlocal t_window
        if not window:
            return
        inflight_gauge.set(len(window))
        # THE host sync: one transfer of every metric of the window.
        keys = sorted(window[0])
        rows = torch.stack([torch.stack([m[k].float() for k in keys])
                            for m in window]).tolist()
        dt = time.perf_counter() - t_window
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
        inflight_gauge.set(0)
        window.clear()
        if on_sync is not None:
            on_sync(report.steps, state, window_losses, dt)
        t_window = time.perf_counter()

    for batch in batches_it:
        state, step_metrics = step_fn(state, batch)
        window.append(step_metrics)
        report.steps += 1
        if len(window) >= sync_every:
            sync()
    sync()
    report.wall_seconds = max(time.perf_counter() - t_start, 1e-9)
    report.steps_per_sec = report.steps / report.wall_seconds
    report.tokens_per_sec = (
        report.steps * tokens_per_step / report.wall_seconds)
    return state, report
