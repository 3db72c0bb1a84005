"""Step-timing harness -- the port of
``triton_kubernetes_tpu/train/measure.py`` (``measure_throughput``,
``measure_tokens_per_sec``) for one process.

Two-point timing: a short and a long window run through
:func:`.pipeline.run_pipelined`, each ending in a host sync (a metric
transfer, which waits for the card), and the rate is taken over their
difference, which cancels the fixed cost of starting and draining a
window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple


@dataclass(frozen=True)
class ThroughputReport:
    """One timed measurement: steps/s and tokens/s over the two-point
    window, the last loss, and the process count (1 in the port)."""

    steps_per_sec: float
    tokens_per_sec: float
    loss: float
    n_processes: int
    steps_timed: int        # n_long - n_short
    window_seconds: float   # t_long - t_short


def measure_throughput(step, state, batches: List[Dict[str, Any]],
                       tokens_per_step: int, warmup: int,
                       n_short: int, n_long: int,
                       ) -> Tuple[ThroughputReport, Any]:
    """Warm up, then time ``n_short`` and ``n_long`` steps, each window
    synced once at its end; returns ``(ThroughputReport, final_state)``."""
    from .pipeline import run_pipelined

    if n_long <= n_short:
        raise ValueError(
            f"n_long ({n_long}) must exceed n_short ({n_short})")

    def run(n):
        nonlocal state
        t0 = time.perf_counter()
        loss = float("nan")
        if n:
            state, report = run_pipelined(
                step, state, list(batches), max_steps=n, sync_every=n,
                tokens_per_step=tokens_per_step)
            loss = report.losses[-1]
        return time.perf_counter() - t0, loss

    run(warmup)
    t_short, _ = run(n_short)
    t_long, loss = run(n_long)
    dt = max(t_long - t_short, 1e-9)
    steps = n_long - n_short
    return ThroughputReport(
        steps_per_sec=steps / dt,
        tokens_per_sec=tokens_per_step * steps / dt,
        loss=loss,
        n_processes=1,
        steps_timed=steps,
        window_seconds=dt,
    ), state


def measure_tokens_per_sec(step, state, batches: List[Dict[str, Any]],
                           tokens_per_step: int, warmup: int,
                           n_short: int, n_long: int,
                           ) -> Tuple[float, float, Any]:
    """``(tokens/sec, last loss, final state)``; see
    :func:`measure_throughput`."""
    report, state = measure_throughput(
        step, state, batches, tokens_per_step, warmup, n_short, n_long)
    return report.tokens_per_sec, report.loss, state
