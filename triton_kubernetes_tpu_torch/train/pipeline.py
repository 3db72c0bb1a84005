"""GPipe over the ``stage`` mesh axis and the step-pipelined training
loop -- the port of ``triton_kubernetes_tpu/train/pipeline.py``
(``pipeline_forward``, ``pipeline_degree``, ``run_pipelined``).

**GPipe.** :func:`pipeline_forward` splits the layers into S contiguous
stages of L/S and runs M microbatches through them on the reference's
schedule: T = M + S - 1 ticks; at each tick the stage buffer shifts
(``concatenate([inject, buf[:-1]])``: stage 0 takes the next microbatch,
stage s the output stage s-1 made at the tick before) and every stage
applies its layers; the last stage's outputs are collected and unembedded.
With no mesh, or a stage axis of 1, every stage runs in this process (the
reference's ``vmap`` branch). With stage > 1 rank s holds stage s (a model
built over the mesh holds only its layers) and the shift is a
:func:`..parallel.collectives.ppermute` along ``stage``.

**Rows.** The reference's microbatch m is rows [m B/M, (m+1) B/M) of the
global batch, and its stage buffer ``[M, mb, S, D]`` is sharded
``P(stage, (data, fsdp), seq)``: each microbatch's rows split over the
row shards. The port places a batch the same way under stage > 1
(``parallel.multihost.make_batch_placer``): rank r of the R = data x fsdp
row shards holds, for each m, rows [m B/M + r B/(M R), m B/M + (r+1)
B/(M R)), in m order, and cuts them into its M local microbatches. So an
MoE layer's routing -- capacity, seats, drops and the aux loss's means,
gathered over the batch axes by ``parallel.placement.MeshRouting`` --
covers one global microbatch at every tick, as in the reference; every
rank of a stage group holds the same m at a tick and skips the same
bubbles, so those gathers pair up. A dense model's loss does not depend
on which rows share a microbatch, so dense results move only by
summation order.

The reference computes its bubbles -- (stage, tick) pairs that hold no
microbatch -- on zero activations and masks their aux loss out; the port
skips them, which gives the same logits and aux. Across ranks a bubble
still takes part in the shift (its output is its input times 0) and the
last tick's unsent outputs feed the aux term times 0, so every rank runs
the backward of every shift and the permutes pair up.

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


def _stage_params(layers: List[Any], num_stages: int) -> List[List[Any]]:
    """The L layers as S contiguous groups of L/S."""
    n = len(layers)
    if n % num_stages:
        raise ValueError(
            f"num_layers ({n}) must divide evenly into "
            f"{num_stages} pipeline stages")
    per = n // num_stages
    return [layers[i * per:(i + 1) * per] for i in range(num_stages)]


def pipeline_forward(model, tokens: torch.Tensor, config, num_stages: int,
                     microbatches: int, attention_fn=None,
                     positions: Optional[torch.Tensor] = None, mesh=None):
    """Pipelined equivalent of ``models.llama.forward``: (logits [B, S, V]
    f32, MoE aux loss / microbatches). On a mesh with stage > 1 the
    logits exist on the last stage only (None elsewhere) and each rank's
    aux is its own stage's share (the sum over the stage axis is the
    reference's).

    For dense configs this is the sequential forward up to summation
    order. For MoE configs routing and capacity run per microbatch, as in
    the reference. ``tokens`` are this rank's rows; on a mesh whose rows
    are split (``data`` or ``fsdp`` > 1) they must be its share of every
    global microbatch in microbatch order, as
    ``parallel.multihost.make_batch_placer`` places them, so the m-th
    local microbatch is this rank's part of the reference's m-th and the
    MoE routing (``parallel.placement.MeshRouting``) seats that global
    microbatch's tokens together."""
    from ..models import llama
    from ..parallel.collectives import ppermute

    attention_fn = attention_fn or llama._dense_attention
    b, s = tokens.shape
    if b % microbatches:
        raise ValueError(
            f"batch ({b}) must divide into {microbatches} microbatches")
    if microbatches % num_stages:
        raise ValueError(
            f"microbatches ({microbatches}) must be a multiple of "
            f"stages ({num_stages})")
    staged = mesh is not None and mesh.shape["stage"] > 1
    if staged and mesh.shape["stage"] != num_stages:
        raise ValueError(
            f"num_stages ({num_stages}) must equal the mesh stage axis "
            f"({mesh.shape['stage']})")
    m_count, mb = microbatches, b // microbatches
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    cos, sin = model.rotary()
    pos_mb = positions.reshape(m_count, mb, s)
    ticks = m_count + num_stages - 1

    def stage_apply(layers_s, x, pos):
        def body(x, layer):
            return llama._block(x, layer, config, cos, sin, pos,
                                attention_fn, model.placement)

        body = llama.remat_block(body, config)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in layers_s:
            x, a = body(x, layer)
            aux = aux + a
        return x, aux

    outputs: List[Optional[torch.Tensor]] = [None] * m_count
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    me = mesh.coordinate()["stage"] if staged else None
    if staged:
        layers_here = list(model.layers)
        if len(layers_here) * num_stages != config.num_layers:
            raise ValueError(
                f"this rank holds {len(layers_here)} layers, not "
                f"{config.num_layers} / {num_stages}: build the model over "
                f"the mesh")
        # Microbatch embeddings up front, on the first stage only.
        x = (llama.embed(model, tokens, config).reshape(m_count, mb, s, -1)
             if me == 0 else None)
        d = config.embed_dim
        dtype = config.activation_dtype
        shift = [(j, j + 1) for j in range(num_stages - 1)]
        prev = torch.zeros((mb, s, d), dtype=dtype, device=tokens.device,
                           requires_grad=torch.is_grad_enabled())
        prev_pos = torch.zeros_like(pos_mb[0])
        for t in range(ticks):
            recv = ppermute(prev, mesh, "stage", shift)
            recv_pos = ppermute(prev_pos, mesh, "stage", shift)
            if me == 0:
                inject = x[t] if t < m_count else torch.zeros_like(recv)
                cur = inject + recv * 0  # stage 0 reads no neighbour
                cur_pos = pos_mb[t] if t < m_count else recv_pos
            else:
                cur, cur_pos = recv, recv_pos
            m = t - me
            if 0 <= m < m_count:
                out, aux = stage_apply(layers_here, cur, cur_pos)
                aux_total = aux_total + aux
                if me == num_stages - 1:
                    outputs[m] = out
            else:  # a bubble: nothing to compute
                out = cur * 0
            prev, prev_pos = out, cur_pos
        if me != num_stages - 1 and prev.requires_grad:
            aux_total = aux_total + prev.float().sum() * 0.0
        if me != num_stages - 1:
            return None, aux_total / m_count
    else:
        stages = _stage_params(list(model.layers), num_stages)
        x = llama.embed(model, tokens, config).reshape(m_count, mb, s, -1)
        # buf[s]: (microbatch, activation) stage s holds, or None.
        buf: List[Optional[Tuple[int, torch.Tensor]]] = [None] * num_stages
        for t in range(ticks):
            buf = [(t, x[t]) if t < m_count else None] + buf[:-1]
            for si, held in enumerate(buf):
                if held is None:
                    continue
                m, act = held
                out, aux = stage_apply(stages[si], act, pos_mb[m])
                aux_total = aux_total + aux
                buf[si] = (m, out)
            if buf[-1] is not None and t >= num_stages - 1:
                outputs[buf[-1][0]] = buf[-1][1]
    h = torch.cat(outputs, dim=0).reshape(b, s, -1)
    # Each microbatch's aux is a mean-over-its-tokens estimate of the same
    # batch-level balance loss; average them to match the sequential scale.
    return llama.unembed(h, model, config=config), aux_total / m_count


def pipeline_degree(mesh) -> int:
    return mesh.shape["stage"]


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
