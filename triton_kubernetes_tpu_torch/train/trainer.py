"""The train step -- the port of ``triton_kubernetes_tpu/train/trainer.py``
(``make_optimizer``, ``init_state``, ``loss_fn``, ``make_train_step``,
``make_eval_step``, ``batch_spec``, ``param_shardings``,
``_resolve_attention``), on one device or over a mesh.

Over a mesh (``mesh=``, ``parallel/mesh.py``) the state's model holds this
rank's blocks (``models.llama`` built with ``mesh=``) and so do both Adam
moments (ZeRO: the reference's ``_constrain_opt_state``); the step takes
this rank's batch rows (``batch_spec``: the batch splits over ``data`` and
``fsdp``, data-major; ``parallel.multihost.make_batch_placer`` cuts them
from the global batch, under ``stage`` > 1 as its share of every global
microbatch, in microbatch order), cuts its ``seq`` part of the tokens, runs the
model's one forward on its blocks (``models/llama.py`` through the
model's placement, ``parallel/placement.py``; GPipe over ``stage``,
``train/pipeline.py``; an MoE model's experts over ``expert``, its
routing over the global batch), sums the gradients over the axes each leaf is
replicated along, and updates its blocks with the global norm of the
whole gradient. Every rank of the mesh calls the step in lockstep.

The optimizer is the reference's ``optax.chain(clip_by_global_norm,
adamw(warmup_cosine_decay_schedule))`` written out with its exact
semantics, not PyTorch's defaults:

* the clip scales every gradient by ``max_norm / norm`` (as ``(g / norm) *
  max_norm``) when ``norm >= max_norm``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
* the schedule is evaluated at the update count *before* it is
  incremented, so with ``init_value=0`` the first update's rate is 0;
* AdamW: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
  correction at the incremented count (``1 - b^count`` in f32), ``u =
  mu_hat / (sqrt(nu_hat) + eps)`` with ``eps=1e-8``, decoupled decay ``u
  += wd * p`` on every leaf, then ``p += -lr * u``.

Parameters, gradients and both moments are f32 (the master dtype of the
precision policies) and are updated in place; the reference rebinds
donated buffers instead. A step leaves its metrics on the device, so the
loop (``train/pipeline.py``) syncs once per window, not once per step.
"""

from __future__ import annotations

import math
import os
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import llama
from ..models.config import ModelConfig
from ..ops.fused_ce import cross_entropy_with_integer_labels, \
    fused_cross_entropy
from ..ops.attention import causal_attention
from ..parallel.collectives import (all_gather, all_reduce_sum,
                                    broadcast_from, gather_replicated,
                                    mean_over, select)
from ..parallel.mesh import (AXIS_DATA, AXIS_FSDP, AXIS_SEQ, AXIS_STAGE,
                             AXIS_TENSOR)
from ..parallel.sharding import DEFAULT_RULES, spec_tree_from_logical
from .pipeline import pipeline_degree, pipeline_forward

# The axes a loss is partitioned over (ranks hold different tokens).
PARTITION_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_SEQ)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then cosine decay to
    ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, span)
        cosine = 0.5 * (1 + math.cos(math.pi * c / span))
        return peak_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


@dataclass
class AdamWState:
    """The moments of every parameter (f32, same order as the params) and
    the update count, shared by the Adam bias correction and the
    schedule."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclass
class Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    b1, b2, eps, weight_decay))`` over a list of parameters."""

    schedule: Callable[[int], float]
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        return AdamWState(
            count=0,
            mu=[torch.zeros_like(p, memory_format=torch.preserve_format)
                for p in params],
            nu=[torch.zeros_like(p, memory_format=torch.preserve_format)
                for p in params])

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamWState,
               norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update of ``params`` in place; returns the gradients'
        global norm before clipping (a device scalar). A sharded step
        passes ``norm``, the norm of the whole gradient across ranks."""
        if norm is None:
            norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                  for g in grads))
        keep = norm < self.max_grad_norm
        lr = self.schedule(state.count)
        count = state.count + 1
        # 1 - b^count in f32, as optax computes it.
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.int32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.int32(count))
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g = torch.where(keep, g, (g / norm) * self.max_grad_norm)
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * torch.square(g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u.add_(self.weight_decay * p)
            p.add_(-lr * u)
        state.count = count
        return norm


def make_optimizer(
    learning_rate: float = 3e-4,
    warmup_steps: int = 100,
    decay_steps: int = 10_000,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
    b1: float = 0.9,
    b2: float = 0.95,
) -> Optimizer:
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=learning_rate, warmup_steps=warmup_steps,
        decay_steps=max(decay_steps, warmup_steps + 1))
    return Optimizer(schedule, max_grad_norm=max_grad_norm, b1=b1, b2=b2,
                     weight_decay=weight_decay)


@dataclass
class TrainState:
    """Step count, the trainable model (its parameters are the f32
    masters) and the optimizer state; a step updates all three in place."""

    step: int
    model: llama.Llama
    opt_state: AdamWState = field(repr=False)


def init_state(config: ModelConfig, optimizer: Optimizer, seed: int = 0,
               device: torch.device | str = "cuda", mesh=None) -> TrainState:
    """A trainable model from the reference's init rule (``torch``
    generator, seeded) and a fresh optimizer state, on ``device``; over
    ``mesh`` this rank's blocks of both (the values are the one-device
    model's at any mesh shape)."""
    model = llama.init_params(config, seed=seed, device=device,
                              trainable=True, mesh=mesh)
    return state_for(model, optimizer)


def batch_spec() -> Tuple[Any, ...]:
    """The token batch's spec: rows over (data, fsdp), tokens whole."""
    return ((AXIS_DATA, AXIS_FSDP), None)


def param_shardings(mesh, config: ModelConfig, rules=None) -> Any:
    """The spec of every leaf of the JAX parameter tree on ``mesh``
    (what the reference's ``NamedSharding`` s carry)."""
    return spec_tree_from_logical(llama.logical_axes(config),
                                  rules or DEFAULT_RULES, mesh=mesh)


def state_for(model: llama.Llama, optimizer: Optimizer) -> TrainState:
    """A step-0 train state around an existing trainable model."""
    if not model.trainable:
        raise ValueError("training needs a model built with trainable=True")
    return TrainState(step=0, model=model,
                      opt_state=optimizer.init(list(model.parameters())))


def loss_fn(model: llama.Llama, tokens: torch.Tensor, config: ModelConfig,
            attention_fn: Optional[llama.AttentionFn] = None,
            num_stages: int = 1, microbatches: int = 1
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token CE of ``tokens`` [B, S+1] plus the MoE aux term:
    (total, {"loss", "aux_loss"}). ``num_stages`` > 1 runs the GPipe
    schedule (the logits then pass through the plain CE, as in the
    reference).

    A model built over a mesh takes this rank's rows as ``tokens`` and
    keeps its ``seq`` part of them; ``total`` is then its local mean times
    ``1 / (data * fsdp * seq)``, so the ranks' shares sum to the global
    mean, and the metrics are the global batch's on every rank."""
    mesh = model.mesh
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    positions = None
    if mesh is not None:
        inputs, targets, positions = _seq_part(inputs, targets, mesh)
    if num_stages > 1:
        logits, aux = pipeline_forward(
            model, inputs, config, num_stages, microbatches,
            attention_fn=attention_fn, positions=positions, mesh=mesh)
        # Off the last stage of a mesh there are no logits.
        ce = (cross_entropy_with_integer_labels(logits, targets)
              if logits is not None
              else torch.zeros((), device=tokens.device))
    elif config.fused_ce:
        hidden, aux = llama.forward_hidden(model, inputs, config,
                                           attention_fn, positions)
        hidden = llama.final_norm_hidden(hidden, model)
        b, s, d = hidden.shape
        ce = fused_cross_entropy(
            hidden.reshape(b * s, d), llama.head_weights(model, config),
            targets.reshape(-1), config.ce_chunk)
    else:
        logits, aux = llama.forward(model, inputs, config, attention_fn,
                                    positions)
        ce = cross_entropy_with_integer_labels(logits, targets)
    ce = ce.mean()
    total = ce + config.aux_loss_weight * aux
    metrics = {"loss": ce.detach(), "aux_loss": aux.detach()}
    if mesh is None:
        return total, metrics
    if num_stages > 1:
        metrics = {
            "loss": broadcast_from(metrics["loss"], mesh, (AXIS_STAGE,),
                                   num_stages - 1),
            "aux_loss": all_reduce_sum(metrics["aux_loss"].clone(), mesh,
                                       (AXIS_STAGE,))}
    n = mesh.axes_size(mesh.live_axes(PARTITION_AXES))
    if n > 1:
        total = total / n
    return total, {k: mean_over(v, mesh, PARTITION_AXES)
                   for k, v in metrics.items()}


def _seq_part(inputs: torch.Tensor, targets: torch.Tensor, mesh
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's ``seq`` part of its rows, and its tokens' positions."""
    b, s = inputs.shape
    n_seq = mesh.shape[AXIS_SEQ]
    if s % n_seq:
        raise ValueError(f"sequence length {s} must divide the seq axis "
                         f"({n_seq})")
    r, sl = mesh.coordinate()[AXIS_SEQ], s // n_seq
    if n_seq > 1:
        inputs = inputs[:, r * sl:(r + 1) * sl]
        targets = targets[:, r * sl:(r + 1) * sl]
    positions = torch.arange(r * sl, (r + 1) * sl,
                             device=inputs.device).expand(b, sl)
    return inputs, targets, positions


def _tokens(batch: Dict[str, np.ndarray], device: torch.device
            ) -> torch.Tensor:
    """The batch's tokens on ``device``. On a card the host array is
    pinned and copied asynchronously, so staging a batch does not wait for
    the steps already queued."""
    t = torch.as_tensor(batch["tokens"])
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _check_model(model: llama.Llama, config: ModelConfig) -> None:
    if (model.config.dtype, model.config.param_dtype) != (
            config.dtype, config.param_dtype):
        raise ValueError(
            f"the model was built for dtype {model.config.dtype!r} / params "
            f"{model.config.param_dtype!r}, the step for {config.dtype!r} / "
            f"{config.param_dtype!r}: build the state with the same "
            f"(policy-applied) config")


def _dense_attention(mesh):
    """The dense einsum on this rank's shards; with the sequence split,
    keys and values (and their positions) are gathered along ``seq`` first
    (GSPMD's all-gathers of the reference's dense arm)."""

    def attn(q, k, v, positions):
        if mesh.shape[AXIS_SEQ] == 1:
            return causal_attention(q, k, v, positions, positions)
        k_all = all_gather(k, mesh, (AXIS_SEQ,), 1)
        v_all = all_gather(v, mesh, (AXIS_SEQ,), 1)
        pos_all = all_gather(positions, mesh, (AXIS_SEQ,), 1)
        return causal_attention(q, k_all, v_all, positions, pos_all)

    return attn


def _local_heads(base, mesh, config: ModelConfig):
    """``base`` on this rank's heads: q and k/v heads both split run as
    they are; k/v heads fewer than the tensor axis (computed whole) give
    each rank the one head its query heads read (the reference's GQA
    repeat, ``trainer.py:127-131``). Past that -- the tensor axis divides
    neither head count, or q's but not k/v's and k/v cannot be repeated to
    cover it -- ``base`` runs on whole heads (q gathered), the same
    attention on every rank of the axis, and ``wo``'s block takes this
    rank's heads (``parallel.placement``). That costs ``tensor`` times the
    attention work, so it is loud (``attn.forfeits``, a warning), as the
    reference's dense fallback is; the kernels still run."""
    t = mesh.shape[AXIS_TENSOR]

    def attn(q, k, v, positions):
        hq, hkv = config.num_heads, config.num_kv_heads
        q_split, kv_split = q.shape[2] != hq, k.shape[2] != hkv
        if q_split and kv_split:
            return base(q, k, v, positions)
        if q_split and t % hkv == 0:
            idx = mesh.coordinate()[AXIS_TENSOR] // (t // hkv)
            k = select(k, mesh, (AXIS_TENSOR,), 2, idx, 1)
            v = select(v, mesh, (AXIS_TENSOR,), 2, idx, 1)
            return base(q, k, v, positions)
        reason = (f"attention runs on whole heads on every rank of the "
                  f"tensor axis: head counts (hq={hq}, hkv={hkv}) are not "
                  f"divisible by it ({t}) and kv heads cannot be repeated "
                  f"to cover it; expect {t}x attention cost")
        if not attn.forfeits:
            warnings.warn(reason, stacklevel=2)
        attn.forfeits.append(reason)
        if q_split:
            q = gather_replicated(q, mesh, (AXIS_TENSOR,), 2)
        return base(q, k, v, positions)

    attn.forfeits = []
    attn.kernels = getattr(base, "kernels", ())
    return attn


def _resolve_attention(attention_fn, mesh, config: ModelConfig):
    """The attention of a step over ``mesh``: ``attention_fn`` if given,
    else ring attention when the seq axis is sharded (it is the blockwise
    flash recurrence, distributed); the dense einsum when
    ``config.attention`` is "dense" (keys gathered along ``seq`` when it
    is sharded); otherwise the model's choice (``llama.resolve_attention``:
    the flash kernels on the card). Past one rank it runs on this rank's
    local heads (:func:`_local_heads`)."""
    if attention_fn is None and mesh.size == 1:
        return llama.resolve_attention(config, mesh.device_type)
    base = attention_fn
    if base is None and config.attention == "dense":
        base = _dense_attention(mesh)
    elif base is None and mesh.shape[AXIS_SEQ] > 1:
        from ..ops.ring_attention import make_ring_attention

        # The positions operand carries what a rank index would compute,
        # which is what lets the ring nest under the pipeline.
        base = make_ring_attention(mesh)
    elif base is None:
        base = (llama.resolve_attention(config, mesh.device_type)
                or _dense_attention(mesh))
    if mesh.shape[AXIS_TENSOR] == 1:
        return base
    return _local_heads(base, mesh, config)


def make_train_step(config: ModelConfig, optimizer: Optimizer, mesh=None,
                    attention_fn=None, microbatches: int = 0):
    """Returns ``step(state, batch) -> (state, metrics)``: the loss and
    its gradients, then one optimizer update, all in place. ``metrics``
    (loss, aux_loss, grad_norm) stay device scalars. The state must have
    been built against the same (policy-applied) config.

    ``mesh`` (a state built over it) makes it the sharded step: ``batch``
    holds this rank's rows, a mesh with ``stage`` > 1 runs GPipe with
    ``microbatches`` (default the stage count), the gradients are summed
    over the axes each leaf is replicated along and the update takes the
    whole gradient's norm (the model's placement,
    ``parallel/placement.py``), and the metrics are the global batch's on
    every rank; the model's blocks follow ``DEFAULT_RULES``."""
    num_stages = pipeline_degree(mesh) if mesh is not None else 1
    microbatches = microbatches or num_stages
    if mesh is not None:
        attention_fn = _resolve_attention(attention_fn, mesh, config)

    def step(state: TrainState, batch: Dict[str, np.ndarray]):
        model = state.model
        _check_model(model, config)
        if model.mesh is not mesh:
            raise ValueError("the state was not built over the step's mesh "
                             "(init_state(..., mesh=mesh))")
        params = list(model.parameters())
        for p in params:
            p.grad = None
        attn = attention_fn or llama.resolve_attention(config, model.device)
        total, metrics = loss_fn(model, _tokens(batch, model.device),
                                 config, attn, num_stages, microbatches)
        total.backward()
        place = model.placement
        grads = place.sync_grads(params)
        metrics["grad_norm"] = optimizer.update(
            params, grads, state.opt_state,
            norm=place.global_norm(params, grads))
        state.step += 1
        return state, metrics

    step.attention_fn = attention_fn
    return step


def make_eval_step(config: ModelConfig, mesh=None, attention_fn=None,
                   microbatches: int = 0):
    """Returns ``eval(model, batch) -> metrics`` without gradients."""
    num_stages = pipeline_degree(mesh) if mesh is not None else 1
    microbatches = microbatches or num_stages
    if mesh is not None:
        attention_fn = _resolve_attention(attention_fn, mesh, config)

    @torch.no_grad()
    def step(model: llama.Llama, batch: Dict[str, np.ndarray]):
        _check_model(model, config)
        attn = attention_fn or llama.resolve_attention(config, model.device)
        _, metrics = loss_fn(model, _tokens(batch, model.device), config,
                             attn, num_stages, microbatches)
        return metrics

    return step


@dataclass(frozen=True)
class CompileTimings:
    """Where the wall clock before the first step went, with the
    reference's fields. The port traces nothing ahead of time, so
    ``lower_seconds`` is 0; ``compile_seconds`` is the build (``nvcc``)
    and load of the kernels the step launches, which collapses to the load
    when ``cache_dir`` already holds them; ``cache_dir`` is the kernels'
    build directory, None where the step launches no kernel (the CPU)."""

    lower_seconds: float
    compile_seconds: float
    cache_dir: Optional[str]

    @property
    def total_seconds(self) -> float:
        return self.lower_seconds + self.compile_seconds


def enable_compile_cache(cache_dir: str) -> Optional[str]:
    """Build the CUDA kernels into ``cache_dir`` (created if missing)
    instead of ``triton_kubernetes_tpu_torch/_build/``: a library's name
    carries the hash of the sources and ``nvcc`` flags, so a directory that
    already holds it is a warm start (load only). Returns the directory,
    or None when it cannot be created (a cold start, not a crash)."""
    from ..ops import _kernels

    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return None
    _kernels.BUILD_DIR = Path(cache_dir).resolve()
    return cache_dir


def step_kernels(step_fn: Callable, model) -> Tuple[str, ...]:
    """The kernels ``step_fn`` launches on ``model``'s device: those of
    the attention it resolved (``step_fn.attention_fn``, else the model's
    choice, ``llama.resolve_attention``), which names them in its
    ``kernels`` -- the flash kernels' forward and backward; the ring, the
    dense einsum and the CPU launch none."""
    if torch.device(model.device).type != "cuda":
        return ()
    attn = (getattr(step_fn, "attention_fn", None)
            or llama.resolve_attention(model.config, model.device))
    return tuple(getattr(attn, "kernels", ()))


def publish_memory_stats(mem: MemoryStats, config_name: str = "") -> None:
    """``tk8s_train_memory_bytes`` of one step's :class:`MemoryStats`,
    under the reference's labels (``kind`` argument, output, temp, alias
    and peak)."""
    from ..utils import metrics as _metrics

    gauge = _metrics.gauge("tk8s_train_memory_bytes")
    for kind in ("argument", "output", "temp", "alias"):
        gauge.set(getattr(mem, f"{kind}_bytes"), config=config_name,
                  kind=kind)
    gauge.set(mem.peak_bytes, config=config_name, kind="peak")


def aot_compile_step(step_fn: Callable, state: TrainState, batch: Any,
                     config_name: str = "",
                     clock: Callable[[], float] = time.perf_counter
                     ) -> Tuple[Callable, CompileTimings]:
    """The reference's ahead-of-time compile of a train step: here the
    build and load of every kernel the step launches (:func:`step_kernels`:
    ``nvcc`` for each missing library, all started together) before its
    first call, timed and published through the
    ``tk8s_train_compile_seconds`` gauge (``phase`` "lower", always 0, and
    "compile"). Returns the step itself -- eager PyTorch has no separate
    executable -- and the timings; ``batch`` is not read (nothing is
    traced). ``tk8s_train_memory_bytes`` needs a step that ran
    (:func:`memory_stats`, then :func:`publish_memory_stats`)."""
    from ..ops import _kernels
    from ..utils import metrics as _metrics

    del batch
    names = step_kernels(step_fn, state.model)
    t0 = clock()
    if names:
        _kernels.build(names)
        for name in names:
            _kernels.library(name)
    t1 = clock()
    timings = CompileTimings(
        lower_seconds=0.0, compile_seconds=t1 - t0,
        cache_dir=str(_kernels.BUILD_DIR) if names else None)
    gauge = _metrics.gauge("tk8s_train_compile_seconds")
    gauge.set(timings.lower_seconds, config=config_name, phase="lower")
    gauge.set(timings.compile_seconds, config=config_name, phase="compile")
    return step_fn, timings


@dataclass(frozen=True)
class MemoryStats:
    """Device byte accounting of one train step, with the fields of the
    reference's (``argument_bytes``, ``output_bytes``, ``temp_bytes``,
    ``alias_bytes``). ``temp_bytes`` is the number a rematerialization
    policy moves (live activations, gradients, optimizer temporaries);
    ``argument_bytes`` what a precision policy's storage dtypes move;
    ``peak_bytes`` the fit-in-memory total."""

    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int

    @property
    def peak_bytes(self) -> int:
        return (self.argument_bytes + self.temp_bytes
                + max(self.output_bytes - self.alias_bytes, 0))


def _state_bytes(state: TrainState) -> int:
    tensors = (list(state.model.parameters()) + state.opt_state.mu
               + state.opt_state.nu)
    return sum(t.numel() * t.element_size() for t in tensors)


def memory_stats(step: Callable, state: TrainState, batch: Any
                 ) -> Tuple[Optional[MemoryStats], TrainState,
                            Dict[str, torch.Tensor]]:
    """Run one step of ``step`` (it advances ``state``: the caller counts
    it as a training step) and return ``(stats, state, metrics)``.

    Where the reference reads XLA's ``compiled.memory_analysis()`` -- an
    ahead-of-time plan of one compiled program, before it runs -- the port
    has no compiled program to ask, so it *measures* this step on the card
    under ``torch.cuda.reset_peak_memory_stats``: ``argument_bytes`` are
    the state's bytes (f32 masters and both moments) plus the batch's;
    the step updates them in place, so ``output_bytes`` = ``alias_bytes``
    = ``argument_bytes``; ``temp_bytes`` is the caching allocator's peak
    during the step less what was allocated when it began. That counts
    allocator blocks, not XLA's buffer assignment, so it includes
    fragmentation and excludes cuBLAS's own workspace and the CUDA
    context. Off the card ``stats`` is None, as the reference returns None
    where no analysis exists."""
    device = state.model.device
    if device.type != "cuda":
        state, metrics = step(state, batch)
        return None, state, metrics
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    state, metrics = step(state, batch)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    tokens = torch.as_tensor(batch["tokens"])
    args = _state_bytes(state) + tokens.numel() * tokens.element_size()
    return MemoryStats(argument_bytes=args, output_bytes=args,
                       temp_bytes=max(peak - base, 0),
                       alias_bytes=args), state, metrics
