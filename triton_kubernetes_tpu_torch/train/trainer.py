"""The single-device train step -- the port of
``triton_kubernetes_tpu/train/trainer.py`` (``make_optimizer``,
``init_state``, ``loss_fn``, ``make_train_step``, ``make_eval_step``) on one
device: no mesh, no sharding, no pipeline stages.

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
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import llama
from ..models.config import ModelConfig
from ..ops.fused_ce import cross_entropy_with_integer_labels, \
    fused_cross_entropy


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
               state: AdamWState) -> torch.Tensor:
        """One update of ``params`` in place; returns the gradients'
        global norm before clipping (a device scalar)."""
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
               device: torch.device | str = "cuda") -> TrainState:
    """A trainable model from the reference's init rule (``torch``
    generator, seeded) and a fresh optimizer state, on ``device``."""
    model = llama.init_params(config, seed=seed, device=device,
                              trainable=True)
    return state_for(model, optimizer)


def state_for(model: llama.Llama, optimizer: Optimizer) -> TrainState:
    """A step-0 train state around an existing trainable model."""
    if not model.trainable:
        raise ValueError("training needs a model built with trainable=True")
    return TrainState(step=0, model=model,
                      opt_state=optimizer.init(list(model.parameters())))


def loss_fn(model: llama.Llama, tokens: torch.Tensor, config: ModelConfig,
            attention_fn: Optional[llama.AttentionFn] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token CE of ``tokens`` [B, S+1] (plus the MoE aux term,
    0 here): (total, {"loss", "aux_loss"})."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if config.fused_ce:
        hidden, aux = llama.forward_hidden(model, inputs, config,
                                           attention_fn=attention_fn)
        hidden = llama.final_norm_hidden(hidden, model)
        b, s, d = hidden.shape
        ce = fused_cross_entropy(
            hidden.reshape(b * s, d), llama.head_weights(model),
            targets.reshape(-1), config.ce_chunk)
    else:
        logits, aux = llama.forward(model, inputs, config,
                                    attention_fn=attention_fn)
        ce = cross_entropy_with_integer_labels(logits, targets)
    ce = ce.mean()
    total = ce + config.aux_loss_weight * aux
    return total, {"loss": ce.detach(), "aux_loss": aux.detach()}


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


def make_train_step(config: ModelConfig, optimizer: Optimizer):
    """Returns ``step(state, batch) -> (state, metrics)``: the loss and
    its gradients, then one optimizer update, all in place. ``metrics``
    (loss, aux_loss, grad_norm) stay device scalars. The state must have
    been built against the same (policy-applied) config."""

    def step(state: TrainState, batch: Dict[str, np.ndarray]):
        model = state.model
        _check_model(model, config)
        params = list(model.parameters())
        for p in params:
            p.grad = None
        attn = llama.resolve_attention(config, model.device)
        total, metrics = loss_fn(model, _tokens(batch, model.device), config,
                                 attn)
        total.backward()
        grads = [p.grad for p in params]
        metrics["grad_norm"] = optimizer.update(params, grads,
                                                state.opt_state)
        state.step += 1
        return state, metrics

    return step


def make_eval_step(config: ModelConfig):
    """Returns ``eval(model, batch) -> metrics`` without gradients."""

    @torch.no_grad()
    def step(model: llama.Llama, batch: Dict[str, np.ndarray]):
        _check_model(model, config)
        attn = llama.resolve_attention(config, model.device)
        _, metrics = loss_fn(model, _tokens(batch, model.device), config,
                             attn)
        return metrics

    return step


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
