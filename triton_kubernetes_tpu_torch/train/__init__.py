"""Training on one device -- the port of ``triton_kubernetes_tpu/train``:
precision policies, the train step with the reference's optimizer, the
step-pipelined loop, MFU accounting, synthetic data and the
``python -m triton_kubernetes_tpu_torch.train`` entry point.

Checkpointing, resilience, the packed/sharded data pipelines, GPipe and
multi-process training are later slices (ROADMAP.md).
"""

from .data import synthetic_batches
from .measure import ThroughputReport, measure_throughput, \
    measure_tokens_per_sec
from .mfu import flops_per_token, mfu
from .pipeline import LoopReport, run_pipelined
from .precision import (
    POLICIES,
    PrecisionPolicy,
    apply_policy,
    get_policy,
    grads_all_finite,
    policy_of,
    quantize_for_decode,
    remat_policy_of,
)
from .trainer import (
    AdamWState,
    Optimizer,
    TrainState,
    init_state,
    loss_fn,
    make_eval_step,
    make_optimizer,
    make_train_step,
    state_for,
)

__all__ = [
    "synthetic_batches",
    "ThroughputReport",
    "measure_throughput",
    "measure_tokens_per_sec",
    "flops_per_token",
    "mfu",
    "LoopReport",
    "run_pipelined",
    "POLICIES",
    "PrecisionPolicy",
    "apply_policy",
    "get_policy",
    "grads_all_finite",
    "policy_of",
    "remat_policy_of",
    "AdamWState",
    "Optimizer",
    "TrainState",
    "init_state",
    "loss_fn",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "state_for",
]
