"""Training -- the port of ``triton_kubernetes_tpu/train``: precision
policies, the train step with the reference's optimizer on one device or
over a mesh (``trainer.py``), GPipe and the step-pipelined
loop (``pipeline.py``) and the resilient loop over it (preemption,
loss-anomaly rollback), verified checkpoints, MFU accounting, the
synthetic, packed and sharded data pipelines with device prefetch, and the
``python -m triton_kubernetes_tpu_torch.train`` entry point (one process,
or a ``torch.distributed`` world). Exports what the reference's
``train/__init__.py`` exports, plus the port's own. ``CompileTimings``,
``aot_compile_step`` and ``enable_compile_cache`` speak of the kernels'
builds: the port traces nothing ahead of time.
"""

from .checkpoint import (
    CheckpointIntegrityError,
    CheckpointManager,
    MeshMismatchError,
    ReshapeError,
    mesh_spec_of,
    peek_newest_manifest,
    restore_newest_verified,
)
from .data import DevicePrefetch, PrefetchProducerError, synthetic_batches
from .measure import ThroughputReport, measure_throughput, \
    measure_tokens_per_sec
from .mfu import flops_per_token, mfu, tokens_per_sec_for_mfu
from .pipeline import (LoopReport, pipeline_degree, pipeline_forward,
                       run_pipelined)
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
from .resilience import (
    EXIT_RESUME,
    AnomalyAbortedError,
    LossAnomalyGuard,
    PreemptionGuard,
    ResilienceReport,
    negotiate_mesh_config,
    run_resilient,
)
from .trainer import (
    AdamWState,
    CompileTimings,
    MemoryStats,
    Optimizer,
    TrainState,
    aot_compile_step,
    batch_spec,
    enable_compile_cache,
    init_state,
    loss_fn,
    make_eval_step,
    make_optimizer,
    make_train_step,
    memory_stats,
    param_shardings,
    state_for,
)

__all__ = [
    "flops_per_token",
    "mfu",
    "tokens_per_sec_for_mfu",
    "TrainState",
    "make_optimizer",
    "make_train_step",
    "init_state",
    "CheckpointManager",
    "CheckpointIntegrityError",
    "MeshMismatchError",
    "ReshapeError",
    "mesh_spec_of",
    "peek_newest_manifest",
    "negotiate_mesh_config",
    "restore_newest_verified",
    "DevicePrefetch",
    "PrefetchProducerError",
    "LoopReport",
    "run_pipelined",
    "EXIT_RESUME",
    "AnomalyAbortedError",
    "LossAnomalyGuard",
    "PreemptionGuard",
    "ResilienceReport",
    "run_resilient",
    "MemoryStats",
    "memory_stats",
    "CompileTimings",
    "aot_compile_step",
    "enable_compile_cache",
    "POLICIES",
    "PrecisionPolicy",
    "apply_policy",
    "get_policy",
    "grads_all_finite",
    "policy_of",
    "remat_policy_of",
    "synthetic_batches",
    "ThroughputReport",
    "measure_throughput",
    "measure_tokens_per_sec",
    "AdamWState",
    "Optimizer",
    "loss_fn",
    "make_eval_step",
    "state_for",
    "batch_spec",
    "param_shardings",
    "pipeline_forward",
    "pipeline_degree",
]
