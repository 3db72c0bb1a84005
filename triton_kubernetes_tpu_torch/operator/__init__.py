"""The operator: a continuous reconcile loop + metrics-driven GPU-pool
autoscaler (the port's copy of the reference's ``operator`` package,
whose guide is docs/guide/operator.md).

Standard library only — the operator drives the executor on the
simulated cloud and scrapes the ``tools.serve`` replicas over HTTP; it
never imports the workload stack, and holds no weights. Its scaling,
preemption and repair unit is one GPU pool (a ``gcp-gpu-nodepool``
module, ``node_gcp-gpu_<cluster>_<pool>``), where the reference's is a
TPU slice. Time and
randomness come only through injectable seams (lint rule TK8S110), so
tests and the chaos harness drive simulated days of reconciling in
milliseconds of wall time.
"""

from .autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    ScaleDecision,
    apply_decision,
)
from .loop import OperatorError, Reconciler, ReconcileTick
from .observe import (
    MetricsWatcher,
    ObservedState,
    ServingSample,
    observe,
    gpu_pool_modules,
)
from .rebalance import RebalanceDecision, http_rebalancer, plan_rebalance
from .reconcile import RULES, ReconcileDelta, act, compute_delta
from .server import OperatorHTTPServer
from .trainfleet import (
    TrainDecision,
    TrainFleetConfig,
    TrainFleetPolicy,
    TrainFleetStatus,
    file_train_status,
    jobset_actuator,
)

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "MetricsWatcher",
    "ObservedState",
    "OperatorError",
    "OperatorHTTPServer",
    "RebalanceDecision",
    "Reconciler",
    "ReconcileDelta",
    "ReconcileTick",
    "RULES",
    "ScaleDecision",
    "ServingSample",
    "TrainDecision",
    "TrainFleetConfig",
    "TrainFleetPolicy",
    "TrainFleetStatus",
    "file_train_status",
    "jobset_actuator",
    "act",
    "apply_decision",
    "compute_delta",
    "gpu_pool_modules",
    "http_rebalancer",
    "observe",
    "plan_rebalance",
]
