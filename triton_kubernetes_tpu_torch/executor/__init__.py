"""Execution: the plan/apply engine of the state document (the port's copy
of the reference's ``executor`` package). ``LocalExecutor`` resolves the
module graph, evaluates ``${module.x.y}`` interpolations, orders modules
by dependency and drives the simulated cloud (``cloudsim``) in-process.
The reference's Terraform executor and its kind/k3d driver are not
ported."""

from .cloudsim import (
    FatalFaultError,
    FaultPlan,
    FaultPlanError,
    SimulatedKillError,
    TransientFaultError,
)
from .dagspec import DagSpecError, document_from_spec, gpu_pools
from .drivers import driver_config, make_driver
from .engine import (
    ApplyError,
    ExecutorState,
    FatalApplyError,
    LocalExecutor,
    OutputError,
    RetryPolicy,
    TransientApplyError,
    load_executor_state,
    modules_fingerprint,
    save_executor_state,
    state_fingerprint,
)
from .interpolate import (
    InterpolationError,
    extract_dependencies,
    module_dependencies,
    resolve,
)
from .plan import Plan, PlanAction, diff_states

__all__ = [
    "ApplyError",
    "DagSpecError",
    "ExecutorState",
    "FatalApplyError",
    "FatalFaultError",
    "FaultPlan",
    "FaultPlanError",
    "InterpolationError",
    "LocalExecutor",
    "OutputError",
    "Plan",
    "PlanAction",
    "RetryPolicy",
    "SimulatedKillError",
    "TransientApplyError",
    "TransientFaultError",
    "diff_states",
    "document_from_spec",
    "driver_config",
    "extract_dependencies",
    "gpu_pools",
    "load_executor_state",
    "make_driver",
    "module_dependencies",
    "modules_fingerprint",
    "resolve",
    "save_executor_state",
    "state_fingerprint",
]
