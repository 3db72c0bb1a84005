"""Workflows of GPU pools: the H100 twins of the reference's TPU-bound
workflow provider (``providers.gcp_gpu``) and its programmatic pool
repair (``repair.repair_slice_auto``), which the operator calls."""

from .repair import NoPreemptedSlicesError, WorkflowError, repair_slice_auto

__all__ = ["NoPreemptedSlicesError", "WorkflowError", "repair_slice_auto"]
