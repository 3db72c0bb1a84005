"""Serving: the continuous-batching engine over the paged KV pool and its
page allocator (the port of ``triton_kubernetes_tpu/serve``)."""

from .blocks import BlockAllocator, OutOfBlocksError, PrefixCache
from .engine import FinishedRequest, ManualClock, Request, ServeEngine

__all__ = [
    "BlockAllocator",
    "OutOfBlocksError",
    "PrefixCache",
    "FinishedRequest",
    "ManualClock",
    "Request",
    "ServeEngine",
]
