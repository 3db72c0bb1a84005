"""Serving: the continuous-batching engine over the paged KV pool, its
page allocator and the speculative self-drafter (the port of
``triton_kubernetes_tpu/serve``)."""

from .blocks import BlockAllocator, OutOfBlocksError, PrefixCache
from .engine import FinishedRequest, ManualClock, Request, ServeEngine
from .speculation import draft_ngram, longest_agreeing_prefix

__all__ = [
    "BlockAllocator",
    "OutOfBlocksError",
    "PrefixCache",
    "FinishedRequest",
    "ManualClock",
    "Request",
    "ServeEngine",
    "draft_ngram",
    "longest_agreeing_prefix",
]
