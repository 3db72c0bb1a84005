"""Serving: the continuous-batching engine over the paged KV pool, its
page allocator, the speculative self-drafter and the KV-session migration
wire format (the port of ``triton_kubernetes_tpu/serve``)."""

from .blocks import BlockAllocator, OutOfBlocksError, PrefixCache
from .engine import FinishedRequest, ManualClock, Request, ServeEngine
from .migration import (
    MigrationError,
    SessionPayload,
    TornPayloadError,
    corrupt,
    pack_session,
    unpack_session,
)
from .speculation import draft_ngram, longest_agreeing_prefix

__all__ = [
    "BlockAllocator",
    "OutOfBlocksError",
    "PrefixCache",
    "FinishedRequest",
    "ManualClock",
    "MigrationError",
    "Request",
    "ServeEngine",
    "SessionPayload",
    "TornPayloadError",
    "corrupt",
    "draft_ngram",
    "longest_agreeing_prefix",
    "pack_session",
    "unpack_session",
]
