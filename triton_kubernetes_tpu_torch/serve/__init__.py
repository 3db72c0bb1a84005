"""Serving: the continuous-batching engine over the paged KV pool, its
page allocator, the speculative self-drafter, the KV-session migration
wire format, the HTTP front end, the session-affine router and the seeded
open-loop load generator (the port of ``triton_kubernetes_tpu/serve``).

The torch-free slice imports eagerly: the router and loadgen run on
machines with no accelerator stack at all (a router box has no GPU), and
SERVE_PORT comes straight from the dependency-free constants module.
Everything touching the model stack (engine, server, blocks, migration)
resolves lazily via PEP 562, so ``from ..serve.router import
RouterHTTPServer`` never drags torch in.
"""

from importlib import import_module

from ..constants import SERVE_PORT
from .loadgen import (
    DiurnalSchedule,
    PoissonSchedule,
    RepetitionSchedule,
    SessionSchedule,
    SharedPrefixSchedule,
    percentile,
)
from .router import HashRing, Router, RouterHTTPServer
from .speculation import draft_ngram, longest_agreeing_prefix

_LAZY = {
    "BlockAllocator": ".blocks",
    "OutOfBlocksError": ".blocks",
    "PrefixCache": ".blocks",
    "FinishedRequest": ".engine",
    "ManualClock": ".engine",
    "Request": ".engine",
    "ServeEngine": ".engine",
    "DcnTransferModel": ".server",
    "ServeHTTPServer": ".server",
    "MigrationError": ".migration",
    "SessionPayload": ".migration",
    "TornPayloadError": ".migration",
    "corrupt": ".migration",
    "pack_session": ".migration",
    "unpack_session": ".migration",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(mod, __name__), name)


__all__ = [
    "SERVE_PORT",
    "ServeHTTPServer",
    "BlockAllocator",
    "DcnTransferModel",
    "DiurnalSchedule",
    "FinishedRequest",
    "HashRing",
    "ManualClock",
    "MigrationError",
    "OutOfBlocksError",
    "PoissonSchedule",
    "PrefixCache",
    "RepetitionSchedule",
    "Request",
    "Router",
    "RouterHTTPServer",
    "ServeEngine",
    "SessionPayload",
    "SessionSchedule",
    "SharedPrefixSchedule",
    "TornPayloadError",
    "corrupt",
    "draft_ngram",
    "longest_agreeing_prefix",
    "pack_session",
    "percentile",
    "unpack_session",
]
