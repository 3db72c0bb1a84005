"""How the long-running entry points (serve, route) stop: the port's copy
of the reference CLI's ``_sigterm_runs_finally``."""

from __future__ import annotations

import signal
from typing import Any


def sigterm_runs_finally() -> None:
    """Install before blocking: SIGTERM -- how Kubernetes stops a pod --
    becomes ``SystemExit(143)`` so the entry point's ``finally`` runs and
    buffered trace JSONL reaches disk. Without it the default handler
    kills the process mid-buffer and a terminated pod's trace file holds
    only its meta anchor."""

    def _exit(signum: int, frame: Any) -> None:
        raise SystemExit(143)

    try:
        signal.signal(signal.SIGTERM, _exit)
    except ValueError:
        # Not the main thread (embedded callers drive main() from worker
        # threads in tests): the caller owns signal handling.
        pass
