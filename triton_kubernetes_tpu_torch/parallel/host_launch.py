"""One pod's ranks: run a command once for each GPU of the host.

A GPU pool's JobSet (``topology/jobset.py``) runs one pod a host, granted
every GPU of the host, so the ranks of a host share its NVLink. The pod's
command is this entry point in front of the trainer's:

    python -m triton_kubernetes_tpu_torch.parallel.host_launch -- \\
        python -m triton_kubernetes_tpu_torch.train --distributed on ...

It starts ``GPUS_PER_HOST`` copies of the command, each under the pod's
environment plus ``LOCAL_RANK`` (0 .. GPUS_PER_HOST - 1), from which
``train/__main__.parse_distributed_env`` reads rank ``TPU_WORKER_ID *
GPUS_PER_HOST + LOCAL_RANK`` of ``NUM_TPU_WORKERS * GPUS_PER_HOST`` and
the card ``cuda:LOCAL_RANK``. SIGTERM and SIGINT are passed on to every
rank (a preemption warning reaches each trainer). When a rank exits
non-zero while others run, they are sent SIGTERM (they would wait in a
collective the dead rank never joins), and killed ``GRACE_S`` seconds
later. The exit code is the first non-zero one a rank gave, as
``128 + signal`` for a rank a signal ended, else 0: a trainer's
``EXIT_RESUME`` reaches the Job's pod failure policy as it would from a
pod of one rank.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import List, Optional, Sequence

# Seconds between a rank's failure's SIGTERM to the others and their kill:
# room for an emergency checkpoint, as the local launcher gives.
GRACE_S = 120.0


def rank_env(local_rank: int, environ=None):
    """The environment of the host's rank ``local_rank``."""
    env = dict(os.environ if environ is None else environ)
    env["LOCAL_RANK"] = str(local_rank)
    return env


def _code(rc: int) -> int:
    return 128 - rc if rc < 0 else rc


def run_ranks(command: Sequence[str], per_host: int,
              poll: float = 0.05) -> int:
    """Run ``command`` ``per_host`` times, one process a ``LOCAL_RANK``,
    and wait for all of them; returns the pod's exit code."""
    procs = [subprocess.Popen(list(command), env=rank_env(i))
             for i in range(per_host)]

    def forward(signum, _frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    old = {s: signal.signal(s, forward)
           for s in (signal.SIGTERM, signal.SIGINT)}
    first: Optional[int] = None
    kill_at: Optional[float] = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes:
                break
            if first is None:
                failed = [rc for rc in codes if rc not in (None, 0)]
                if failed:
                    first = _code(failed[0])
                    forward(signal.SIGTERM, None)
                    kill_at = time.monotonic() + GRACE_S
            if kill_at is not None and time.monotonic() >= kill_at:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                kill_at = None
            time.sleep(poll)
    finally:
        for s, h in old.items():
            signal.signal(s, h)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if first is None:
        failed = [p.returncode for p in procs if p.returncode != 0]
        first = _code(failed[0]) if failed else 0
    return first


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    command = args[1:] if args[:1] == ["--"] else args
    raw = (os.environ.get("GPUS_PER_HOST") or "").strip() or "1"
    if not command or not raw.isdigit() or int(raw) < 1:
        print(f"usage: python -m triton_kubernetes_tpu_torch.parallel."
              f"host_launch -- COMMAND... (GPUS_PER_HOST={raw!r} must be "
              f"a count >= 1)", file=sys.stderr)
        return 2
    return run_ranks(command, int(raw))


if __name__ == "__main__":
    sys.exit(main())
