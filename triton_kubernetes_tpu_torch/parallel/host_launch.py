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

A rank's stdout and stderr are pipes, each drained by a thread that
writes whole lines to the pod's matching stream under one lock a
stream: the ranks' lines never split or merge (a rank whose Python runs
unbuffered writes a line's body and its newline apart), so a trainer's
JSON report lines stay parseable. A rank killed mid-line leaves its
partial line, ended with a newline. The pipes are drained to EOF for at
most ``DRAIN_S`` seconds after the last rank ends: a process that a rank
left running may hold them open, and the pod's exit code must not wait
on it.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import BinaryIO, List, Optional, Sequence

# Seconds between a rank's failure's SIGTERM to the others and their kill:
# room for an emergency checkpoint, as the local launcher gives.
GRACE_S = 120.0
# Seconds the pipes are drained after every rank has ended. A process a
# rank left behind may hold a pipe open, and then no EOF comes.
DRAIN_S = 5.0


def rank_env(local_rank: int, environ=None):
    """The environment of the host's rank ``local_rank``."""
    env = dict(os.environ if environ is None else environ)
    env["LOCAL_RANK"] = str(local_rank)
    return env


def _code(rc: int) -> int:
    return 128 - rc if rc < 0 else rc


def _pump(src: BinaryIO, dst: BinaryIO, lock: threading.Lock) -> None:
    """Copy ``src`` to ``dst`` a whole line at a time, under ``lock``,
    until EOF; a last line without its newline gets one."""
    with src:
        for line in iter(src.readline, b""):
            if not line.endswith(b"\n"):
                line += b"\n"
            with lock:
                dst.write(line)
                dst.flush()


def run_ranks(command: Sequence[str], per_host: int,
              poll: float = 0.05) -> int:
    """Run ``command`` ``per_host`` times, one process a ``LOCAL_RANK``,
    and wait for all of them; returns the pod's exit code."""
    procs = [subprocess.Popen(list(command), env=rank_env(i),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for i in range(per_host)]
    streams = [(getattr(s, "buffer", s), threading.Lock())
               for s in (sys.stdout, sys.stderr)]
    pumps = [threading.Thread(target=_pump, daemon=True,
                              args=(pipe, dst, lock))
             for p in procs
             for pipe, (dst, lock) in zip((p.stdout, p.stderr), streams)]
    for t in pumps:
        t.start()

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
        drain_until = time.monotonic() + DRAIN_S
        for t in pumps:
            t.join(max(0.0, drain_until - time.monotonic()))
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
