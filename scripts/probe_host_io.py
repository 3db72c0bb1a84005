#!/usr/bin/env python3
"""Measure the host-side rates a checkpoint of the train state rides on.

What ``train/checkpoint.py`` does to a checkpoint's bytes, each timed
alone on a card's machine: page-locking a host arena with
``cudaHostRegister`` (the save's pinned staging), device-to-host and
host-to-device copies of 2 GB through it, sha256 of 4 GB on one thread and
on four, writing 4 GB with an fsync a file on one thread and on four, and
reading it back (from the page cache). Prints one line a measurement.
Run from the repository root on a machine with a card:

    python3 scripts/probe_host_io.py [--arena-gb 23] [--dir _probe_io]

It writes 8 GB under ``--dir`` (deleted at the end) and pins
``--arena-gb`` GB of host memory.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import os
import shutil
import time

import torch

GB = 1_000_000_000


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--arena-gb", type=float, default=23.0)
    parser.add_argument("--dir", default="_probe_io")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_host_io: needs a card")
        return 2
    n = int(args.arena_gb * GB)
    arena = torch.empty(n, dtype=torch.uint8)
    s_zero, _ = timed(arena.zero_)
    s_reg, rc = timed(lambda: torch.cuda.cudart().cudaHostRegister(
        arena.data_ptr(), n, 0))
    torch.cuda.check_error(rc)
    print(f"pin {n / GB:.1f} GB: zero_ {s_zero:.3f} s, cudaHostRegister "
          f"{s_reg:.3f} s ({(s_zero + s_reg) / (n / GB):.3f} s/GB), "
          f"is_pinned {arena.is_pinned()}")
    m = 2 * GB
    dev = torch.ones(m, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()

    def d2h():
        arena[:m].copy_(dev, non_blocking=True)
        torch.cuda.synchronize()

    def h2d():
        dev.copy_(arena[:m], non_blocking=True)
        torch.cuda.synchronize()
    for name, fn in (("device-to-host", d2h), ("host-to-device", h2d)):
        s, _ = timed(fn)
        print(f"{name} 2 GB: {s:.4f} s ({m / GB / s:.1f} GB/s)")
    torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(
        arena.data_ptr()))
    del arena, dev

    bufs = [torch.full((GB,), i, dtype=torch.uint8) for i in range(4)]
    views = [memoryview(b.numpy()) for b in bufs]
    digest = lambda v: hashlib.sha256(v).hexdigest()  # noqa: E731
    s, _ = timed(lambda: [digest(v) for v in views])
    print(f"sha256 4 GB, 1 thread: {s:.3f} s ({4 / s:.2f} GB/s)")
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        s, _ = timed(lambda: list(pool.map(digest, views)))
    print(f"sha256 4 GB, 4 threads: {s:.3f} s ({4 / s:.2f} GB/s)")

    os.makedirs(args.dir, exist_ok=True)
    try:
        def write(i):
            with open(os.path.join(args.dir, f"f{i}"), "wb") as f:
                f.write(views[i])
                f.flush()
                os.fsync(f.fileno())
        s, _ = timed(lambda: [write(i) for i in range(4)])
        print(f"write + fsync 4 GB, 1 thread: {s:.3f} s ({4 / s:.2f} GB/s)")
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            s, _ = timed(lambda: list(pool.map(write, range(4))))
        print(f"write + fsync 4 GB, 4 threads: {s:.3f} s "
              f"({4 / s:.2f} GB/s)")

        def read():
            for i in range(4):
                with open(os.path.join(args.dir, f"f{i}"), "rb") as f:
                    f.readinto(views[i])
        s, _ = timed(read)
        print(f"read 4 GB (page cache): {s:.3f} s ({4 / s:.2f} GB/s)")
    finally:
        shutil.rmtree(args.dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
