#!/usr/bin/env python3
"""Repeat the reshard-torn-checkpoint chaos arm on the card, alone and
beside processes that fork.

The arm (``chaos/workload.py``) saves a two-leaf state on the card through
``train.checkpoint.CheckpointManager`` for a few steps, tears the newest
step's manifest and must restore the step before it with that step's
values. Once, in a run of ``chip_smoke.py`` whose phase 8 ran its world of
one (the train arms' crash and resume: trainer processes of
``llama-test``, forked with a ``preexec_fn``) beside the engine arms, the
arm restored a value of step 1 under step 3's name (fault F11). This
script runs the arm ``--runs`` times alone, then ``--runs`` times beside
``--beside``: ``world``, that world of one over and over, or ``forks``, a
loop of forks each holding this process's pages copy-on-write for 20 ms
(many forks a second, where the world of one forks a few times a run). It prints each side's verdicts and the
first violation's detail. ``--root`` runs the arm from another checkout
(a parent commit, say), the fork loop staying this script's own. Run from
the repository root on a machine with an H100:

    python3 scripts/checkpoint_contention_probe.py [--runs N]
        [--alone-runs N] [--beside world|forks] [--root DIR] [--out FILE]

Prints the card's name and power limit, a line a side, and the record as
one JSON object (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import copy
import json
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

ENTRY = "workload-reshard-torn-checkpoint"
# Seconds a fork of --beside forks holds this process's pages: the
# package's ``chaos.workload.FORK_HOLD_S`` (kept here so that the probe
# runs against checkouts that predate it).
FORK_HOLD_S = 0.02


def fork_loop(stop, forks):
    """Fork until ``stop`` is set, each child holding the parent's pages
    copy-on-write for FORK_HOLD_S before it execs ``true`` (a
    ``preexec_fn`` makes subprocess fork rather than vfork)."""
    true = shutil.which("true")
    argv = [true] if true else [sys.executable, "-c", ""]
    while not stop.is_set():
        subprocess.run(argv, preexec_fn=lambda: time.sleep(FORK_HOLD_S),
                       check=False)
        forks.append(1)


def arm_runs(spec, runs, run_scenario):
    """The arm ``runs`` times: verdict counts and the first violation."""
    counts = {"pass": 0, "violated": 0}
    first = None
    for i in range(runs):
        res = run_scenario(copy.deepcopy(spec), ns=f"contention-{i}",
                           device="cuda")
        counts["pass" if res.passed else "violated"] += 1
        if not res.passed and first is None:
            first = [v["detail"] for v in res.violations]
    return counts, first


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--runs", type=int, default=500,
                        help="arm runs on each side (default 500)")
    parser.add_argument("--alone-runs", type=int, default=None,
                        help="arm runs alone (default --runs; 0 skips "
                             "that side)")
    parser.add_argument("--beside", choices=("world", "forks"),
                        default="world",
                        help="what runs beside the second side")
    parser.add_argument("--root", type=Path, default=REPO,
                        help="the checkout whose package runs the arm")
    parser.add_argument("--out", type=Path, default=None,
                        help="write the record here as JSON")
    args = parser.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("checkpoint_contention_probe: CUDA is not available",
              file=sys.stderr)
        return 2
    from triton_kubernetes_tpu_torch.chaos import corpus
    from triton_kubernetes_tpu_torch.chaos import workload as wl
    from triton_kubernetes_tpu_torch.chaos.runner import run_scenario

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"{card}; the arm from {root}", flush=True)
    entries = {e["name"]: e for _, e in corpus.load_entries(
        root / "tests" / "chaos_corpus")}
    spec = entries[ENTRY]["spec"]

    t0 = time.perf_counter()
    alone_runs = args.runs if args.alone_runs is None else args.alone_runs
    alone, alone_first = arm_runs(spec, alone_runs, run_scenario)
    alone_s = time.perf_counter() - t0
    print(f"{ENTRY} alone: {alone}, first violation {alone_first}, "
          f"{alone_s:.1f} s [{card}]", flush=True)

    stop = threading.Event()
    worlds = []

    def world_of_one():
        while not stop.is_set():
            worlds.append(wl.train_crash_resume(
                4, 2, 0, device="cuda", n_processes=1)["ok"])

    if args.beside == "world":
        beside_thread = threading.Thread(target=world_of_one, daemon=True)
    else:
        beside_thread = threading.Thread(
            target=fork_loop, args=(stop, worlds), daemon=True)
    beside_thread.start()
    t0 = time.perf_counter()
    try:
        beside, beside_first = arm_runs(spec, args.runs, run_scenario)
    finally:
        stop.set()
        beside_thread.join()
    beside_s = time.perf_counter() - t0
    what = (f"the world of one ({len(worlds)} of its runs, {sum(worlds)} "
            f"ok)" if args.beside == "world" else
            f"{len(worlds)} forks holding {FORK_HOLD_S} s")
    print(f"{ENTRY} beside {what}: {beside}, first violation "
          f"{beside_first}, {beside_s:.1f} s [{card}]", flush=True)
    line = {"card": card, "entry": ENTRY, "root": str(root),
            "runs": args.runs, "alone_runs": alone_runs,
            "beside_kind": args.beside,
            "hold_s": FORK_HOLD_S if args.beside == "forks" else None,
            "alone": alone, "alone_first_violation": alone_first,
            "alone_s": alone_s, "beside": beside,
            "beside_first_violation": beside_first, "beside_s": beside_s,
            "beside_runs": len(worlds),
            "world_of_one_ok": sum(worlds) if args.beside == "world"
            else None}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(line, indent=1))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
