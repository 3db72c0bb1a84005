"""``python -m triton_kubernetes_tpu_torch.tools.chaos`` -- the port of
``tk8s chaos``: a seeded sweep of generated scenarios, each scenario's GPU
twin through the infra arms (the module DAG against the simulated cloud:
host code) and, for a workload profile, its workload fault through its
arm against the port's engines, router, migration, checkpoints and
trainer on ``--device`` (the card unless ``--device cpu``).

Prints ``chaos sweep: P/N scenarios passed (profile=..., seed=...,
simulated Xs)`` and a line per failing seed; exits 1 on any failure, 2 on
a bad argument. ``--shrink`` shrinks failing seeds to minimal specs and
writes them as corpus entries under ``--corpus-dir``, which it needs
named: the committed ``tests/chaos_corpus/`` is the reference package's,
and the port reads it and never writes it."""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..chaos.generator import PROFILES
from ._log import error


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m triton_kubernetes_tpu_torch.tools.chaos",
        description="property-based chaos sweep over the port: seeded "
                    "module DAGs + fault plans against the simulated "
                    "cloud, and workload faults against the real engines, "
                    "router, migration, checkpoints or trainer, checked "
                    "by the pinned invariants")
    p.add_argument("--seed", type=int, default=0, metavar="N",
                   help="base seed of the sweep (default: 0; scenario i "
                        "derives its own seed deterministically)")
    p.add_argument("--runs", type=int, default=25, metavar="N",
                   help="generated scenarios to run (default: 25)")
    p.add_argument("--profile", choices=sorted(PROFILES),
                   default="default",
                   help="generation profile: DAG sizes, provider mix, "
                        "fault density (default: default)")
    p.add_argument("--shrink", action="store_true",
                   help="shrink failing seeds to minimal specs and write "
                        "them as corpus entries under --corpus-dir")
    p.add_argument("--corpus-dir", default=None, metavar="DIR",
                   help="where shrunk counterexamples land; required with "
                        "--shrink")
    p.add_argument("--device", default="cuda",
                   help="device the workload arms run on (default: cuda; "
                        "cpu runs the plain versions; the infra arms need "
                        "none)")
    p.add_argument("--json", action="store_true",
                   help="print the sweep report as JSON")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.shrink and args.corpus_dir is None:
        error("--shrink needs --corpus-dir: the committed corpus is the "
              "reference package's, which the port never writes",
              "ValueError", args.json)
        return 2
    from ..chaos.runner import run_sweep
    from ..models.llama import resolve_device

    try:
        if PROFILES[args.profile].get("workload_weight"):
            # Only a workload profile's arms touch the device.
            resolve_device(args.device)
    except RuntimeError as e:
        error(str(e), "RuntimeError", args.json)
        return 2
    report = run_sweep(
        seed=args.seed, runs=args.runs, profile=args.profile,
        shrink=args.shrink,
        corpus_dir=args.corpus_dir if args.shrink else None,
        log=lambda m: print(m, file=sys.stderr), device=args.device)
    if args.json:
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
    else:
        print(f"chaos sweep: {report.passed}/{report.runs} scenarios "
              f"passed (profile={args.profile}, seed={args.seed}, "
              f"simulated {report.simulated_seconds:.1f}s)")
        for r in report.results:
            print(f"  seed {r.spec['seed']}: violated "
                  + ", ".join(sorted({v['invariant']
                                      for v in r.violations})))
        for path in report.corpus_written:
            print(f"  corpus entry written: {path}")
    return 1 if report.failed else 0


if __name__ == "__main__":
    sys.exit(main())
