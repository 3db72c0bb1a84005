"""``python -m triton_kubernetes_tpu_torch.tools.goodput report [--metrics
FILE] [--json] A.jsonl ...`` -- the port of ``tk8s goodput report``: check
that each process's ``<source>.goodput`` segments partition its recorded
window, then roll them into per-process and fleet chip-second attribution
(useful against waste, by category). ``--metrics`` folds in the
``tk8s_goodput_seconds_total`` samples of saved Prometheus scrapes, to
cross-check the two sinks. Exit 0 with the report; 1 when an input does not
parse or a ledger fails the partition check (the errors on standard
error)."""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..utils.metrics import PrometheusParseError, parse_prometheus
from ..utils.trace import (
    TraceMergeError,
    summarize_goodput,
    validate_goodput_trace,
)
from ._log import error


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m triton_kubernetes_tpu_torch.tools.goodput",
        description="goodput-ledger tooling: `report` reads per-process "
                    "trace JSONL files and rolls their <source>.goodput "
                    "segments into per-process and fleet chip-second "
                    "attribution -- useful vs waste, by category")
    p.add_argument("action", choices=["report"])
    p.add_argument("inputs", nargs="+", metavar="JSONL",
                   help="per-process trace JSONL files to report over (the "
                        "same files `trace merge` takes)")
    p.add_argument("--metrics", action="append", default=[],
                   metavar="FILE", dest="metrics_files",
                   help="Prometheus text scrape (a saved /metrics body) to "
                        "fold in (repeatable): its "
                        "tk8s_goodput_seconds_total samples are reported "
                        "alongside the trace-derived ledger")
    p.add_argument("--json", action="store_true",
                   help="print the report as JSON (and errors as JSON "
                        "lines)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    try:
        problems = validate_goodput_trace(args.inputs)
        report = summarize_goodput(args.inputs)
    except (TraceMergeError, OSError) as e:
        error(str(e), type(e).__name__, args.json)
        return 1
    if problems:
        # A ledger that fails the partition check is lying about chip
        # time: report it loudly, not as a rollup.
        for problem in problems:
            error(problem, "GoodputValidation", args.json)
        return 1
    if args.metrics_files:
        scraped: dict = {}
        try:
            for path in args.metrics_files:
                with open(path, encoding="utf-8") as f:
                    fams = parse_prometheus(f.read())
                fam = fams.get("tk8s_goodput_seconds_total")
                for s in (fam or {}).get("series", []):
                    labels = s.get("labels", {})
                    key = (labels.get("source", "?"),
                           labels.get("category", "?"))
                    scraped[key] = (scraped.get(key, 0.0)
                                    + float(s.get("value", 0.0)))
        except (PrometheusParseError, OSError) as e:
            error(str(e), type(e).__name__, args.json)
            return 1
        report["scraped_seconds"] = {
            s: {c: round(v, 9)
                for (src, c), v in sorted(scraped.items()) if src == s}
            for s in sorted({src for src, _ in scraped})}
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0
    fleet = report["fleet"]
    for proc in report["processes"]:
        cats = " ".join(f"{c}={v:.3f}s" for c, v in proc["seconds"].items())
        print(f"{proc['path']} [{proc['role']}] "
              f"source={proc['source']} wall={proc['wall_s']:.3f}s "
              f"useful={proc['useful_fraction']:.1%} "
              f"waste={proc['waste_fraction']:.1%}  {cats}")
    waste = " ".join(f"{c}={v:.3f}s" for c, v in
                     fleet["waste_by_category"].items()) or "none"
    print(f"fleet: accounted={fleet['accounted_s']:.3f} chip-s, "
          f"useful={fleet['useful_fraction']:.1%}, "
          f"waste={fleet['waste_fraction']:.1%} ({waste})")
    for src, cats in report.get("scraped_seconds", {}).items():
        pairs = " ".join(f"{c}={v:.3f}s" for c, v in cats.items())
        print(f"scraped[{src}]: {pairs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
