"""``python -m triton_kubernetes_tpu_torch.tools.trace merge A.jsonl B.jsonl
-o fleet-trace.json`` -- the port of ``tk8s trace merge``: align the
per-process trace JSONL files (a traced serving engine's, the trainer's
``--trace-jsonl``) through their clock anchors and write ONE Chrome/Perfetto
timeline. Exit 0 with one summary line; 1 when an input does not parse or
the merged document fails its validator (the errors on standard error)."""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..utils.trace import (
    TraceMergeError,
    merge_trace_files,
    validate_chrome_trace,
)
from ._log import error


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m triton_kubernetes_tpu_torch.tools.trace",
        description="fleet-trace tooling: `merge` aligns the per-process "
                    "trace JSONL files through their clock anchors and "
                    "writes ONE Perfetto timeline")
    p.add_argument("action", choices=["merge"])
    p.add_argument("inputs", nargs="+", metavar="JSONL",
                   help="per-process trace JSONL files to merge")
    p.add_argument("--out", "-o", default="fleet-trace.json",
                   metavar="FILE",
                   help="merged Chrome/Perfetto trace output (default: "
                        "fleet-trace.json; open in ui.perfetto.dev)")
    p.add_argument("--json", action="store_true",
                   help="structured JSON-lines error output")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    try:
        doc = merge_trace_files(args.inputs)
    except (TraceMergeError, OSError) as e:
        error(str(e), type(e).__name__, args.json)
        return 1
    problems = validate_chrome_trace(doc)
    if problems:  # the merge emitted something malformed: a bug, loudly
        for problem in problems:
            error(problem, "TraceValidation", args.json)
        return 1
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    spans = sum(1 for e in doc["traceEvents"] if e["ph"] != "M")
    print(f"merged {len(args.inputs)} trace files -> {args.out} "
          f"({spans} spans; open in ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
