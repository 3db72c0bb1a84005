#!/usr/bin/env python3
"""Fault F9's probe on the card, on any checkout of the port.

A preempted sequence recomputes its history in prefill windows and takes
its next token from a window's last row, where its solo run took it from a
decode tick. ``chip_smoke.py``'s ``recompute_probe`` compares the two rows
(and the pages they leave) for Llama-3-8B at full width, random bf16
weights from seed 0: the chaos arms' pools (bs 4, chunk 8: the paged
kernels' CUDA-core designs) and a tensor-core pool (bs 16, chunk 16).
This script runs that probe against the package of another checkout --
``--root`` a ``git archive`` of an earlier commit, say -- building its
kernels into its own ``_build/``, so a change to the row's bits can be
measured before and after in one call. Run from the repository root on a
machine with an H100:

    python3 scripts/recompute_rows_probe.py [--root DIR] [--out FILE]

Prints the card's name and power limit, a line a design, and the records
as one JSON object (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=Path, default=REPO,
                        help="checkout whose triton_kubernetes_tpu_torch is "
                             "probed (default: this one)")
    parser.add_argument("--out", type=Path, default=None,
                        help="write the records here as JSON")
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("recompute_rows_probe: CUDA is not available", file=sys.stderr)
        return 2
    from triton_kubernetes_tpu_torch.models import get_config, init_params
    from triton_kubernetes_tpu_torch.ops import _kernels

    spec = importlib.util.spec_from_file_location("chip_smoke_probe",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(f"probing {_kernels.CSRC}", flush=True)
    _kernels.build(_kernels.KERNELS)
    cfg = get_config("llama3-8b")
    model = init_params(cfg, seed=0, device="cuda")
    records = cs.recompute_probe(model, cfg, card)
    line = {"root": str(args.root), "card": card, "layers": cfg.num_layers,
            "f9_probe": records}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(line, indent=1))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
