#!/usr/bin/env python3
"""Phase 4's serve run and the CUDA-core prefill kernel, on any checkout.

``chip_smoke.py`` phase 4 opens with a serve run: Llama-3-8B at full
width, random bf16 weights from seed 0, eight requests arriving over ticks
0-6 on one engine with the prefix cache (``serve_ticks``). This script
runs that serve run ``--runs`` times on one warmed engine (the prefix
cache emptied before each), and times ``paged_prefill_attention``'s
CUDA-core design at two shapes with the 8B's heads: the chaos pools' (bf16,
bs 4, an 8-token window at offsets 0, 16 and 40) and f32 queries over f32
pages at bs 16 (a 256-token window at offsets 0, 256 and 1024), each
summed over its offsets. It does so against the package of the checkout
``--root`` names -- a ``git archive`` of the parent commit, say --
building that checkout's kernels into its own ``_build/``, so two commits
are compared in one call on one card by running each in turns (A B B A).
Run from the repository root on a machine with an H100:

    python3 scripts/serve_prefill_ab.py [--root DIR] [--runs N] [--out FILE]

Prints the card's name and power limit, a line a serve run and a shape,
and the record as one JSON object (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def prefill_ms(cs, pa, dtype, bs, chunk, offsets, table_pages, flush):
    """Median ms of the CUDA-core prefill at each offset, summed."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4321)
    table_cpu = (torch.randperm(table_pages, generator=torch.Generator()
                                .manual_seed(6)) + 1).to(torch.int32)
    kp, vp = (p.to(dtype) for p in cs.chaos_pool(
        gen, 1 + table_pages, [(table_pages * bs, table_cpu.tolist())],
        "cuda", bs=bs))
    table = table_cpu.to("cuda")
    total = 0.0
    for off in offsets:
        q = torch.randn((1, chunk, cs.HQ, cs.D), generator=gen,
                        device="cuda").to(dtype)
        total += cs.time_ms(lambda: pa.paged_prefill_attention(
            q, kp, vp, table, off, impl="cuda"), flush)
    return total


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=Path, default=REPO,
                        help="checkout whose triton_kubernetes_tpu_torch is "
                             "timed (default: this one)")
    parser.add_argument("--runs", type=int, default=3,
                        help="serve runs on the one engine")
    parser.add_argument("--out", type=Path, default=None,
                        help="write the record here as JSON")
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("serve_prefill_ab: CUDA is not available", file=sys.stderr)
        return 2
    from triton_kubernetes_tpu_torch.models import get_config, init_params
    from triton_kubernetes_tpu_torch.ops import _kernels
    from triton_kubernetes_tpu_torch.ops import paged_attention as pa
    from triton_kubernetes_tpu_torch.serve import Request, ServeEngine

    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(f"timing {_kernels.CSRC}", flush=True)
    _kernels.build(_kernels.KERNELS)

    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    shapes = {
        "bf16_bs4_c8": (torch.bfloat16, 4, cs.CHAOS_PREFILL_CHUNK,
                        cs.CHAOS_PREFILL_OFFSETS, 12),
        "f32_bs16_c256": (torch.float32, cs.BS, cs.PREFILL_CHUNK,
                          cs.PREFILL_OFFSETS, cs.T)}
    prefill = {}
    for name, (dtype, bs, chunk, offsets, pages) in shapes.items():
        if _kernels.paged_variant(dtype, dtype, bs, cs.D) != "cuda_core":
            raise AssertionError(f"{name}: not the CUDA-core design")
        prefill[name] = prefill_ms(cs, pa, dtype, bs, chunk, offsets, pages,
                                   flush)
        print(f"paged_prefill {name} (CUDA-core, offsets {offsets}): "
              f"{prefill[name]!r} ms summed [{card}]", flush=True)
    del flush

    cfg = get_config("llama3-8b")
    model = init_params(cfg, seed=0, device="cuda")
    engine = ServeEngine(model, cfg, **cs.SERVE_ENGINE_KW)
    engine.submit(Request("warmup", list(range(1, 65)), 2))
    engine.run_until_idle()
    runs = []
    for i in range(args.runs):
        engine.release_prefix_cache()
        requests = cs.make_requests(cfg, Request)
        done, tick_ms, wall = cs.serve_ticks(engine, requests)
        generated = sum(len(d.tokens) for d in done.values())
        if generated != 32 * len(requests):
            raise AssertionError(f"run {i}: {generated} tokens generated")
        run = dict(
            ttft_median_s=statistics.median(d.ttft for d in done.values()),
            tpot_median_s=statistics.median(d.tpot for d in done.values()),
            tokens_per_s=generated / wall, wall_s=wall,
            tick_ms_median={k: statistics.median(v)
                            for k, v in tick_ms.items() if v})
        runs.append(run)
        print(f"serve run {i}: TTFT median {run['ttft_median_s']!r} s, "
              f"TPOT median {run['tpot_median_s']!r} s, "
              f"{run['tokens_per_s']!r} tokens/s, tick ms medians "
              f"{run['tick_ms_median']} [{card}]", flush=True)
    line = {"root": str(args.root), "card": card, "prefill_ms": prefill,
            "serve_runs": runs}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(line, indent=1))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
