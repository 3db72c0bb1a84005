#!/usr/bin/env python3
"""Time versions of the paged prefill kernel against each other on the card.

Each ``--src LABEL=DIR`` names a directory holding a ``paged_prefill.cu``
(with the C entries of ``triton_kubernetes_tpu_torch/csrc``, the same
arguments as ``ops/_kernels.py`` passes) and the headers it includes. All
are built at once with ``nvcc`` and the port's flags, each kernel is held
to the plain version of ``ops/paged_attention.py`` at ``chip_smoke.py``'s
tolerance, and then timed the way ``chip_smoke.py`` times it: one
256-token window of Llama-3-8B heads (Hq 32, Hkv 8, D 128, bs 16) at
offsets 0, 256 and 1,024, on bf16, int8 and fp8 pages, CUDA events,
median of 30 launches with the L2 flushed before each. The versions take
turns (A, B, ..., then the reverse order) so that drift of the card's
clock falls on all of them. Run from the repository root on a machine with
an H100:

    python3 scripts/bench_paged_prefill.py \\
        --src new=triton_kubernetes_tpu_torch/csrc \\
        --src old=_compare/old/csrc [--out prefill_bench.json]

Prints each version's registers and spills as ``ptxas`` reports them, a
line per (version, page kind, offset), the sums over the three offsets,
and the same as one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from triton_kubernetes_tpu_torch.ops import _kernels as K  # noqa: E402
from triton_kubernetes_tpu_torch.ops import paged_attention as pa  # noqa: E402


def build(srcs: dict, out: Path) -> dict:
    """{label: (CDLL, ptxas lines of the prefill kernels)}, built at once."""
    nvcc = K.find_nvcc()
    procs = {}
    for label, src in srcs.items():
        so = out / f"libprefill_{label}.so"
        procs[label] = (so, subprocess.Popen(
            [nvcc, *K.NVCC_FLAGS, "-o", str(so),
             str(Path(src) / "paged_prefill.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{label}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for suffix in K._entry_suffixes("paged_prefill"):
            fn = getattr(lib, f"tk8s_paged_prefill_{suffix}")
            fn.argtypes = K._SIGNATURES["paged_prefill"]
            fn.restype = ctypes.c_int
        # "Compiling entry function '<mangled>'" then "Used N registers".
        regs, kernel = [], None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
            elif kernel and "Used" in line and "registers" in line:
                regs.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
            elif kernel and "spill" in line and " 0 bytes spill" not in line:
                regs.append(f"{kernel}: {line.strip()}")
        libs[label] = (lib, regs)
    return libs


def launcher(lib, q, kp, vp, table, offset, ks, vs):
    """One launch of a version's C entry as ``_kernels.paged_prefill``
    makes it, into a fresh output."""
    _, c, hq, d = q.shape
    _, hkv, bs, _ = kp.shape
    suffix = K._SUFFIX[q.dtype] + (
        "" if kp.dtype == q.dtype else "_" + K._PAGE_SUFFIX[kp.dtype])
    fn = getattr(lib, f"tk8s_paged_prefill_{suffix}")
    variant = K.PAGED_VARIANTS[K.paged_variant(q.dtype, kp.dtype, bs, d)]
    scales = (None, None) if ks is None else (ks.data_ptr(), vs.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), *scales,
                table.data_ptr(), out.data_ptr(), c, hkv, hq // hkv, d, bs,
                table.shape[0], offset, d ** -0.5, variant, stream)
        if rc != 0:
            raise RuntimeError(f"paged_prefill launch failed: {rc}")
        return out
    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", action="append", required=True,
                        help="LABEL=DIR holding a paged_prefill.cu")
    parser.add_argument("--out", type=Path, default=None,
                        help="file for the JSON record")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_paged_prefill: needs a CUDA device", file=sys.stderr)
        return 2
    srcs = dict(s.split("=", 1) for s in args.src)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(srcs, Path(tmp))
        for label, (_, regs) in libs.items():
            for line in regs:
                if "prefill_mma" in line:
                    print(f"ptxas {label}: {line}", flush=True)
        device = torch.device("cuda")
        gen = torch.Generator(device=device).manual_seed(1234)
        flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
        ms = {label: {kind: {} for kind in cs.KV_KINDS} for label in srcs}
        for off in cs.PREFILL_OFFSETS:
            total = off + cs.PREFILL_CHUNK
            table_cpu = (torch.randperm(cs.T, generator=torch.Generator()
                                        .manual_seed(off)) + 1
                         ).to(torch.int32)
            kp16, vp16 = cs.make_pool(gen, 1 + cs.T,
                                      [(total, table_cpu.tolist())], device)
            table = table_cpu.to(device)
            q = torch.randn((1, cs.PREFILL_CHUNK, cs.HQ, cs.D), generator=gen,
                            device=device).to(torch.bfloat16)
            for kind in cs.KV_KINDS:
                kp, vp, ks, vs = cs.pool_variant(kp16, vp16, kind)
                want = pa.paged_prefill_attention(q, kp, vp, table, off, ks,
                                                  vs, impl="dense")
                runs = {label: launcher(lib, q, kp, vp, table, off, ks, vs)
                        for label, (lib, _) in libs.items()}
                for label, run in runs.items():
                    got = run()
                    torch.cuda.synchronize()
                    cs.check_close(f"{label} paged_prefill@{off} ({kind})",
                                   got, want)
                order = list(runs) + list(reversed(runs))
                times = {label: [] for label in runs}
                for label in order:
                    times[label].append(cs.time_ms(runs[label], flush))
                for label, t in times.items():
                    ms[label][kind][off] = t
                    print(f"{label} {kind} offset {off}: "
                          f"{', '.join(f'{x:.4f}' for x in t)} ms",
                          flush=True)
    sums = {label: {kind: [sum(v[i] for v in per.values())
                           for i in range(2)]
                    for kind, per in kinds.items()}
            for label, kinds in ms.items()}
    for label, kinds in sums.items():
        print(f"{label}: summed over offsets {cs.PREFILL_OFFSETS}: "
              + "; ".join(f"{k} {', '.join(f'{x:.4f}' for x in v)} ms"
                          for k, v in kinds.items()) + f" [{card}]",
              flush=True)
    record = dict(card=card, srcs=srcs, ms=ms, summed=sums,
                  ptxas={label: regs for label, (_, regs) in libs.items()})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps(dict(summed=sums)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
