#!/usr/bin/env python3
"""Time the decode GEMM's K split on the card, group by group.

For each launch of the Llama-3-8B decode and verify steps and prefill
windows (``chip_smoke.GEMM_GROUPS``: wq+wk+wv, wo, w3+w1, w2, the lm
head), each tile width of ``--tiles`` and each number of K ranges S of
``--splits``, at M 8 (a decode tick's rows), 32 (a verify tick's), 128
and 256 (prefill windows, which take the wgmma kernel): one launch of ``csrc/decode_gemm.cu``'s C entry with that
tile and S (in place of ``_kernels.gemm_tile`` and ``gemm_splits``'
choice), held to the plain version at ``chip_smoke.py``'s tolerance and
its rows bit for bit to the same rows through launches of 64 rows, then
timed the way ``chip_smoke.py``
times it (CUDA events, median of 30, the L2 flushed before each). Beside
it: one ``torch.mm`` on the group's weights concatenated, ``torch.mm`` of
each weight in turn, and the weight-bytes bound. The (build, tile, S)
cases of a (group, M) take turns, forwards then backwards, so drift of
the card's clock falls on all of them. Run from the repository root on a
machine with an H100:

    python3 scripts/bench_decode_gemm.py [--splits 1 2 3 4] [--tiles 64 128]
        [--flush zero read] [--variant LABEL=NVCC_FLAGS ...]
        [--src LABEL=FILE ...] [--out gemm_bench.json]

``--variant`` adds builds of the same source with extra nvcc flags (for
example ``-DTK8S_GEMM_STAGES_64=10``) and ``--src LABEL=FILE`` builds of
another version of the source with the same C entries, all timed in the
same turns. Prints a line per (group, M, build, tile, S), the fastest
per group beside the port's choice, and writes the readings as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from triton_kubernetes_tpu_torch.ops import _kernels as K  # noqa: E402
from triton_kubernetes_tpu_torch.ops import decode_gemm as dg  # noqa: E402


# Row counts timed: a decode tick's, a verify tick's, and two prefill
# windows' (the wgmma kernel).
ROWS = (*cs.GEMM_ROWS, 128, cs.WINDOW_ROWS)


def build_variants(variants: dict, out: Path) -> dict:
    """{label: CDLL} of each label's (source, extra nvcc flags), built all
    at once; the label "repo" is the port's own build."""
    nvcc = K.find_nvcc()
    procs, libs = {}, {}
    for label, (src, flags) in variants.items():
        if label == "repo":
            libs[label] = K.library("decode_gemm")
            continue
        so = out / f"libdecode_gemm_{label}.so"
        procs[label] = (so, subprocess.Popen(
            [nvcc, *K.NVCC_FLAGS, *flags.split(), "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{label}: nvcc failed:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {label}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        for suffix in K._entry_suffixes("decode_gemm"):
            fn = getattr(lib, f"tk8s_decode_gemm_{suffix}")
            fn.argtypes = K._SIGNATURES["decode_gemm"]
            fn.restype = ctypes.c_int
        libs[label] = lib
    return libs


def launcher(lib, x, ws, out, tile_n, splits, counters):
    """One launch of a build's C entry with blocks of ``tile_n`` columns
    and ``splits`` K ranges, as ``_kernels.decode_gemm`` makes it with its
    own choices; returns the outputs."""
    m, k = x.shape
    ns = [w.shape[1] for w in ws]
    cols = sum(-(-n // tile_n) * tile_n for n in ns)
    pad = K.MAX_GEMM_PROBLEMS - len(ws)
    fn = getattr(lib, f"tk8s_decode_gemm_{K.GEMM_SUFFIXES[(x.dtype, out)]}")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        ys = [torch.empty((m, n), dtype=out, device=x.device) for n in ns]
        work = torch.empty(cols * splits * -(-m // 64) * min(m, 64),
                           dtype=torch.float32,
                           device=x.device)
        rc = fn(x.data_ptr(), *[w.data_ptr() for w in ws], *[None] * pad,
                *[y.data_ptr() for y in ys], *[None] * pad, *ns,
                *[0] * pad, len(ws), m, k, tile_n, splits, work.data_ptr(),
                counters.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"decode_gemm launch failed: {rc}")
        return ys
    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--splits", type=int, nargs="+",
                        default=[1, 2, 3, 4],
                        help="numbers of K ranges to time")
    parser.add_argument("--tiles", type=int, nargs="+", default=[64, 128],
                        help="output columns a block (64, 128) to time")
    parser.add_argument("--flush", choices=("zero", "read"), nargs="+",
                        default=["zero"],
                        help="how the L2 is emptied before each timed "
                             "launch: zeroing the flush buffer, as "
                             "chip_smoke.py does (the L2 is then full of "
                             "dirty lines the kernel's reads must write "
                             "back), or reading it (clean lines)")
    parser.add_argument("--variant", action="append", default=[],
                        help="LABEL=FLAGS: also time decode_gemm.cu built "
                             "with these extra nvcc flags (for example "
                             "-DTK8S_GEMM_STAGES_64=10)")
    parser.add_argument("--src", action="append", default=[],
                        help="LABEL=FILE: also time another version of "
                             "decode_gemm.cu with the same C entries (an "
                             "older tree's, for an A/B)")
    parser.add_argument("--out", type=Path, default=None,
                        help="file for the JSON record")
    args = parser.parse_args()
    timers = {"zero": cs.time_ms,
              "read": functools.partial(cs.time_ms, read_flush=True)}
    if not torch.cuda.is_available():
        print("bench_decode_gemm: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    device = torch.device("cuda")
    bw = cs.card_peaks(torch.cuda.get_device_name(0))[1][0]
    log = K.build(["decode_gemm"]).get("decode_gemm", "")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas repo: {line.strip()}", flush=True)
    own = K.CSRC / "decode_gemm.cu"
    with tempfile.TemporaryDirectory() as tmp:  # the loaded copies stay
        libs = build_variants(
            {"repo": (own, ""),
             **{label: (own, flags) for label, flags in
                (v.split("=", 1) for v in args.variant)},
             **{label: (Path(src), "") for label, src in
                (v.split("=", 1) for v in args.src)}},
            Path(tmp))
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    counters = torch.zeros(8192, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(99)
    rows, best = [], {}
    for name, k, ns, out in cs.GEMM_GROUPS:
        ws = [(torch.randn((k, n), generator=gen, device=device) * 0.02
               ).to(torch.bfloat16) for n in ns]
        w_cat = torch.cat(ws, dim=1) if len(ws) > 1 else ws[0]
        x = torch.randn((max(ROWS), k), generator=gen, device=device
                        ).to(torch.bfloat16)
        n = sum(ns)
        cases = [(label, t, s) for label in libs for t in args.tiles
                 for s in args.splits if s <= -(-k // K.GEMM_TILE_K)]
        # Every row through launches of 64 rows: what any M must give.
        tiles = {c: torch.cat([torch.cat(launcher(
            libs[c[0]], x[lo:lo + 64].contiguous(), ws, out, c[1], c[2],
            counters)(), dim=1) for lo in range(0, x.shape[0], 64)])
            for c in cases}
        for m in ROWS:
            xm = x[:m].contiguous()
            want = torch.cat(dg.decode_gemm_group_plain(xm, ws, out), dim=1)
            runs = {}
            for label, t, s in cases:
                runs[label, t, s] = launcher(libs[label], xm, ws, out, t, s,
                                             counters)
                got = torch.cat(runs[label, t, s](), dim=1)
                torch.cuda.synchronize()
                cs.check_close(f"{label} {name} M={m} tile {t} S={s}", got,
                               want)
                if not torch.equal(got, tiles[label, t, s][:m]):
                    raise AssertionError(f"{label} {name} tile {t} S={s}: "
                                         f"rows at M {m} are not bitwise "
                                         f"the same rows through launches "
                                         f"of 64")
            nbytes = (k * n + m * k) * 2 + m * n * want.element_size()
            bound = nbytes / bw * 1e3
            for how in args.flush:
                timer = timers[how]
                ms = {c: [] for c in cases}
                for order in (cases, cases[::-1]):
                    for c in order:
                        ms[c].append(timer(runs[c], flush))
                lib = timer(lambda: (torch.mm(xm, w_cat) if out == xm.dtype
                                     else torch.mm(xm, w_cat, out_dtype=out)),
                            flush)
                each = timer(lambda: dg.decode_gemm_group_plain(xm, ws, out),
                             flush)
                print(f"{name} M={m} ({how} flush): one torch.mm {lib:.4f} "
                      f"ms, torch.mm each {each:.4f}, bound {bound:.5f}",
                      flush=True)
                for c in cases:
                    rows.append(dict(variant=c[0], group=name, K=k,
                                     N=list(ns), M=m, tile_n=c[1],
                                     splits=c[2], flush=how, ms=ms[c],
                                     library_ms=lib, torch_mm_each_ms=each,
                                     bound_ms=bound))
                    print(f"  {c[0]} tile {c[1]} S={c[2]}: "
                          f"{' / '.join(f'{v:.4f}' for v in ms[c])} ms "
                          f"(share {bound / min(ms[c]):.3f})", flush=True)
                top = min(cases, key=lambda c: sum(ms[c]))
                best[f"{name} M={m} {how} flush"] = dict(
                    best=f"{top[0]} tile {top[1]} S={top[2]}",
                    chosen=f"tile {K.gemm_tile(n)} S={K.gemm_splits(n, k)}")
        del ws, w_cat, x, tiles
    for key, b in best.items():
        print(f"{key}: least time {b['best']}; the port chooses "
              f"{b['chosen']}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, rows=rows, best=best),
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
