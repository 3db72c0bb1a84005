#!/usr/bin/env python3
"""Which gloo operations take CUDA tensors, in a world of two processes
on one card.

``chip_smoke.py``'s worlds on one H100 run gloo over ranks that all sit
on cuda:0 (NCCL refuses two ranks on one device). PyTorch's backend table
lists only broadcast and all_reduce for gloo on CUDA tensors, so this
script asks the card: each rank runs all_reduce, all_gather_into_tensor,
reduce_scatter_tensor and broadcast on CUDA tensors, a batch_isend_irecv
of host tensors, and last a batch_isend_irecv of CUDA tensors (the
operation GPipe's shift along ``stage`` needs), printing each result or
error. The last one may take the process down (gloo reads the tensor's
pointer as host memory), so each rank writes its record before it, and
the exit codes are printed. Run from the repository root on a machine
with an NVIDIA GPU:

    python3 scripts/gloo_cuda_probe.py [--out FILE]

Prints the card's name and power limit, each rank's lines, and the
record as one JSON object (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import datetime
import json
import socket
import subprocess
import sys
from pathlib import Path

import torch


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_main(rank: int, port: int, out: Path) -> None:
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    peer = 1 - rank
    record = {}

    def all_reduce():
        x = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        return x.tolist() == [3.0] * 4

    def all_gather():
        o = torch.empty(8, device="cuda")
        dist.all_gather_into_tensor(o, torch.full((4,), float(rank),
                                                  device="cuda"))
        return o.tolist() == [0.0] * 4 + [1.0] * 4

    def reduce_scatter():
        o = torch.empty(2, device="cuda")
        dist.reduce_scatter_tensor(o, torch.arange(4, device="cuda",
                                                   dtype=torch.float32))
        return o.tolist() == [4.0 * rank, 4.0 * rank + 2.0]

    def broadcast():
        x = torch.full((3,), float(rank), device="cuda")
        dist.broadcast(x, src=1)
        return x.tolist() == [1.0] * 3

    def p2p(device):
        def run():
            x = torch.full((3,), float(rank + 10), device=device)
            o = torch.zeros(3, device=device)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, peer),
                    dist.P2POp(dist.irecv, o, peer)]):
                req.wait()
            return o.tolist() == [float(peer + 10)] * 3
        return run

    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("reduce_scatter", reduce_scatter),
                     ("broadcast", broadcast), ("p2p_host", p2p("cpu")),
                     ("p2p_cuda", p2p("cuda"))):
        if name == "p2p_cuda":
            out.write_text(json.dumps(record))
        try:
            record[name] = fn()
        except Exception as e:  # a refusal is the reading
            record[name] = f"error: {e!r}"[:300]
        print(f"rank {rank}: {name}: {record[name]}", flush=True)
    out.write_text(json.dumps(record))
    dist.destroy_process_group()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--rank", nargs=3, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank is not None:
        rank_main(int(args.rank[0]), int(args.rank[1]), Path(args.rank[2]))
        return 0
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    port = _free_port()
    outs = [Path(f"gloo_probe_rank{r}.json") if args.out is None
            else args.out.with_name(f"{args.out.stem}_rank{r}.json")
            for r in range(2)]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               str(port), str(outs[r])]) for r in range(2)]
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=180))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    ranks = [json.loads(o.read_text()) if o.exists() else None
             for o in outs]
    for o in outs:
        o.unlink(missing_ok=True)
    record = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, exit_codes=codes, ranks=ranks)
    if args.out is not None:
        args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
