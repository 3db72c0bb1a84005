"""``python -m triton_kubernetes_tpu_torch.tools.serve --model NAME ...`` --
the port of ``tk8s serve``: one serving replica, continuous batching over a
paged KV pool, HTTP ``/generate``, ``/metrics``, ``/healthz``, ``/stats``
and the ``/migrate/*``, ``/await``, ``/resume`` plane (``serve/server.py``).

The model is the port's seeded random init (``--seed``) on ``--device``
(``cuda`` by default; ``cpu`` runs the kernels' plain versions). On the card
every serving kernel is built and loaded before the socket is bound, so the
first request never waits on ``nvcc``. Prints ``serving <model> on
http://host:port (...)`` once it listens; exit 143 on SIGTERM, after the
trace and the goodput ledger are closed; exit 2 on a bad flag value, 1 on
an unknown model."""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..constants import KV_DTYPES, MATMUL_DTYPES, SERVE_PORT, WEIGHT_DTYPES
from ._log import error
from ._shutdown import sigterm_runs_finally


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m triton_kubernetes_tpu_torch.tools.serve",
        description="run the inference endpoint: continuous batching over "
                    "a paged KV cache, HTTP /generate + /metrics + "
                    "/healthz")
    p.add_argument("--model", default="llama-test", metavar="NAME",
                   help="model config name (default: llama-test; see "
                        "models/config.py CONFIGS)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--serve-host", default="127.0.0.1", metavar="ADDR",
                   help="bind address (default: 127.0.0.1)")
    p.add_argument("--port", type=int, default=SERVE_PORT, metavar="N",
                   help=f"bind port (default: {SERVE_PORT}; 0 = ephemeral)")
    p.add_argument("--block-size", type=int, default=16, metavar="N",
                   help="KV-cache page size in tokens (default: 16)")
    p.add_argument("--num-blocks", type=int, default=256, metavar="N",
                   help="KV-cache pool size in pages, page 0 reserved "
                        "(default: 256)")
    p.add_argument("--max-batch", type=int, default=8, metavar="N",
                   help="decode slots batched per step (default: 8)")
    p.add_argument("--max-model-len", type=int, default=None, metavar="N",
                   help="cap on prompt + generated tokens per sequence "
                        "(default: the model's max_seq_len)")
    p.add_argument("--kv-dtype", default="auto", choices=list(KV_DTYPES),
                   metavar="DTYPE",
                   help="KV-cache page storage: auto = the model config's "
                        "activation dtype, bf16 = force bfloat16 pages, "
                        "int8/fp8 = quantized pages (int8 or "
                        "float8_e4m3fn) with per-page-per-head f32 scales")
    p.add_argument("--weight-dtype", default="auto",
                   choices=list(WEIGHT_DTYPES), metavar="DTYPE",
                   help="decode weight storage: int8/fp8 = per-channel "
                        "symmetric quantization of the big matmuls")
    p.add_argument("--matmul-dtype", default="auto",
                   choices=list(MATMUL_DTYPES), metavar="DTYPE",
                   help="arithmetic dtype of the big serving matmuls "
                        "(storage is --weight-dtype): f32 = dequantize per "
                        "use, int8/fp8 = W8A8 on the hand-written GEMM "
                        "(requires the matching --weight-dtype), auto = "
                        "dequantize")
    p.add_argument("--sequential", action="store_true",
                   help="serve one request at a time (the continuous-"
                        "batching A/B baseline)")
    p.add_argument("--prefill-chunk", type=int, default=None, metavar="N",
                   help="chunked prefill: split prompts into N-token "
                        "windows interleaved with decode steps; must be a "
                        "multiple of --block-size; 0 = whole-prompt prefill "
                        "at admission (default: 256, adapted to "
                        "--block-size)")
    p.add_argument("--prefix-cache", dest="prefix_cache",
                   action="store_true", default=None,
                   help="share full-page-aligned prompt prefixes across "
                        "requests (default: on whenever chunked prefill "
                        "is; requires --prefill-chunk > 0)")
    p.add_argument("--no-prefix-cache", dest="prefix_cache",
                   action="store_false",
                   help="disable shared-prefix KV reuse (outputs are "
                        "identical either way)")
    p.add_argument("--spec-k", type=int, default=0, metavar="N",
                   help="speculative self-drafting decode: propose up to N "
                        "tokens per sequence per step from an n-gram match "
                        "and verify all N+1 positions in one pass (0, the "
                        "default, is speculation off; outputs identical)")
    p.add_argument("--seed", type=int, default=0, metavar="N",
                   help="parameter-init seed for the randomly initialized "
                        "model, and of the DCN jitter (default: 0)")
    p.add_argument("--pool", default="colocated",
                   choices=["colocated", "prefill", "decode"],
                   metavar="ROLE",
                   help="disaggregation role label for this replica: "
                        "colocated (default), prefill or decode; the router "
                        "drives the handoff, the engine behaves identically "
                        "either way")
    p.add_argument("--dcn-gbps", type=float, default=0.0, metavar="GBPS",
                   help="simulated datacenter-network bandwidth "
                        "(gigabits/s) charged per outbound migration "
                        "payload (default 0: the model is off)")
    p.add_argument("--dcn-rtt-ms", type=float, default=0.0, metavar="MS",
                   help="simulated per-transfer round-trip latency (ms) "
                        "added on top of --dcn-gbps (default: 0)")
    p.add_argument("--dcn-jitter-ms", type=float, default=0.0, metavar="MS",
                   help="uniform [0, MS) jitter added per transfer, drawn "
                        "from a generator seeded by --seed (default: 0)")
    p.add_argument("--trace-jsonl", default=None, metavar="FILE",
                   help="append this replica's request-lifecycle spans and "
                        "its serve goodput ledger as trace JSON lines -- "
                        "one input of `python -m "
                        "triton_kubernetes_tpu_torch.tools.trace merge`")
    return p


def _prefill_chunk(args: argparse.Namespace) -> Optional[int]:
    """The chunk the flags ask for; raises ValueError on a bad value (an
    explicit chunk is never silently rewritten: a benchmark would measure
    something the operator did not ask for)."""
    if args.prefill_chunk is None:
        return max(args.block_size, 256 - 256 % args.block_size)
    if args.prefill_chunk < 0:
        raise ValueError(
            f"--prefill-chunk must be >= 0, got {args.prefill_chunk}")
    chunk = args.prefill_chunk or None
    if chunk is not None and chunk % args.block_size != 0:
        raise ValueError(f"--prefill-chunk {chunk} is not a multiple of "
                         f"--block-size {args.block_size}")
    return chunk


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    # torch comes in only here: --help and the flag checks stay light.
    from ..models import get_config, init_params
    from ..serve.server import DcnTransferModel, ServeHTTPServer
    from ..serve.engine import ServeEngine
    from ..utils import metrics
    from ..utils.trace import GoodputRecorder, TraceWriter

    try:
        config = get_config(args.model)
    except KeyError as e:
        error(str(e), "KeyError", False)
        return 1
    try:
        prefill_chunk = _prefill_chunk(args)
        if args.prefix_cache and prefill_chunk is None:
            raise ValueError(
                "--prefix-cache requires chunked prefill: prefix reuse "
                "skips whole chunk windows (set --prefill-chunk > 0)")
        if args.spec_k < 0:
            raise ValueError(f"--spec-k must be >= 0, got {args.spec_k}")
    except ValueError as e:
        error(str(e), "ValueError", False)
        return 2
    prefix_cache = (prefill_chunk is not None if args.prefix_cache is None
                    else args.prefix_cache)
    metrics.get_registry().register_catalog()
    model = init_params(config, seed=args.seed, device=args.device)
    if model.device.type == "cuda":
        # Build and load every serving kernel now, on this thread: the
        # first request must not wait on nvcc.
        from ..ops import _kernels

        _kernels.build(_kernels.SERVE_KERNELS)
        for name in _kernels.SERVE_KERNELS:
            _kernels.library(name)
    engine = ServeEngine(
        model, config, block_size=args.block_size,
        num_blocks=args.num_blocks, max_batch=args.max_batch,
        max_model_len=args.max_model_len, sequential=args.sequential,
        kv_dtype=args.kv_dtype, weight_dtype=args.weight_dtype,
        matmul_dtype=args.matmul_dtype, prefill_chunk=prefill_chunk,
        prefix_cache=prefix_cache, spec_k=args.spec_k, device=model.device)
    dcn = None
    if args.dcn_gbps or args.dcn_rtt_ms or args.dcn_jitter_ms:
        dcn = DcnTransferModel(bytes_per_s=args.dcn_gbps * 1e9 / 8,
                               rtt_s=args.dcn_rtt_ms / 1e3,
                               jitter_s=args.dcn_jitter_ms / 1e3,
                               seed=args.seed)
    server = ServeHTTPServer(engine, host=args.serve_host, port=args.port,
                             dcn=dcn)
    host, port = server.address
    if args.trace_jsonl:
        # The served engine always has a bounded flight recorder; the
        # writer upgrades it to spill every lifecycle event to disk, and
        # the goodput ledger rides the same writer.
        engine.flight.writer = TraceWriter(args.trace_jsonl,
                                           role=f"replica:{host}:{port}")
        engine.goodput = GoodputRecorder("serve", clock=engine.clock,
                                         writer=engine.flight.writer)
    print(f"serving {args.model} on http://{host}:{port} (POST /generate, "
          f"GET /metrics, GET /healthz, pool={args.pool})", flush=True)
    sigterm_runs_finally()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nstopped", file=sys.stderr)
    finally:
        if engine.goodput is not None:
            # Close the ledger BEFORE the writer: the final segment is what
            # makes the categories tile the wall window.
            engine.goodput.close()
        if engine.flight is not None and engine.flight.writer is not None:
            engine.flight.writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
