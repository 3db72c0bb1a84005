"""``python -m triton_kubernetes_tpu_torch.tools.route --replica URL ...``
-- the port of ``tk8s route``: the session-affine router over N serving
replicas (consistent-hash affinity, least-loaded spill, health-aware
ejection; with ``--decode-replica`` the disaggregated prefill -> decode
handoff). It imports no torch: a router box has no accelerator stack.
Prints ``routing N replicas on http://host:port (...)`` once it listens;
exit 143 on SIGTERM, after the trace and the goodput ledger are closed;
exit 2 on a bad argument."""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..constants import ROUTE_PORT
from ..serve.router import RouterHTTPServer
from ..utils import metrics
from ..utils.trace import GoodputRecorder, TraceWriter
from ._log import error
from ._shutdown import sigterm_runs_finally


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m triton_kubernetes_tpu_torch.tools.route",
        description="run the session-affine router over N serving "
                    "replicas: consistent-hash affinity, least-loaded "
                    "spill, health-aware ejection")
    p.add_argument("--replica", action="append", required=True,
                   metavar="URL", dest="replicas",
                   help="replica base URL (repeatable), e.g. "
                        "http://10.0.0.7:8000; with --decode-replica these "
                        "become the prefill pool")
    p.add_argument("--decode-replica", action="append", default=[],
                   metavar="URL", dest="decode_replicas",
                   help="decode-pool replica base URL (repeatable); any "
                        "present switches the router to disaggregated "
                        "mode -- prompts prefill on a --replica, then the "
                        "session's KV pages migrate to a decode replica "
                        "for the remaining tokens")
    p.add_argument("--route-host", default="127.0.0.1", metavar="ADDR",
                   help="bind address (default: 127.0.0.1)")
    p.add_argument("--port", type=int, default=ROUTE_PORT, metavar="N",
                   help=f"bind port (default: {ROUTE_PORT}; 0 = ephemeral)")
    p.add_argument("--spill-threshold", type=int, default=4, metavar="N",
                   help="router-tracked in-flight requests at the affine "
                        "replica beyond which a request spills to the "
                        "least-loaded healthy replica (default: 4)")
    p.add_argument("--virtual-nodes", type=int, default=64, metavar="N",
                   help="consistent-hash ring points per replica "
                        "(default: 64)")
    p.add_argument("--health-interval", type=float, default=0.5,
                   metavar="SECONDS",
                   help="background /healthz probe period; a probe failure "
                        "ejects the replica, a later 200 re-admits it "
                        "(default: 0.5)")
    p.add_argument("--request-timeout", type=float, default=120.0,
                   metavar="SECONDS",
                   help="per-attempt timeout for proxied /generate calls "
                        "(default: 120)")
    p.add_argument("--trace-jsonl", default=None, metavar="FILE",
                   help="append every placement decision as a route.place "
                        "span (replica + affine/spill/eject reason, trace "
                        "id) and the route goodput ledger -- one input of "
                        "`python -m triton_kubernetes_tpu_torch.tools."
                        "trace merge`")
    p.add_argument("--trace-seed", type=int, default=0, metavar="N",
                   help="seed of the router's trace-id minting stream: "
                        "requests arriving without an X-TK8S-Trace header "
                        "get deterministic ids (default: 0)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    metrics.get_registry().register_catalog()
    writer = goodput = None
    if args.trace_jsonl:
        writer = TraceWriter(args.trace_jsonl, role="router")
        goodput = GoodputRecorder("route", writer=writer)
    try:
        server = RouterHTTPServer(
            args.replicas, host=args.route_host, port=args.port,
            health_interval_s=args.health_interval,
            spill_threshold=args.spill_threshold,
            virtual_nodes=args.virtual_nodes,
            request_timeout_s=args.request_timeout,
            trace_seed=args.trace_seed, trace=writer,
            decode_urls=args.decode_replicas or None)
    except ValueError as e:
        error(str(e), "ValueError", False)
        if writer is not None:
            goodput.close()
            writer.close()
        return 2
    if goodput is not None:
        # Handler threads overlap: the router books forward time through
        # the recorder's depth-counted enter/exit edges.
        server.router.goodput = goodput
    host, port = server.address
    print(f"routing {len(args.replicas)} replicas on http://{host}:{port} "
          f"(POST /generate, GET /metrics, GET /healthz, GET /stats)",
          flush=True)
    sigterm_runs_finally()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nstopped", file=sys.stderr)
    finally:
        if goodput is not None:
            goodput.close()
        if writer is not None:
            writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
