"""``python -m triton_kubernetes_tpu_torch.tools.operate --cluster-manager M
...`` -- the port of ``tk8s operate``: the reconcile operator over a state
document of GPU pools. Each tick it observes (the document, the applied
state and simulated cloud of the port's executor, the ``--scrape``
replicas' windowed ``/metrics``), lets the SLO autoscaler grow or drain
the ``--autoscale-cluster``'s GPU pools, converges the document, moves
one KV session between replicas under ``--rebalance-gap``, and with
``--train-desired`` replaces, shrinks or regrows the train fleet.

It accepts every flag of the reference's ``operate`` parser, plus where
the reference reads its global config: ``--cluster-manager`` (the
document's name) and ``--state-dir`` (the local backend's root); the
executor's wavefront is the reference CLI's default width,
:data:`PARALLELISM`. It imports no torch: the operator runs no tensor
code.

With ``--operator-port`` the first line printed is ``operating manager M
on http://host:port (...)``, else ``operating manager M (no
endpoint)``; the last is ``operate: stopped after N ticks
(converged=...)``. Exit 0 after ``--max-ticks``/``--until-converged``,
143 on SIGTERM (the trace file closed first), 2 on a bad argument or a
document the backend does not hold."""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

from ..constants import OPERATOR_PORT
from ._log import error
from ._shutdown import sigterm_runs_finally

# The executor's wavefront width: the reference CLI's default.
PARALLELISM = 4


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m triton_kubernetes_tpu_torch.tools.operate",
        description="run the reconcile operator: a continuous observe->"
                    "diff->act loop converging desired state against the "
                    "cloud, with an optional metrics-driven GPU-pool "
                    "autoscaler")
    p.add_argument("--cluster-manager", default=None, metavar="NAME",
                   help="state document to operate (default: the "
                        "backend's only one)")
    p.add_argument("--state-dir", default="~/.triton-kubernetes-tpu",
                   metavar="DIR",
                   help="root of the local backend holding the document "
                        "(default: ~/.triton-kubernetes-tpu)")
    p.add_argument("--interval", type=float, default=10.0,
                   metavar="SECONDS",
                   help="seconds between reconcile ticks (default: 10)")
    p.add_argument("--max-ticks", type=int, default=None, metavar="N",
                   help="stop after N ticks (default: run forever)")
    p.add_argument("--until-converged", action="store_true",
                   help="stop at the first tick that observes no drift and "
                        "acts on nothing")
    p.add_argument("--scrape", action="append", default=[], metavar="URL",
                   dest="scrape_urls",
                   help="serving replica /metrics endpoint to scrape each "
                        "tick (repeatable); the autoscaler is blind -- and "
                        "holds -- without at least one")
    p.add_argument("--autoscale-cluster", default=None, metavar="NAME",
                   help="GPU cluster whose node pools the autoscaler may "
                        "grow/drain (default: reconcile-only)")
    p.add_argument("--ttft-slo", type=float, default=0.5,
                   metavar="SECONDS",
                   help="TTFT p99 SLO the autoscaler defends, quantiled "
                        "over each tick's scrape window (default: 0.5)")
    p.add_argument("--queue-high", type=float, default=8.0, metavar="N",
                   help="fleet queue depth treated as a breach "
                        "(default: 8)")
    p.add_argument("--queue-low", type=float, default=1.0, metavar="N",
                   help="fleet queue depth treated as calm -- "
                        "drain-eligible (default: 1)")
    p.add_argument("--min-pools", type=int, default=1, metavar="N",
                   help="autoscaler floor on GPU pools (default: 1)")
    p.add_argument("--max-pools", type=int, default=4, metavar="N",
                   help="autoscaler ceiling on GPU pools (default: 4)")
    p.add_argument("--scale-up-after", type=int, default=2,
                   metavar="TICKS",
                   help="consecutive breached ticks before a grow "
                        "(default: 2)")
    p.add_argument("--scale-down-after", type=int, default=5,
                   metavar="TICKS",
                   help="consecutive calm ticks before a drain "
                        "(default: 5)")
    p.add_argument("--cooldown", type=float, default=60.0,
                   metavar="SECONDS",
                   help="hold after any grow/drain (default: 60)")
    p.add_argument("--rebalance-gap", type=float, default=0.0,
                   metavar="FRACTION",
                   help="KV-pool utilization spread between the hottest "
                        "and coolest scraped replica beyond which one "
                        "session a tick migrates from hot to cool "
                        "(default: 0 = off)")
    p.add_argument("--rebalance-high", type=float, default=0.75,
                   metavar="FRACTION",
                   help="KV-pool utilization the hottest replica must "
                        "exceed before a rebalance fires (default: 0.75)")
    p.add_argument("--operator-host", default="127.0.0.1", metavar="ADDR",
                   help="bind address of the operator's /metrics + "
                        "/healthz endpoint (default: 127.0.0.1)")
    p.add_argument("--operator-port", type=int, default=None, metavar="N",
                   help=f"port of the operator endpoint (default: none; "
                        f"manifests use {OPERATOR_PORT}; 0 = ephemeral)")
    p.add_argument("--train-desired", type=int, default=0, metavar="N",
                   help="train-fleet worker count the operator defends "
                        "(default: 0 = no train fleet)")
    p.add_argument("--train-min", type=int, default=1, metavar="N",
                   help="smallest worker count worth an elastic restart "
                        "(default: 1)")
    p.add_argument("--train-status", default=None, metavar="FILE",
                   help="JSON file read each tick for the train fleet's "
                        "observed state ({\"running_workers\": N, "
                        "\"capacity_workers\": M, ...}); missing or torn "
                        "= no signal")
    p.add_argument("--train-regrow-cooldown", type=float, default=60.0,
                   metavar="SECONDS",
                   help="hold between a landed train resize and the next "
                        "regrow (default: 60)")
    p.add_argument("--train-jobset-dir", default=None, metavar="DIR",
                   help="actuate train resizes by rendering the resized "
                        "Job manifest of the GPU pool into DIR (default: "
                        "decisions journal but nothing actuates)")
    p.add_argument("--train-jobset-name", default="train", metavar="NAME",
                   help="Job/Service name of --train-jobset-dir renders "
                        "(default: train)")
    p.add_argument("--train-accelerator", default="h100-16",
                   metavar="TYPE",
                   help="GPU pool of the train fleet behind "
                        "--train-jobset-dir renders (default: h100-16)")
    p.add_argument("--train-image", default="tk8s/torch-cuda-runtime:0.1.0",
                   metavar="IMAGE",
                   help="container image of --train-jobset-dir renders "
                        "(default: the runtime image)")
    p.add_argument("--journal-out", default=None, metavar="FILE",
                   help="append every reconcile tick's journal record as "
                        "a JSON line")
    p.add_argument("--trace-jsonl", default=None, metavar="FILE",
                   help="append every reconcile tick and actuation as "
                        "operator.* spans -- one input of `python -m "
                        "triton_kubernetes_tpu_torch.tools.trace merge`")
    return p


def _build(args, log):
    """(reconciler, manager) from the parsed flags; raises ``ValueError``
    for a bad combination."""
    from ..backends import LocalBackend
    from ..executor import LocalExecutor
    from ..operator import (Autoscaler, AutoscalerConfig, Reconciler,
                            TrainFleetConfig, TrainFleetPolicy,
                            file_train_status, http_rebalancer,
                            jobset_actuator)
    from ..utils.logging import get_logger

    backend = LocalBackend(args.state_dir)
    states = backend.states()
    manager = args.cluster_manager
    if manager is None:
        if len(states) != 1:
            raise ValueError(f"--cluster-manager must be given: the "
                             f"backend holds {states}")
        manager = states[0]
    if manager not in states:
        raise ValueError(f"Selected cluster manager '{manager}' does not "
                         f"exist (choices: {states})")
    autoscaler = None
    if args.autoscale_cluster:
        autoscaler = Autoscaler(AutoscalerConfig(
            ttft_slo_p99_s=args.ttft_slo, queue_high=args.queue_high,
            queue_low=args.queue_low, min_pools=args.min_pools,
            max_pools=args.max_pools, scale_up_after=args.scale_up_after,
            scale_down_after=args.scale_down_after,
            cooldown_s=args.cooldown))
    rebalancer = None
    if args.rebalance_gap > 0:
        if not args.scrape_urls:
            raise ValueError("--rebalance-gap needs at least one --scrape: "
                             "KV pressure is read from the serving fleet's "
                             "/metrics")
        rebalancer = http_rebalancer(list(args.scrape_urls))
    train_policy = train_status = train_actuator = None
    if args.train_desired > 0:
        if not args.train_status:
            raise ValueError("--train-desired needs --train-status: the "
                             "policy is blind without the train fleet's "
                             "observed state")
        train_policy = TrainFleetPolicy(TrainFleetConfig(
            desired_workers=args.train_desired, min_workers=args.train_min,
            regrow_cooldown_s=args.train_regrow_cooldown,
            serve_queue_high=args.queue_high, ttft_slo_p99_s=args.ttft_slo))
        train_status = file_train_status(args.train_status)
        if args.train_jobset_dir:
            from ..topology.gpus import GpuPoolSpec

            train_actuator = jobset_actuator(
                args.train_jobset_dir, args.train_jobset_name,
                GpuPoolSpec.from_accelerator(args.train_accelerator),
                args.train_image)
    writer = None
    if args.trace_jsonl:
        from ..utils.trace import TraceWriter

        writer = TraceWriter(args.trace_jsonl, role="operator")
    logger = get_logger()
    executor = LocalExecutor(log=log, logger=logger,
                             parallelism=PARALLELISM)
    reconciler = Reconciler(
        backend, executor, manager, autoscaler=autoscaler,
        autoscale_cluster=args.autoscale_cluster,
        metrics_sources=list(args.scrape_urls), interval_s=args.interval,
        journal_path=args.journal_out, trace=writer, rebalancer=rebalancer,
        rebalance_gap=args.rebalance_gap,
        rebalance_high=args.rebalance_high, train_policy=train_policy,
        train_status=train_status, train_actuator=train_actuator, log=log)
    return reconciler, manager


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    from ..operator import OperatorHTTPServer
    from ..utils import metrics

    metrics.get_registry().register_catalog()

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    try:
        reconciler, manager = _build(args, log)
    except ValueError as e:
        error(str(e), "ValueError", False)
        return 2
    server = None
    try:
        if args.operator_port is not None:
            server = OperatorHTTPServer(reconciler, host=args.operator_host,
                                        port=args.operator_port).start()
            # Heartbeat liveness: a tick completed recently on the loop's
            # own monotonic clock, within a budget that covers the worst
            # healthy tick (every scrape timing out in turn); a first
            # tick that never completes counts from startup.
            stale_after = (max(60.0, 5 * args.interval)
                           + len(args.scrape_urls)
                           * reconciler.watcher.timeout_s)
            started_at = time.monotonic()
            server.set_liveness(
                lambda: time.monotonic()
                - (reconciler.last_tick_at
                   if reconciler.last_tick_at is not None
                   else started_at) < stale_after)
            print(f"operating manager {manager} on {server.url} "
                  f"(GET /metrics, GET /healthz, GET /stats)", flush=True)
        else:
            print(f"operating manager {manager} (no endpoint)", flush=True)
        sigterm_runs_finally()
        ticks = reconciler.run(max_ticks=args.max_ticks,
                               until_converged=args.until_converged)
        print(f"operate: stopped after {ticks} ticks "
              f"(converged={reconciler.converged})", flush=True)
    except KeyboardInterrupt:
        print("\nstopped", file=sys.stderr)
    finally:
        if server is not None:
            server.close()
        if reconciler.trace is not None:
            reconciler.trace.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
