"""Manifest render CLI for GPU pools: the H100 twin of the reference's
``python -m triton_kubernetes_tpu.topology``, and the seam between the
HCL modules ``terraform/modules/gcp-gpu-nodepool`` and ``gpu-jobset`` and
the renderers here: the modules pipe its output to ``kubectl apply -f -``.

Usage:
    python -m triton_kubernetes_tpu_torch.topology daemonsets \\
        --accelerator h100-8 [--image IMG]
    python -m triton_kubernetes_tpu_torch.topology jobset \\
        --name train --accelerator h100-16 --slice-id cluster-pool \\
        [--image IMG] [--namespace NS] [--env K=V ...] \\
        [--command CMD ARGS...]

Output: a Kubernetes List object (JSON) on stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from .daemonsets import (
    DEFAULT_RUNTIME_IMAGE,
    render_gpu_device_plugin,
    render_gpu_health_daemonset,
    render_gpu_runtime_daemonset,
)
from .gpus import GpuPoolSpec
from .jobset import DEFAULT_TRAIN_COMMAND, render_headless_service, \
    render_jobset


def _as_list(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {"apiVersion": "v1", "kind": "List", "items": items}


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="triton_kubernetes_tpu_torch.topology")
    sub = parser.add_subparsers(dest="cmd", required=True)

    ds = sub.add_parser("daemonsets", help="GPU host-software DaemonSets")
    ds.add_argument("--accelerator", required=True)
    ds.add_argument("--image", default="")

    js = sub.add_parser("jobset", help="multi-host training workload")
    js.add_argument("--name", required=True)
    js.add_argument("--accelerator", required=True)
    js.add_argument("--slice-id", required=True)
    js.add_argument("--image", default=DEFAULT_RUNTIME_IMAGE)
    js.add_argument("--namespace", default="default")
    js.add_argument("--env", action="append", default=[], metavar="K=V")
    js.add_argument("--command", nargs=argparse.REMAINDER,
                    default=list(DEFAULT_TRAIN_COMMAND))

    args = parser.parse_args(argv)
    try:
        spec = GpuPoolSpec.from_accelerator(args.accelerator)
    except ValueError as e:
        parser.error(str(e))

    if args.cmd == "daemonsets":
        kwargs = {"image": args.image} if args.image else {}
        items = [render_gpu_runtime_daemonset(spec, **kwargs),
                 render_gpu_device_plugin(spec),
                 render_gpu_health_daemonset(spec, **kwargs)]
    else:
        env = {}
        for kv in args.env:
            if "=" not in kv:
                parser.error(f"--env expects K=V, got {kv!r}")
            k, v = kv.split("=", 1)
            env[k] = v
        items = [render_headless_service(args.name, args.namespace),
                 render_jobset(args.name, spec, args.slice_id,
                               image=args.image,
                               command=args.command or list(
                                   DEFAULT_TRAIN_COMMAND),
                               namespace=args.namespace, env=env)]

    json.dump(_as_list(items), sys.stdout, indent=2, sort_keys=True)
    sys.stdout.write("\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # A downstream `| head` closing early is a quiet exit.
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
