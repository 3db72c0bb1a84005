"""Trainer entry point: ``python -m triton_kubernetes_tpu_torch.train``.

The single-process path of ``python -m triton_kubernetes_tpu.train``
(``train/__main__.py:main`` in the JAX package): build the model config
(``--model`` plus ``--model-opt K=V`` overrides, ``--precision``,
``--remat-policy``), initialise f32 masters from a seed, and train on the
synthetic Markov data through the step-pipelined loop, logging loss,
tokens/s and MFU at every sync window. It writes no checkpoint. Runs on the
card unless ``--device cpu`` is given (the plain versions of the kernels
then run instead, for rehearsals at small sizes).

``--trace-jsonl PATH`` writes ``train.*`` spans and the goodput ledger (the
train categories partitioning the run's wall window) as JSON lines, as the
reference does; merge them with ``python -m
triton_kubernetes_tpu_torch.tools.trace merge`` and report them with
``python -m triton_kubernetes_tpu_torch.tools.goodput report``. One
difference: the reference compiles its step ahead of time and books that
as ``compile`` with a ``train.compile`` span (lower_s/compile_s). The port
has no ahead-of-time compile -- its kernels build at their first launch --
so its first step is booked as ``compile`` (through the loop's
``goodput_step_category``) and the ``train.compile`` span covers that
step's dispatch (a ``first_step_s`` field); the steps after it are
``step``.

Distributed training, checkpoints and resilience (and their flags), the
packed/sharded data pipelines and the profiler flag are later slices.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Optional

import torch


def parse_scalar(s: str) -> Any:
    """A ``--model-opt`` value as the reference coerces it (YAML-like
    scalars: true/false, int, float, quoted or bare string)."""
    s = s.strip()
    if s in ("true", "True"):
        return True
    if s in ("false", "False"):
        return False
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        return s[1:-1]
    return s


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m triton_kubernetes_tpu_torch.train",
        description="Single-device trainer of the PyTorch/CUDA port.")
    p.add_argument("--model", default="llama3-bench",
                   help="config name from models.CONFIGS")
    p.add_argument("--model-opt", action="append", default=[],
                   metavar="K=V",
                   help="ModelConfig override, repeatable (e.g. "
                        "--model-opt num_layers=4 --model-opt "
                        "fused_ce=true)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=0,
                   help="0 = the model's max_seq_len")
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--precision", choices=["auto", "f32", "bf16"],
                   default="auto",
                   help="precision policy (train/precision.py): f32 "
                        "master params and optimizer state always; bf16 "
                        "casts compute/activations; auto keeps the model "
                        "config's own dtypes")
    p.add_argument("--remat-policy", choices=["none", "dots", "full"],
                   default="",
                   help="rematerialization of the transformer block; "
                        "default: the model config's policy")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--log-every", type=int, default=10,
                   help="steps between logs, which are the loop's "
                        "device->host syncs")
    p.add_argument("--report-json", default="",
                   help="write a run report (per-step losses and grad "
                        "norms, window times, tokens/s, MFU, peak memory) "
                        "to this path")
    p.add_argument("--trace-jsonl", default="",
                   help="append train.* span events and the goodput "
                        "ledger (chip-time categories partitioning the "
                        "run's wall window) as JSON lines to this path; "
                        "merge with `python -m "
                        "triton_kubernetes_tpu_torch.tools.trace merge`")
    return p


def _log(msg: str, **fields: Any) -> None:
    print(" ".join([f"[train] {msg}"] + [f"{k}={v}" for k, v in
                                          fields.items()]), flush=True)


def main(argv: Optional[list] = None) -> int:
    args = _build_parser().parse_args(argv)

    from ..models import get_config
    from ..models.llama import resolve_device
    from .data import synthetic_batches
    from .mfu import flops_per_token, mfu, peak_bf16_tflops
    from .pipeline import run_pipelined
    from .precision import apply_policy, policy_of, remat_policy_of
    from .trainer import init_state, make_optimizer, make_train_step

    overrides = {}
    for item in args.model_opt:
        key, sep, value = item.partition("=")
        if not sep:
            raise SystemExit(f"--model-opt expects K=V, got {item!r}")
        overrides[key] = parse_scalar(value)
    if args.remat_policy:
        overrides["remat_policy"] = args.remat_policy
        overrides["remat"] = args.remat_policy != "none"
    config = apply_policy(get_config(args.model, **overrides),
                          args.precision)
    device = resolve_device(args.device)
    seq_len = args.seq_len or config.max_seq_len
    batch_size = args.batch_size
    _log("precision policy", policy=policy_of(config),
         compute_dtype=config.dtype, param_dtype=config.param_dtype,
         remat=remat_policy_of(config), attention=config.attention,
         fused_ce=config.fused_ce)
    _log("trainer starting", model=config.name, layers=config.num_layers,
         params=config.num_params(), device=device, batch=batch_size,
         seq_len=seq_len, steps=args.steps)

    # The training flight recorder: a clock-anchored trace file and the
    # goodput ledger over it (flush_each: a killed run leaves its booked
    # ledger on disk).
    tracer = goodput = None
    if args.trace_jsonl:
        from ..utils.trace import GoodputRecorder, TraceWriter

        tracer = TraceWriter(args.trace_jsonl, "trainer:rank0",
                             clock=time.perf_counter)
        goodput = GoodputRecorder("train", clock=time.perf_counter,
                                  writer=tracer, flush_each=True)
        _log("trace jsonl", path=args.trace_jsonl)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    opt = make_optimizer(
        learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
        decay_steps=max(args.steps, args.warmup_steps + 1))
    t0 = time.perf_counter()
    state = init_state(config, opt, seed=0, device=device)
    step_fn = make_train_step(config, opt)
    init_s = time.perf_counter() - t0

    fpt = flops_per_token(config, seq_len)
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    peak = peak_bf16_tflops(device_name)  # 0 off the card: no MFU then
    tokens_per_step = batch_size * seq_len
    sync_every = max(args.log_every, 1)

    def on_sync(step, cur_state, window_losses, window_dt):
        tps = tokens_per_step * len(window_losses) / max(window_dt, 1e-9)
        fields = dict(step=step, loss=round(window_losses[-1], 4),
                      tokens_per_sec=round(tps, 1),
                      tflops=round(tps * fpt / 1e12, 2))
        if peak:
            fields["mfu"] = round(mfu(tps, config, seq_len, peak), 4)
        _log("train", **fields)

    batches = synthetic_batches(config.vocab_size, batch_size, seq_len)
    loop_step, step_category = step_fn, None
    if goodput is not None:
        first = [True]

        def loop_step(cur_state, batch):
            out = step_fn(cur_state, batch)
            if first[0]:
                # The first step builds the kernels: its span is the
                # compile segment the loop opened for it.
                first[0] = False
                t1 = goodput.clock()
                tracer.event("train.compile", goodput.state_since,
                             t1 - goodput.state_since,
                             first_step_s=round(t1 - goodput.state_since, 6))
            return out

        def step_category(n):
            return "compile" if n == 1 else "step"
    try:
        state, report = run_pipelined(
            loop_step, state, batches, sync_every=sync_every,
            max_steps=args.steps, tokens_per_step=tokens_per_step,
            config_name=config.name, on_sync=on_sync, goodput=goodput,
            goodput_step_category=step_category)
    finally:
        if goodput is not None:
            # Closing is what makes the categories tile the recorded
            # window exactly; it matters most on a run that dies.
            goodput.close()
            tracer.close()

    steady = report.windows[1:]  # the first window carries first-call setup
    s_steps = sum(n for n, _ in steady)
    s_secs = sum(dt for _, dt in steady)
    steady_tps = tokens_per_step * s_steps / s_secs if s_secs else None
    summary = dict(
        model=config.name, num_layers=config.num_layers,
        embed_dim=config.embed_dim, vocab_size=config.vocab_size,
        num_params=config.num_params(), precision=policy_of(config),
        remat=remat_policy_of(config), attention=config.attention,
        fused_ce=config.fused_ce, device=device_name, batch_size=batch_size,
        seq_len=seq_len, steps=report.steps, init_seconds=init_s,
        losses=report.losses,
        grad_norms=[h["grad_norm"] for h in report.history],
        windows=report.windows, wall_seconds=report.wall_seconds,
        tokens_per_sec=report.tokens_per_sec,
        steady_tokens_per_sec=steady_tps, flops_per_token=fpt,
        peak_bf16_tflops=peak,
        mfu=(mfu(steady_tps, config, seq_len, peak)
             if peak and steady_tps else None),
        peak_memory_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
        goodput=goodput.snapshot() if goodput is not None else None)
    if args.report_json:
        parent = os.path.dirname(os.path.abspath(args.report_json))
        os.makedirs(parent, exist_ok=True)
        with open(args.report_json, "w") as f:
            json.dump(summary, f, indent=1)
            f.write("\n")
    _log("trainer done", steps=report.steps,
         final_loss=round(report.losses[-1], 4) if report.losses else "n/a",
         steady_tokens_per_sec=(round(steady_tps, 1) if steady_tps
                                else "n/a"),
         mfu=(round(summary["mfu"], 4) if summary["mfu"] is not None
              else "not measured"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
