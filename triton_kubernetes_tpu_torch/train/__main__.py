"""Trainer entry point: ``python -m triton_kubernetes_tpu_torch.train``.

The single-process path of ``python -m triton_kubernetes_tpu.train``
(``train/__main__.py:main`` in the JAX package): build the model config
(``--model`` plus ``--model-opt K=V`` overrides, ``--precision``,
``--remat-policy``), initialise f32 masters from a seed, and train through
the resilient step-pipelined loop (``train/resilience.py``), logging loss,
tokens/s and MFU at every sync window. Data comes from the sharded token
pipeline when ``--data-dir`` is given (the native library when built,
else the Python path), else from the synthetic Markov generator, staged
onto the device ahead of the step by ``DevicePrefetch`` (``--prefetch``).
Runs on the card unless ``--device cpu`` is given (the plain versions of
the kernels then run instead, for rehearsals at small sizes).

The loop is the reference's resilient one: SIGTERM (the preemption
warning) syncs the window, writes a synchronous emergency checkpoint and
exits with ``EXIT_RESUME`` (75) so a restart policy resumes instead of
failing; ``--resume`` restores the newest verified step across
``--checkpoint-dir`` and ``--emergency-dir`` (a torn step is quarantined
and the restore falls back) and replays the data stream from that step;
``--anomaly-factor`` arms a loss guard that rolls back to the last good
checkpoint instead of training through a NaN, exiting ``EXIT_ANOMALY``
(4) when ``--max-rollbacks`` runs out. Bad flags, and a checkpoint whose
recorded mesh the fleet cannot hold under ``--elastic`` (its model axes
must divide the process count), exit ``EXIT_CONFIG`` (2).

**Across processes.** ``--distributed on`` (or ``auto`` with the
variables set) joins a ``torch.distributed`` world from the variables the
JobSet injects (``topology/jobset.py``): ``JAX_COORDINATOR_ADDRESS``
(host:port of rank 0), ``TPU_WORKER_ID`` (or ``JOB_COMPLETION_INDEX``) and
``NUM_TPU_WORKERS`` -- torch cannot discover a world size, so without it
the run exits ``EXIT_UNSUPPORTED`` (69) with a typed reason instead of
hanging, as it does when the device has no collectives backend (NCCL on
the card, gloo on the CPU; nothing falls back). Each process drives one
device: ``cuda:LOCAL_RANK`` where the pod runs one process a GPU of its
host (``GPUS_PER_HOST`` set, ``parallel/host_launch.py``), else
``cuda:rank``. The mesh flags ``--data`` (0 = the processes the
other axes leave), ``--stage``, ``--fsdp`` (-1 absorbs the rest),
``--seq``, ``--tensor`` lay the ranks out (``parallel/mesh.py``);
``--microbatches`` feeds GPipe under ``--stage``; ``--ring-attention``
takes ring attention on an unsplit sequence (a seq axis above 1 takes it
anyway). Under a world the step is the sharded one (the model's
placement, ``parallel/placement.py``) even at one rank, or with ``--dcn-sync fused`` (``auto`` under several
processes on a pure data-parallel mesh) the replica step with one
all-reduce (``parallel/multihost.make_fused_dcn_step``). Every rank reads
the same global stream and stages its own rows (under ``--stage``
its share of every global microbatch, as the reference's stage buffer
splits it); checkpoints are written
by rank 0 through ``CoordinatedCheckpoint``; the preemption stop is a
cross-process agreement; logs carry ``process=N`` and metrics
``process_id``; rank 0 writes the report (with ``n_processes``,
``dcn_sync`` and ``mesh``) and each rank its own ``--trace-jsonl``
(``.rankN`` before the extension). A batch the batch axes do not divide,
and a fused exchange asked for where it cannot run, exit ``EXIT_CONFIG``
(2). ``TK8S_TEST_CRASH_RANK=N`` makes rank N exit 3 at startup (the
launcher's fail-fast test); ``TK8S_TEST_CRASH_STEP=N`` makes the rank named
by ``TK8S_TEST_CRASH_STEP_RANK`` (default 0) exit 3 mid-run, at the first
sync window at or past ``start_step + N``, through ``os._exit`` -- no
``finally`` runs, as in a real crash (the chaos train arms' death).

``--expert`` is the expert-parallel degree of an MoE model (the Mixtral
family): under a world of that many processes or more, each rank holds
``E / expert`` experts and runs them on the slots they kept, every rank
routing the same tokens to the same global seats (``ops/moe.py``,
``parallel/placement.MeshRouting``); the partial outputs are summed over
the expert ranks (no ``all_to_all``). It is recorded in every
checkpoint's mesh section.

``--trace-jsonl PATH`` writes ``train.*`` spans and the goodput ledger (the
train categories partitioning the run's wall window) as JSON lines, as the
reference does: ``checkpoint`` across every save, ``rollback_replay``
across a restore and the steps it replays, ``preempted_lost`` from the
warning to exit, ``reshard`` for an elastic restore that changed shape.
One difference: the reference compiles its step ahead of time and books
that as ``compile`` with a ``train.compile`` span (lower_s/compile_s). The
port traces nothing: ``trainer.aot_compile_step`` builds and loads the
step's kernels (``compile_s``; ``lower_s`` is 0), and the first step runs
inside the same ``compile`` booking, which the ``train.compile`` span
covers (``first_step_s``); on the card that step is also the one
``memory_stats`` measures (published as ``tk8s_train_memory_bytes``).
``--compile-cache-dir`` points the kernels' build directory there
(``trainer.enable_compile_cache``; default
``triton_kubernetes_tpu_torch/_build/``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Optional

import torch

from dataclasses import dataclass
from typing import Mapping

from ..constants import (COORDINATOR_PORT, EXIT_ANOMALY, EXIT_CONFIG,
                         EXIT_UNSUPPORTED)


class DistributedEnvError(ValueError):
    """The JobSet-injected distributed variables are malformed (a
    non-integer worker id, an out-of-range rank, a coordinator address
    with no port). Raised before any rendezvous, so the operator gets one
    clean line instead of a hang or traceback."""


@dataclass(frozen=True)
class DistributedEnv:
    """Parsed multi-process identity (topology/jobset.py injects these;
    the local launcher in parallel/multihost.py injects the same)."""

    coordinator: str               # host:port of worker 0
    process_id: int                # this worker's rank
    num_processes: Optional[int]   # None = not given
    local_rank: Optional[int] = None  # the host's GPU; None = not given


def parse_distributed_env(
        environ: Optional[Mapping[str, str]] = None,
) -> Optional[DistributedEnv]:
    """Distributed identity from the environment, or None when no
    coordinator is advertised (single-process run).

    ``JAX_COORDINATOR_ADDRESS`` selects JobSet mode; the worker id comes
    from ``TPU_WORKER_ID`` falling back to ``JOB_COMPLETION_INDEX``
    falling back to 0; world size from ``NUM_TPU_WORKERS`` (0/unset = not
    given). Where ``GPUS_PER_HOST`` g is set, those name the host: a GPU
    pool's pod holds every GPU of its host and starts one process a GPU
    (``parallel/host_launch.py``), each with ``LOCAL_RANK`` j, which is
    rank ``worker * g + j`` of ``NUM_TPU_WORKERS * g`` and drives
    ``cuda:j``. Malformed values raise :class:`DistributedEnvError` --
    never a downstream hang."""
    env = os.environ if environ is None else environ
    coord = (env.get("JAX_COORDINATOR_ADDRESS") or "").strip()
    if not coord:
        return None
    _, sep, port = coord.rpartition(":")
    if not sep or not port.isdigit():
        raise DistributedEnvError(
            f"JAX_COORDINATOR_ADDRESS={coord!r} must be host:port "
            f"(the JobSet injects e.g. name-0.name.ns.svc:"
            f"{COORDINATOR_PORT})")
    wid_raw = (env.get("TPU_WORKER_ID") or "").strip() or (
        env.get("JOB_COMPLETION_INDEX") or "").strip() or "0"
    try:
        wid = int(wid_raw)
    except ValueError:
        raise DistributedEnvError(
            f"TPU_WORKER_ID/JOB_COMPLETION_INDEX={wid_raw!r} is not an "
            f"integer") from None
    if wid < 0:
        raise DistributedEnvError(f"TPU_WORKER_ID={wid} must be >= 0")
    num_raw = (env.get("NUM_TPU_WORKERS") or "").strip()
    num: Optional[int] = None
    if num_raw and num_raw != "0":
        try:
            num = int(num_raw)
        except ValueError:
            raise DistributedEnvError(
                f"NUM_TPU_WORKERS={num_raw!r} is not an integer") from None
        if num < 1:
            raise DistributedEnvError(
                f"NUM_TPU_WORKERS={num} must be >= 1")
        if wid >= num:
            raise DistributedEnvError(
                f"TPU_WORKER_ID={wid} out of range for "
                f"NUM_TPU_WORKERS={num}")
    per_host = _env_int(env, "GPUS_PER_HOST")
    if per_host is None:
        return DistributedEnv(coordinator=coord, process_id=wid,
                              num_processes=num)
    if per_host < 1:
        raise DistributedEnvError(f"GPUS_PER_HOST={per_host} must be >= 1")
    local = _env_int(env, "LOCAL_RANK")
    if local is None and per_host > 1:
        raise DistributedEnvError(
            f"GPUS_PER_HOST={per_host} without LOCAL_RANK: start the pod's "
            f"ranks through python -m "
            f"triton_kubernetes_tpu_torch.parallel.host_launch")
    local = local or 0
    if not 0 <= local < per_host:
        raise DistributedEnvError(
            f"LOCAL_RANK={local} out of range for GPUS_PER_HOST={per_host}")
    return DistributedEnv(
        coordinator=coord, process_id=wid * per_host + local,
        num_processes=None if num is None else num * per_host,
        local_rank=local)


def _env_int(env: Mapping[str, str], name: str) -> Optional[int]:
    """``env[name]`` as an integer, None when unset or blank."""
    raw = (env.get(name) or "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        raise DistributedEnvError(f"{name}={raw!r} is not an integer") \
            from None


def _maybe_init_distributed(mode: str, device_type: str, log) -> bool:
    """Join the world the JobSet variables describe; True when a process
    group is up. Raises :class:`DistributedEnvError` on malformed
    variables and ``parallel.multihost.MultiHostUnavailable`` (typed
    reason) when the environment cannot host the run: no world size
    (torch, unlike ``jax.distributed``, cannot discover one), or no
    collectives backend for the device (NCCL for the card, gloo for the
    CPU; nothing falls back)."""
    if mode == "off":
        return False
    denv = parse_distributed_env()
    if mode == "auto" and denv is None:
        return False
    import torch.distributed as dist

    from ..parallel.multihost import (REASON_NO_WORLD_SIZE,
                                      MultiHostUnavailable, backend_for,
                                      require_multihost)

    if denv is None or denv.num_processes is None:
        raise MultiHostUnavailable(
            "--distributed on needs JAX_COORDINATOR_ADDRESS and "
            "NUM_TPU_WORKERS: torch cannot discover a world size",
            REASON_NO_WORLD_SIZE)
    require_multihost(device_type)
    backend = backend_for(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(
            denv.local_rank if denv.local_rank is not None
            else denv.process_id % torch.cuda.device_count())
    log.log("info", "distributed init", backend=backend,
            coordinator=denv.coordinator, process_id=denv.process_id,
            num_processes=denv.num_processes, local_rank=denv.local_rank)
    dist.init_process_group(backend,
                            init_method=f"tcp://{denv.coordinator}",
                            rank=denv.process_id,
                            world_size=denv.num_processes)
    return True


def _distributed_shutdown() -> None:
    """Synchronized teardown on every exit path once a world is up: a
    barrier, so no rank leaves while a peer still needs it, then
    ``destroy_process_group``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    try:
        if dist.get_world_size() > 1:
            dist.barrier()
    # A peer crashed mid-barrier: exiting with our own rc is what is left.
    except Exception:
        pass
    try:
        dist.destroy_process_group()
    except Exception:
        pass


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
                        "fused_ce=true); values coerce like YAML scalars")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=0,
                   help="global batch (0 = the batch the newest "
                        "checkpoint recorded under --elastic, else 4: "
                        "4 per data*fsdp shard, one shard on one card)")
    p.add_argument("--seq-len", type=int, default=0,
                   help="0 = the model's max_seq_len")
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--data-dir", default="",
                   help="dir of *.bin token shards; empty = synthetic data")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="steps between saves (0 = only at the end)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--elastic", action="store_true",
                   help="negotiate the mesh shape from the newest "
                        "checkpoint manifest (schema v2 records the saved "
                        "mesh) instead of requiring the flags to match "
                        "it: the recorded model axes are kept and data "
                        "absorbs the fleet; a recorded block the process "
                        "count does not divide is a config error (exit "
                        "2); requires --resume to have any effect")
    p.add_argument("--emergency-dir", default="",
                   help="directory for preemption emergency checkpoints "
                        "(default: the checkpoint dir); --resume considers "
                        "both and restores the newest verified step")
    p.add_argument("--anomaly-factor", type=float, default=0.0,
                   help="loss-anomaly guard: roll back to the last good "
                        "checkpoint when a synced loss exceeds this factor "
                        "times the running median (NaN/Inf always trip); "
                        "0 disables the guard")
    p.add_argument("--max-rollbacks", type=int, default=3,
                   help="abort (exit 4) after this many consecutive "
                        "anomaly rollbacks without a clean window")
    p.add_argument("--skip-anomalous-window", action="store_true",
                   help="on anomaly rollback, resume the data stream after "
                        "the offending window instead of replaying it")
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
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace (Chrome JSON, "
                        "train_trace.json) of one steady sync window -- "
                        "the second; the first when the run has one -- "
                        "into this directory")
    p.add_argument("--sync-every", type=int, default=0,
                   help="steps between device->host metric syncs; also "
                        "the in-flight bound of the pipelined loop "
                        "(0 = --log-every)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="device-prefetch buffer depth (0 disables the "
                        "background producer and the staged host->device "
                        "copies)")
    p.add_argument("--compile-cache-dir", default="",
                   help="build the CUDA kernels into this directory "
                        "(default triton_kubernetes_tpu_torch/_build/); "
                        "libraries are keyed by their sources' hash, so "
                        "later runs reuse them")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--log-every", type=int, default=10,
                   help="steps between logs, which are the loop's "
                        "device->host syncs unless --sync-every is set")
    p.add_argument("--json-logs", action="store_true",
                   help="log one JSON object a line (ts, level, msg, "
                        "fields) on standard error")
    p.add_argument("--device-ms-per-row", type=float, default=0.0,
                   help="deterministic per-step device-time floor: this "
                        "many milliseconds per batch row, slept off "
                        "(remainder only -- real compute overlaps it) "
                        "before each dispatch; 0 = off")
    p.add_argument("--report-json", default="",
                   help="write a run report (per-step losses, grad "
                        "norms and MoE aux losses, window times, tokens/s, "
                        "MFU, peak memory, checkpoint and restore times, "
                        "the preemption outcome, kernel launches) to this "
                        "path")
    p.add_argument("--trace-jsonl", default="",
                   help="append train.* span events and the goodput "
                        "ledger (chip-time categories partitioning the "
                        "run's wall window) as JSON lines to this path; "
                        "merge with `python -m "
                        "triton_kubernetes_tpu_torch.tools.trace merge`")
    # Mesh axes: -1 absorbs remaining devices (at most one axis).
    p.add_argument("--data", type=int, default=0,
                   help="data-parallel axis; 0 = auto: 1 single-process, "
                        "under --distributed the processes the other axes "
                        "leave")
    p.add_argument("--stage", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=-1)
    p.add_argument("--seq", type=int, default=1)
    p.add_argument("--tensor", type=int, default=1)
    p.add_argument("--expert", type=int, default=1,
                   help="expert-parallel degree of an MoE model: each rank "
                        "holds E / expert experts (under --distributed); "
                        "recorded in the checkpoint's mesh section")
    p.add_argument("--microbatches", type=int, default=0,
                   help="pipeline microbatches (0 = stage count)")
    p.add_argument("--ring-attention", action="store_true",
                   help="sequence-parallel (ring) attention, also on an "
                        "unsplit sequence (a seq axis above 1 takes it "
                        "anyway)")
    p.add_argument("--distributed", choices=["auto", "on", "off"],
                   default="auto",
                   help="join a torch.distributed world from "
                        "JAX_COORDINATOR_ADDRESS, TPU_WORKER_ID and "
                        "NUM_TPU_WORKERS (auto: when they are set)")
    p.add_argument("--dcn-sync", choices=["auto", "fused", "xla"],
                   default="auto",
                   help="cross-process gradient exchange: 'fused' is one "
                        "all-reduce of every gradient per step "
                        "(parallel/multihost.make_fused_dcn_step; needs a "
                        "pure data-parallel mesh), 'xla' the sharded step's "
                        "per-leaf exchange, 'auto' fused whenever the mesh "
                        "allows it under several processes")
    p.add_argument("--dry-run", action="store_true",
                   help="build everything, run one step, exit")
    return p


def _batches(args, config, batch_size: int, seq_len: int):
    if args.data_dir:
        from .data import ShardedTokenPipeline

        return ShardedTokenPipeline(
            args.data_dir, batch_size, seq_len).batches()
    from .data import synthetic_batches

    return synthetic_batches(config.vocab_size, batch_size, seq_len)


def main(argv: Optional[list] = None) -> int:
    args = _build_parser().parse_args(argv)

    from ..utils.logging import Logger

    log = Logger(json_mode=args.json_logs)
    crash_rank = os.environ.get("TK8S_TEST_CRASH_RANK")
    if crash_rank is not None and crash_rank == os.environ.get(
            "TPU_WORKER_ID"):
        # Deterministic startup-death injection (tests only): a worker
        # lost before it joins the world, so its peers see the launcher's
        # fail-fast reap, not a burned timeout.
        log.log("error", "TK8S_TEST_CRASH_RANK: injected startup crash",
                rank=crash_rank)
        return 3
    from ..parallel.multihost import MultiHostUnavailable

    try:
        distributed = _maybe_init_distributed(
            args.distributed, torch.device(args.device).type, log)
    except DistributedEnvError as e:
        log.log("error", "malformed distributed environment", error=str(e))
        return EXIT_CONFIG
    except MultiHostUnavailable as e:
        # A loud, typed skip: the environment cannot host the run.
        log.log("error", "multi-process run unavailable; skipping",
                reason=e.reason, error=str(e))
        return EXIT_UNSUPPORTED
    try:
        return _train(args, log, distributed)
    finally:
        _distributed_shutdown()


def _train(args, log, distributed: bool) -> int:
    from ..models import get_config
    from ..models.llama import resolve_device
    from ..ops import flash_attention as fa
    from ..ops.moe import dispatch_mode_of
    from ..parallel import multihost
    from ..parallel.mesh import MeshConfig, create_mesh, describe_mesh
    from .checkpoint import (
        CheckpointManager, HostStaging, ReshapeError, mesh_spec_of,
        peek_newest_manifest, restore_newest_verified)
    from .data import DevicePrefetch
    from .mfu import flops_per_token, mfu, peak_bf16_tflops
    from .precision import apply_policy, policy_of, remat_policy_of
    from .resilience import (
        EXIT_RESUME, AnomalyAbortedError, LossAnomalyGuard, PreemptionGuard,
        negotiate_mesh_config, run_resilient)
    from .trainer import (
        aot_compile_step, batch_spec, enable_compile_cache, init_state,
        make_optimizer, make_train_step, memory_stats, publish_memory_stats)

    overrides = {}
    for item in args.model_opt:
        key, sep, value = item.partition("=")
        if not sep:
            raise SystemExit(f"--model-opt expects K=V, got {item!r}")
        overrides[key] = parse_scalar(value)
    if args.remat_policy:
        # The dedicated flag wins outright: it both selects the policy and
        # arms or disarms remat.
        overrides["remat_policy"] = args.remat_policy
        overrides["remat"] = args.remat_policy != "none"
    config = apply_policy(get_config(args.model, **overrides),
                          args.precision)
    device = resolve_device(args.device)
    n_processes, rank = 1, 0
    if distributed:
        import torch.distributed as dist

        n_processes, rank = dist.get_world_size(), dist.get_rank()
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    seq_len = args.seq_len or config.max_seq_len
    bad = [f"{flag} must be >= 0, got {value}" for flag, value in (
        ("--steps", args.steps), ("--batch-size", args.batch_size),
        ("--checkpoint-every", args.checkpoint_every),
        ("--sync-every", args.sync_every), ("--prefetch", args.prefetch),
        ("--max-rollbacks", args.max_rollbacks),
        ("--device-ms-per-row", args.device_ms_per_row)) if value < 0]
    if args.expert < 1:
        bad.append(f"--expert must be >= 1, got {args.expert}")
    if args.microbatches < 0:
        bad.append(f"--microbatches must be >= 0, got {args.microbatches}")
    if seq_len > config.max_seq_len:
        bad.append(f"--seq-len {seq_len} exceeds the model's max_seq_len "
                   f"{config.max_seq_len}")
    if bad:
        log.log("error", "bad flags", errors="; ".join(bad))
        return EXIT_CONFIG
    log.log("info", "precision policy", policy=policy_of(config),
            compute_dtype=config.dtype, param_dtype=config.param_dtype,
            remat=remat_policy_of(config), attention=config.attention,
            fused_ce=config.fused_ce)
    if args.compile_cache_dir:
        log.log("info", "persistent compile cache",
                dir=enable_compile_cache(args.compile_cache_dir))

    mesh_cfg = MeshConfig(
        data=args.data or (0 if n_processes > 1 else 1), stage=args.stage,
        fsdp=args.fsdp, seq=args.seq, expert=args.expert,
        tensor=args.tensor)
    # --elastic: the shape is negotiated from the newest manifest's
    # recorded mesh, not taken from the flags: the recorded model axes
    # are kept and the data axis absorbs the fleet; a recorded block the
    # fleet cannot hold is a typed config error.
    elastic_reshard = None
    elastic_batch = 0
    if args.elastic and args.resume and (
            args.checkpoint_dir or args.emergency_dir):
        peeked = peek_newest_manifest(
            args.checkpoint_dir or None, args.emergency_dir or None)
        saved_mesh = peeked[1].get("mesh") if peeked else None
        if saved_mesh is None:
            log.log("warn", "--elastic: no recorded mesh to negotiate "
                    "from (no checkpoint yet, or a format-1 manifest); "
                    "using the flag-derived shape")
        else:
            # The reference's rule keeps its ICI block (fsdp x seq x
            # expert x tensor) inside one process's devices. A port process
            # is one device and every axis spans processes, so the fleet is
            # given as one host of n devices: the recorded model axes must
            # divide it, and data absorbs the rest.
            try:
                negotiated = negotiate_mesh_config(
                    saved_mesh, n_processes=1, n_devices=n_processes)
            except ReshapeError as e:
                log.log("error", "elastic shape negotiation failed",
                        error=str(e))
                return EXIT_CONFIG
            if distributed:
                mesh_cfg = MeshConfig(**dataclasses.asdict(negotiated))
            elastic_batch = int(saved_mesh.get("global_batch") or 0)
            saved_shape = dict(saved_mesh.get("axes") or {})
            reshaped = (
                int(saved_mesh.get("n_devices") or 0) != n_processes
                or int(saved_mesh.get("n_processes") or 0) != n_processes)
            if reshaped:
                elastic_reshard = {
                    "step": int(peeked[0]), "from_axes": saved_shape,
                    "from_devices": int(saved_mesh.get("n_devices") or 0),
                    "from_processes": int(
                        saved_mesh.get("n_processes") or 0),
                    "to_devices": n_processes, "to_processes": n_processes}
            log.log("info", "elastic mesh negotiated",
                    saved_axes=saved_shape, negotiated=repr(negotiated),
                    reshaped=reshaped, step=int(peeked[0]))
    # The mesh: under a world, every process a device of it (a world of
    # one included); a single process runs the one-device step, whose
    # only mesh is one device.
    mesh = None
    if distributed:
        if n_processes > 1:
            # Rank-tag every log line and tk8s_train_* series.
            from ..utils import metrics as _metrics_mod

            log.bind(process=rank)
            _metrics_mod.set_default_labels(process_id=str(rank))
        try:
            mesh = multihost.create_hybrid_mesh(
                multihost.default_mesh_config(mesh_cfg, n_processes),
                device_type=device.type)
        except multihost.MeshPlacementError as e:
            log.log("error", "mesh placement rejected", error=str(e))
            return EXIT_CONFIG
        batch_shards = mesh.shape["data"] * mesh.shape["fsdp"]
    else:
        try:
            mesh_cfg.resolve(1)
        except ValueError as e:
            log.log("error", "mesh rejected: one process drives one device "
                    "(--distributed for more)", error=str(e))
            return EXIT_CONFIG
        batch_shards = 1
    mesh_desc = describe_mesh(mesh) if mesh is not None \
        else "mesh(single-device)"
    batch_size = args.batch_size or elastic_batch or 4 * batch_shards
    log.log("info", "trainer starting", model=config.name,
            layers=config.num_layers, params=config.num_params(),
            device=str(device), mesh=mesh_desc, processes=n_processes,
            batch=batch_size, seq_len=seq_len, steps=args.steps)
    if batch_size % batch_shards:
        log.log("error", "global batch must divide the data*fsdp axes",
                batch=batch_size, shards=batch_shards)
        return EXIT_CONFIG
    stages = mesh.shape["stage"] if mesh is not None else 1
    if stages > 1:
        m = args.microbatches or stages
        if batch_size % m or (batch_size // m) % batch_shards:
            log.log("error",
                    "batch/microbatches must divide the data*fsdp axes "
                    "under pipeline stages",
                    batch=batch_size, microbatches=m, shards=batch_shards)
            return EXIT_CONFIG
    if mesh is not None and seq_len % mesh.shape["seq"]:
        log.log("error", "--seq-len must divide the seq axis",
                seq_len=seq_len, seq=mesh.shape["seq"])
        return EXIT_CONFIG

    # The training flight recorder: a clock-anchored trace file and the
    # goodput ledger over it (flush_each: a killed run leaves its booked
    # ledger on disk).
    tracer = goodput = None
    if args.trace_jsonl:
        from ..utils.trace import GoodputRecorder, TraceWriter

        trace_path = args.trace_jsonl
        if n_processes > 1:  # every rank its own file
            root, ext = os.path.splitext(trace_path)
            trace_path = f"{root}.rank{rank}{ext or '.jsonl'}"
        tracer = TraceWriter(trace_path, f"trainer:rank{rank}",
                             clock=time.perf_counter)
        goodput = GoodputRecorder("train", clock=time.perf_counter,
                                  writer=tracer, flush_each=True)
        log.log("info", "trace jsonl", path=trace_path)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    opt = make_optimizer(
        learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
        decay_steps=max(args.steps, args.warmup_steps + 1))
    attention_fn = None
    if args.ring_attention and (mesh is None or mesh.shape["seq"] == 1):
        # A seq axis above 1 takes the ring anyway (trainer.
        # _resolve_attention); this is the ring on an unsplit sequence: one
        # block, the reference's train/__main__.py:564-569.
        from ..ops.ring_attention import make_ring_attention

        ring = make_ring_attention(mesh or create_mesh(
            MeshConfig(fsdp=1), world=1, device_type=device.type))
        attention_fn = lambda q, k, v, positions: ring(q, k, v)  # noqa
    # The gradient exchange: under several processes a pure data-parallel
    # mesh takes the fused step (one all-reduce a step); everything it
    # cannot honour blocks it, loudly when it was asked for.
    dcn_sync = "xla"
    if args.dcn_sync != "xla" and n_processes > 1:
        blockers = []
        if attention_fn is not None:
            blockers.append("--ring-attention (the fused step computes the "
                            "model's own attention)")
        if args.microbatches > 1:
            blockers.append("--microbatches > 1 (the fused step takes one "
                            "backward per step)")
        if not multihost.supports_fused_dcn(mesh):
            blockers.append("a non-pure-data-parallel mesh (every non-data "
                            "axis must be 1)")
        if not blockers:
            dcn_sync = "fused"
        elif args.dcn_sync == "fused":
            log.log("error", "fused DCN sync unavailable: "
                    + "; ".join(blockers), mesh=mesh_desc)
            return EXIT_CONFIG
    if n_processes > 1:
        log.log("info", "dcn gradient sync", mode=dcn_sync)
    t0 = time.perf_counter()
    if dcn_sync == "fused":
        # Replicas: every rank holds the whole model.
        state = init_state(config, opt, seed=0, device=device)
        step_fn = multihost.make_fused_dcn_step(config, mesh, opt)
    else:
        state = init_state(config, opt, seed=0, device=device, mesh=mesh)
        kw = {} if mesh is None else dict(mesh=mesh,
                                          microbatches=args.microbatches)
        if attention_fn is not None:
            kw["attention_fn"] = attention_fn
        step_fn = make_train_step(config, opt, **kw)
    init_s = time.perf_counter() - t0

    # Every save records the run's shape (manifest v2): the mesh's axes,
    # the process count, and the global batch the data stream is cut for.
    # The two managers share one pinned staging, so the process pins one
    # checkpoint's bytes at most; under several processes rank 0 writes
    # (CoordinatedCheckpoint).
    live_spec = mesh_spec_of(
        mesh if mesh is not None else {"expert": args.expert},
        n_processes=n_processes, global_batch=batch_size)
    staging = HostStaging()
    ckpt = em_ckpt = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir, mesh_spec=live_spec,
                                 staging=staging)
    if args.emergency_dir and (
            ckpt is None
            or os.path.abspath(args.emergency_dir) != ckpt.directory):
        em_ckpt = CheckpointManager(args.emergency_dir, mesh_spec=live_spec,
                                    staging=staging)
    if n_processes > 1:
        if ckpt is not None:
            ckpt = multihost.CoordinatedCheckpoint(ckpt)
        if em_ckpt is not None:
            em_ckpt = multihost.CoordinatedCheckpoint(em_ckpt)
    start_is_checkpointed = False
    resumed = None
    if args.resume and (ckpt is not None or em_ckpt is not None):
        # A resume restore is recovery work: booked rollback_replay, or
        # reshard when --elastic changed the shape.
        restore_cat = ("reshard" if elastic_reshard is not None
                       else "rollback_replay")
        t_restore = time.perf_counter()
        if goodput is not None:
            goodput.transition(restore_cat)
        try:
            state, best, best_step = restore_newest_verified(
                state, ckpt, em_ckpt)
        except FileNotFoundError:
            pass  # nothing saved yet: a fresh start under --resume is fine
        else:
            start_is_checkpointed = best is ckpt
            resumed = dict(best.restore_stats[-1], source=best.directory,
                           emergency=best is em_ckpt)
            if elastic_reshard is not None:
                elastic_reshard["seconds"] = round(
                    time.perf_counter() - t_restore, 6)
                if tracer is not None:
                    tracer.event("train.reshard", goodput.clock(),
                                 step=int(state.step), **{
                                     k: v for k, v in elastic_reshard.items()
                                     if k not in ("from_axes", "step")})
            if tracer is not None:
                tracer.event("train.restore", goodput.clock(),
                             step=int(state.step), rollback=False)
            log.log("info", "resumed", step=int(state.step),
                    source=best.directory, emergency=best is em_ckpt,
                    seconds=round(time.perf_counter() - t_restore, 3))
        if goodput is not None:
            goodput.transition("idle")

    fpt = flops_per_token(config, seq_len)
    # The dispatch an MoE layer runs at this step's token count.
    moe_dispatch = (dispatch_mode_of(
        config.moe_dispatch, batch_size * seq_len, config.num_experts,
        config.num_selected, config.capacity_factor)
        if config.is_moe else None)
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    peak = peak_bf16_tflops(device_name)  # 0 off the card: no MFU then
    tokens_per_step = batch_size * seq_len
    start_step = int(state.step)
    max_steps = max(args.steps - start_step, 0)
    if args.dry_run:
        max_steps = min(max_steps, 1)
    target_step = start_step + max_steps
    sync_every = 1 if args.dry_run else \
        max(args.sync_every or args.log_every, 1)
    # The floor scales with the rows THIS rank computes.
    local_rows = (multihost.local_batch_rows(mesh, batch_spec(), batch_size,
                                             args.microbatches)
                  if mesh is not None else batch_size)
    step_floor = args.device_ms_per_row * local_rows / 1e3
    place = (multihost.make_batch_placer(mesh, batch_spec(),
                                         args.microbatches)
             if mesh is not None else None)

    # The resilient driver rebuilds the stream at a rolled-back or resumed
    # step by deterministic replay: same source, same seed, skip to the
    # step index.
    live = {"pf": None}

    def make_batches(start: int):
        gen = _batches(args, config, batch_size, seq_len)
        if start:
            log.log("info", "skipping consumed batches", count=start)
            for _ in range(start):
                next(gen)
        host = ({"tokens": b["tokens"]} for b in gen)
        if place is not None:
            # Every rank runs the same global stream and stages only its
            # own rows.
            host = (place(b) for b in host)
        if args.prefetch > 0:
            pf = DevicePrefetch(host, device=device,
                                buffer_size=args.prefetch)
            live["pf"] = pf
            return pf, pf
        live["pf"] = None
        return host, None

    # The first step builds and warms the kernels: it is booked compile,
    # and on the card it is the step memory_stats measures.
    first = {"pending": True, "memory": None}
    window_metrics: list = []

    def loop_step(cur_state, batch):
        if not first["pending"]:
            out = step_fn(cur_state, batch)
            window_metrics.append(out[1])
            return out
        first["pending"] = False
        prev = goodput.state if goodput is not None else None
        t1 = time.perf_counter()
        if goodput is not None:
            goodput.transition("compile", t1)
        _, timings = aot_compile_step(step_fn, cur_state, batch,
                                      config_name=config.name)
        mem, cur_state, metrics = memory_stats(step_fn, cur_state, batch)
        t2 = time.perf_counter()
        if goodput is not None:
            tracer.event("train.compile", t1, t2 - t1,
                         lower_s=timings.lower_seconds,
                         compile_s=round(timings.compile_seconds, 6),
                         first_step_s=round(t2 - t1, 6))
            goodput.transition(prev, t2)
        fields = {}
        if mem is not None:
            publish_memory_stats(mem, config.name)
            first["memory"] = dict(dataclasses.asdict(mem),
                                   peak_bytes=mem.peak_bytes)
            fields = dict(temp_mib=round(mem.temp_bytes / 2**20, 1),
                          peak_mib=round(mem.peak_bytes / 2**20, 1))
        log.log("info", "train step compiled",
                compile_s=round(timings.compile_seconds, 3),
                cache_dir=timings.cache_dir or "",
                first_step_s=round(t2 - t1, 3), **fields)
        window_metrics.append(metrics)
        return cur_state, metrics

    sync_windows: list = []
    grad_norms: dict = {}
    aux_losses: dict = {}
    last_loss = None  # None until the first sync: never log a fake NaN
    profiler = {"prof": None, "done": False}

    def start_profile():
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        profiler["prof"] = profile(activities=acts)
        profiler["prof"].__enter__()
        log.log("info", "profiler tracing", dir=args.profile_dir)

    def stop_profile():
        prof, profiler["prof"] = profiler["prof"], None
        if prof is None:
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.__exit__(None, None, None)
        profiler["done"] = True
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(args.profile_dir, "train_trace.json"))
        log.log("info", "profiler trace written", dir=args.profile_dir)

    # Mid-run death injection (the chaos train arms): the named rank
    # hard-exits at the first sync window >= start_step + N -- rank 0
    # models coordinator loss, any other rank a plain worker death.
    crash_step_env = os.environ.get("TK8S_TEST_CRASH_STEP")
    crash_step = int(crash_step_env) if crash_step_env else None
    crash_step_rank = os.environ.get("TK8S_TEST_CRASH_STEP_RANK", "0")

    def on_sync(gstep, cur_state, window_losses, window_dt):
        nonlocal last_loss
        if crash_step is not None \
                and gstep >= start_step + crash_step \
                and str(rank) == crash_step_rank:
            log.log("error",
                    "TK8S_TEST_CRASH_STEP: injected mid-run death",
                    step=gstep, rank=crash_step_rank)
            # os._exit on purpose: a real crash runs no finally blocks.
            os._exit(3)
        n = len(window_losses)
        # The window's grad norms and MoE aux losses: the loop's sync
        # already drained these steps, so this small transfer does not
        # wait on the card.
        norms, auxs = torch.stack([
            torch.stack([torch.as_tensor(m[key]).float()
                         for m in window_metrics[-n:]])
            for key in ("grad_norm", "aux_loss")]).tolist()
        window_metrics.clear()
        for i, (g, a) in enumerate(zip(norms, auxs)):
            grad_norms[gstep - n + 1 + i] = g
            aux_losses[gstep - n + 1 + i] = a
        wait = live["pf"].wait_seconds if live["pf"] is not None else None
        sync_windows.append((n, window_dt, wait))
        last_loss = window_losses[-1]
        tps = tokens_per_step * n / max(window_dt, 1e-9)
        fields = dict(step=gstep, loss=round(last_loss, 4),
                      tokens_per_sec=round(tps, 1),
                      tflops=round(tps * fpt / 1e12, 2))
        if peak:
            fields["mfu"] = round(mfu(tps, config, seq_len, peak), 4)
        if wait is not None:
            fields["prefetch_wait_s"] = round(wait, 4)
        log.log("info", "train", **fields)
        if args.profile_dir and not profiler["done"]:
            if profiler["prof"] is not None:
                stop_profile()
            elif gstep < target_step:
                start_profile()  # the next window: the first steady one

    def on_checkpoint(gstep, kind):
        msg = ("emergency checkpoint saved" if kind == "emergency"
               else "checkpoint saved")
        log.log("info" if kind != "emergency" else "warn", msg, step=gstep)

    guard = (LossAnomalyGuard(factor=args.anomaly_factor)
             if args.anomaly_factor > 0 else None)
    preempt = (multihost.SyncedPreemptionGuard() if n_processes > 1
               else PreemptionGuard())
    try:
        preempt.install()
    except ValueError:  # not the main thread (embedded run): unguarded
        preempt = None

    report = None
    aborted = None
    run_t0 = time.perf_counter()

    def steady_tokens_per_sec() -> Optional[float]:
        steady = sync_windows[1:]  # the first window carries the build
        secs = sum(dt for _, dt, _ in steady)
        return (tokens_per_step * sum(n for n, _, _ in steady) / secs
                if secs else None)

    def write_report(outcome: str) -> None:
        if not args.report_json or rank != 0:
            return
        wall = max(time.perf_counter() - run_t0, 1e-9)
        steps_done = report.steps if report is not None else 0
        losses = list(report.losses) if report is not None else []
        steady_tps = steady_tokens_per_sec()
        data = dict(
            schema=1, model=config.name, num_layers=config.num_layers,
            embed_dim=config.embed_dim, vocab_size=config.vocab_size,
            num_params=config.num_params(),
            active_params=config.active_params(), expert=args.expert,
            moe_dispatch=moe_dispatch, precision=policy_of(config),
            remat=remat_policy_of(config), attention=config.attention,
            fused_ce=config.fused_ce, device=device_name,
            n_processes=n_processes, devices=n_processes, mesh=mesh_desc,
            mesh_axes=dict(mesh.shape) if mesh is not None else None,
            dcn_sync=dcn_sync, ring_attention=attention_fn is not None,
            microbatches=args.microbatches,
            global_batch=batch_size, batch_size=batch_size,
            seq_len=seq_len, device_ms_per_row=args.device_ms_per_row,
            start_step=start_step, target_step=target_step,
            steps=steps_done, init_seconds=init_s, losses=losses,
            grad_norms=[grad_norms.get(start_step + 1 + i)
                        for i in range(len(losses))],
            aux_losses=[aux_losses.get(start_step + 1 + i)
                        for i in range(len(losses))],
            sync_points=report.sync_points if report is not None else 0,
            rollbacks=report.rollbacks if report is not None else 0,
            interrupted=bool(report is not None and report.interrupted),
            emergency_step=(report.emergency_step
                            if report is not None else None),
            windows=[(n, dt) for n, dt, _ in sync_windows],
            prefetch_wait_seconds=[w for _, _, w in sync_windows],
            wall_seconds=wall, steps_per_sec=steps_done / wall,
            tokens_per_sec=steps_done * tokens_per_step / wall,
            steady_tokens_per_sec=steady_tps, flops_per_token=fpt,
            peak_bf16_tflops=peak,
            mfu=(mfu(steady_tps, config, seq_len, peak)
                 if peak and steady_tps else None),
            peak_memory_bytes=(torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None),
            memory=first["memory"], outcome=outcome,
            elastic=bool(args.elastic), reshard=elastic_reshard,
            resumed=resumed,
            checkpoints=[s for m in (ckpt, em_ckpt) if m is not None
                         for s in m.save_stats],
            kernel_launches=dict(fa.flash_attention.launches),
            goodput=goodput.snapshot() if goodput is not None else None)
        parent = os.path.dirname(os.path.abspath(args.report_json))
        os.makedirs(parent, exist_ok=True)
        tmp = args.report_json + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
            f.write("\n")
        os.replace(tmp, args.report_json)
        log.log("info", "run report written", path=args.report_json)

    try:
        if max_steps:
            if args.profile_dir and max_steps <= sync_every:
                start_profile()  # one window: trace it whole
            try:
                state, report = run_resilient(
                    loop_step, state, make_batches,
                    ckpt=ckpt, emergency_ckpt=em_ckpt or ckpt,
                    target_step=target_step, start_step=start_step,
                    sync_every=sync_every,
                    checkpoint_every=(args.checkpoint_every if ckpt else 0),
                    guard=guard, max_rollbacks=args.max_rollbacks,
                    skip_anomalous_window=args.skip_anomalous_window,
                    start_is_checkpointed=start_is_checkpointed,
                    preemption=preempt, tokens_per_step=tokens_per_step,
                    config_name=config.name, on_sync=on_sync,
                    on_checkpoint=on_checkpoint,
                    step_floor_seconds=step_floor, goodput=goodput)
            except AnomalyAbortedError as e:
                aborted = e
                log.log("error", "anomaly guard aborted the run",
                        error=str(e), step=e.anomaly.step,
                        reason=e.anomaly.reason)
            else:
                if report.rollbacks:
                    log.log("warn", "anomaly rollbacks taken",
                            rollbacks=report.rollbacks,
                            restored_steps=report.restored_steps)
                if report.steps < max_steps and not report.interrupted:
                    log.log("warn", "data exhausted before requested steps",
                            done=start_step + report.steps, want=args.steps)
    finally:
        if live["pf"] is not None:
            live["pf"].close()
        stop_profile()
        if preempt is not None:
            preempt.uninstall()
        if goodput is not None:
            # Closing is what makes the categories tile the recorded
            # window exactly; it matters most on a run that dies.
            goodput.close()
            tracer.close()

    final_loss = round(last_loss, 4) if last_loss is not None else "n/a"
    if aborted is not None:
        # The live state trained into the failed window: no final save --
        # the last good checkpoint is the artifact.
        for mgr in (ckpt, em_ckpt):
            if mgr is not None:
                mgr.close()
        write_report("anomaly-abort")
        log.log("info", "trainer done", final_loss=final_loss,
                outcome="anomaly-abort")
        return EXIT_ANOMALY
    if report is not None and report.interrupted:
        # Preemption warning honoured: the emergency checkpoint is
        # committed; exit with the resume code.
        for mgr in (ckpt, em_ckpt):
            if mgr is not None:
                mgr.close()
        log.log("warn", "trainer preempted; exiting for resume",
                step=start_step + report.steps,
                emergency_step=report.emergency_step,
                exit_code=EXIT_RESUME)
        write_report("preempted")
        log.log("info", "trainer done", final_loss=final_loss,
                outcome="preempted")
        return EXIT_RESUME
    if ckpt:
        if ckpt.latest_step() != int(state.step):
            ckpt.save(int(state.step), state, wait=True, kind="final")
            log.log("info", "final checkpoint", step=int(state.step))
        ckpt.close()
    if em_ckpt is not None:
        em_ckpt.close()
    write_report("ok")
    steady_tps = steady_tokens_per_sec()
    log.log("info", "trainer done", final_loss=final_loss,
            steps=report.steps if report is not None else 0,
            mfu=(round(mfu(steady_tps, config, seq_len, peak), 4)
                 if peak and steady_tps else "not measured"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
