#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (``triton_kubernetes_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and runs these phases in
order; any failure raises and the script exits non-zero without printing a
result. Each phase (and each part of phase 4) prints its seconds on a line
of its own, ``phase: NAME S s``, the last ``phase: total``: the whole run
must stay within 750 s of its 1,200 s limit.

1. card   -- requires CUDA; prints ``nvidia-smi``'s name and power limit;
2. build  -- compiles the nine kernel sources of ``csrc/`` (paged
   decode, verify and prefill, each for bf16/f32 queries over bf16/f32,
   int8 and fp8 pages; flash forward, dQ and dK/dV; the row-invariant
   decode GEMM, with its W8A8 int8/fp8 entries, and RMSNorm, with its
   fused residual add and its quantizing epilogue; the per-token quantizer
   of the W8A8 products and its fused SwiGLU) with
   ``nvcc`` for ``sm_90a``, all at once (the decode GEMM in five
   translation units, the prefill and verify kernels in three), and
   prints the seconds and what ``ptxas`` reports; beside it, the health
   probe of the GPU provisioning twins (``topology/daemonsets.py``): the
   readiness command rendered for this host's GPU count must exit 0, and
   the one rendered for one GPU more must not;
3. kernels -- each kernel against its plain PyTorch version at Llama-3-8B
   shapes (Hq 32, Hkv 8, D 128, bf16 queries; paged: bs 16, 128 pages per
   sequence, on bf16, int8 and fp8 pages; verify at B 8, S 4; flash:
   (B, S) = (4, 2048), (1, 1000), (1, 1280), (1, 4096), plus one case
   for each other design of the three flash kernels -- tensor cores at D
   64, CUDA cores at D 96; each flash kernel, dQ included, runs its
   tensor-core design at the 8B heads), with its time, the plain
   version's, one ``scaled_dot_product_attention`` call's as a yardstick
   (the port never calls it), the card's bound for the same work, the
   share of it reached and the TFLOP/s achieved; and every verify row
   ``torch.equal`` to the decode kernel at that row's length, on every
   page kind, also at lengths whose rows straddle an edge of the span
   walk (decode and verify run their tensor-core design there, the one
   ``_kernels.PAGED_TENSOR_CORE`` names for bf16 queries at D 128, bs
   16). The prefill kernel must run its tensor-core design on all three
   page kinds (the variant code its C entry received is recorded), and
   its rows 256-511 of a 512-token window at offset 0 must be
   ``torch.equal`` to a 256-token window at offset 256. The decode GEMM
   at each of the 8B model's launches, one a group of products of one
   input (K x N: wq+wk+wv 4096 x (4096 + 1024 + 1024), wo 4096 x 4096,
   w3+w1 4096 x (14336 + 14336), w2 14336 x 4096, and the lm head
   4096 x 128256 in f32; its K split reported) and the RMSNorm at D
   4096, at M 8 (a decode tick) and 32 (a verify tick): against their
   plain versions (``torch.mm`` of each weight in turn; the plain norm),
   with one library call each as a yardstick (``torch.mm`` on the
   group's weights concatenated; ``torch.nn.functional.rms_norm``), rows
   at M 1, 8 and 32 ``torch.equal`` to the kernel's rows at M 64, times
   beside the weight-bytes bound; the plain torch ops' rows at every M
   of 1-64 against their own at M 64, reported; the GEMM at a prefill
   window's M 256 too, against its plain version, each 64-row tile of the
   launch ``torch.equal`` to a launch of its rows alone, and every row of
   one launch at M 65, 100, 128, 192 and 256 (the wgmma kernel)
   ``torch.equal`` to the same row through launches of 64 rows (the
   mma.sync kernel); the wgmma kernel's record is the five groups at M
   256. Before them, the bit probe: a chain of 8 wgmma k steps against
   the same chain of mma.sync steps on the same shared tiles and
   accumulator, bf16, e4m3 and int8 operands over wide exponent ranges,
   with C 0 and with cancelling products; int8, and every kind whose
   windows rely on the agreement, must agree bit for bit. The fused residual add +
   RMSNorm at D 4096, bf16 at M 1, 8, 32, 64 and 256 (a lone sequence, a
   decode tick, a verify tick, a GEMM launch, a prefill window) and f32
   at M 8: h and y ``torch.equal`` to torch's ``x + delta`` and the
   delta-null norm on it, rows bitwise the rows at M 64, y within one
   ulp of its plain version; timed beside the plain version,
   ``F.rms_norm(x + delta)`` (two library calls), the delta-null kernel,
   ``F.rms_norm`` alone and the bytes bound. The W8A8 kernels: first the
   SiLU probe (every bf16 bit pattern through the fused SwiGLU kernel's
   SiLU and torch's; 0 may differ, since the kernel computes the SiLU);
   kernel A, the per-token quantizer, in its three forms -- standalone
   (wo's input) at K 4096 and 14336, as the epilogue of the norm's
   delta-null and fused entries at D 4096, and fused with the SwiGLU at
   F 14336 -- at M 1, 8, 32, 256, bf16 and f32 input, int8 and fp8:
   bytes, scales (and h) ``torch.equal`` to the producer followed by
   ``quantize_rows_plain``, rows bitwise the rows at M 64, timed at M 8,
   32 and 256 beside the plain version and the bytes bound;
   kernel B, the W8A8 entries of the decode GEMM, at the
   five 8B groups (weights quantized per column, stored [N, K]) at M 8,
   32 and 256: int8 ``torch.equal`` to its plain version, fp8 within one
   bf16 ulp, rows at M 1, 8 and 32 bitwise the rows of a 64-row launch,
   each 64-row tile of the 256-row launch bitwise a launch of its rows
   alone, rows at M 65-256 as the bf16 GEMM's (wgmma records too); timed beside the bytes bound and ``torch._int_mm`` /
   ``torch._scaled_mm`` as yardsticks (at M 8 on 17 / 16 rows, the least
   each takes);
4. serve  -- ``llama3-8b`` at full width and depth (random bf16 weights
   from a seed). First the F1 probe: one verify tick's layer input
   [8, 4, 4096] through each row op of layer 0 and of the head (the norms,
   wq/wk/wv alone and as the one launch the step makes, wo, w3/w1 alone
   and as one launch, w2, the f32 lm head), once on its 32 rows and once
   on each of its four 8-row slices, by the plain torch ops and by the
   row-invariant kernels; prints which are bitwise row for row and
   asserts the kernels' are. Then the direct check: 8 prefilled
   sequences, one ``paged_verify_step`` of 4 tokens each against four
   ``paged_decode_step`` s fed the same tokens; every logits row and the
   two pools after must be ``torch.equal``; and the first decode tick's
   and the verify tick's logits ``torch.equal`` to the same ticks
   composed unfused (torch's add, then the delta-null norm, at every
   layer boundary). Then ``ServeEngine``,
   chunked prefill with the prefix cache, 8 requests; checks
   completions, pool drain, prefix hits and that the paged kernels'
   launch counters rose by exactly (windows x layers) and (decode ticks x
   layers), the decode GEMM's by (ticks + windows) x (4 x layers + 1), the
   delta-null norm's by (ticks + windows) and the fused add + norm's by
   (ticks + windows) x 2 x layers; prints TTFT, TPOT, tokens/s and tick
   times;
   cross-checks one greedy request's first-token logits against the plain
   versions (and an engine forced onto them); profiles one 256-token
   prefill window of a lone 1,000-token prompt, a few decode ticks and two
   verify ticks of a spec_k 3 engine (device busy time and kernels by
   class, idle share, launches per tick, the paged kernels by name, which
   must include the span kernels and the prefill's tensor-core kernel;
   the window must launch the wgmma GEMM, counted by its wrapper;
   the decode tick and the window must run 2 x layers + 1 norm kernels;
   those two are profiled again, up to three times, while a trace holds
   fewer device kernels than launches: the profiler drops events at times).
   Then six more runs of those 8 requests plus 4 repetitive ones (one
   seeded token tiled 300-700 times, so the model repeats itself and the
   drafter fires): bf16, int8 and fp8 pools, each
   with ``spec_k`` 0 and 3, one pool freed before the next. Each checks
   completions, drain, drafts where speculating, a finite quant error on
   8-bit pools and every kernel's launches = (ticks that ran it x layers),
   and prints TTFT, TPOT, tokens/s, accept rate, tokens per sequence per
   verify, quant error, pool bytes against bf16's and how many tokens
   equal the spec-off run of its pool kind -- asserted: all of them,
   since a verify row is bitwise the decode row (fault F1 of ROADMAP.md).
   The 8-bit kernels' first-token logits are held to their plain versions
   on the same pool kind. Then tracing and migration, on those 12 requests
   with those runs as the baselines: the bf16 runs at spec_k 0 and 3 again
   with a ``FlightRecorder`` writing a JSONL trace and a serve
   ``GoodputRecorder`` (tokens and every kernel's launches equal to the
   untraced run's, each request's phases summing to its e2e within 1e-9 s,
   the goodput categories to the recorder's wall within 1e-6 s, the trace
   passing the goodput partition check and, merged, the Chrome-trace
   validator; the wall per tick traced against untraced, the useful share
   and the category seconds printed); then two engines of 2,048 pages each
   on the card: handoff in every pool kind at spec_k 0 and 3 but int8 at
   spec_k 3, which the HTTP phase's arm B hands off (each request
   finishes "handoff" after its first token on the source, is exported,
   imported into the destination and released, and decodes there to the
   end: its stream must equal the baseline's, every token), the prefix check
   (a request sharing only r0's 512-token prefix served on the destination
   first, then r0 imported: 32 pages mapped by reference, the rest written
   as shipped, the baseline's tokens), drains on bf16 pages at spec_k 3
   and int8 at spec_k 0 (after 8 decode ticks every exportable session
   moves; both engines run to the end, every token), and in the first drain a
   torn transfer (a bit flipped in the middle of the pages, a copy cut
   there: each refused with ``TornPayloadError``, the destination's pool
   ``torch.equal`` to before and its pages in use unchanged, the session
   then resumed on the source to the baseline's tokens) -- the handoffs
   and drains on every other request of the 12 (4 base, 2 repetitive),
   each held to the whole run's tokens; a ``migration
   JSON line gives payload bytes, export and import ms and GB/s and
   sha256 alone, by pool kind. Then HTTP serving on the same 12 requests
   (``http_phase``): A, the 12 fired at once at one ``ServeHTTPServer``
   replica behind a ``RouterHTTPServer``, then at two replicas in this
   process sharing the weights (a 2,048-page bf16 pool each), then a seeded
   Poisson open loop (2 requests/s, 8 requests of 200-1,000 prompt tokens,
   16 new) through the two; B, a prefill and a decode replica (int8 pools,
   spec_k 3) behind a router with a decode pool, every request handed off
   over ``/migrate``; C, two ``python -m
   triton_kubernetes_tpu_torch.tools.serve`` processes and a ``tools.route``
   over them, their argv the rendered serve and route Deployments'
   (``topology/serving.py``) plus the arguments it logs, the 12 at once
   and the same open loop, then SIGTERM (exit
   143, every trace file closed). A's and B's tokens must equal the
   engine-level bf16 spec_k 0 and int8 spec_k 3 runs, every token; every
   response 200 and no engine loop dead; kernels 4 and 5 (6 in B), the GEMM
   and the fused norm launched in every arm (C's from each replica's
   ``/stats``); TTFT, TPOT, the client's latency, the time outside the
   engine and tokens/s printed per run, B's transfer histogram from a
   ``/metrics`` scrape. A rewind probe per bf16 and int8 pool verifies
   junk drafts on one prefilled sequence, rewinds all but the first, and
   checks every rejected slot and scale byte-equal to the pre-verify pool.
   Fault F2: one 800-token prompt prefilled under ``prefill_chunk`` 128
   and 256 on fresh bf16 pools must leave every full page bitwise equal,
   its windows' products on the wgmma GEMM (launches counted, asserted
   above 0; the windows' cuBLAS products before the repair are run too,
   for the before/after count and device time, not asserted). Then W8A8: the 8B
   model quantized to int8 and to fp8 (``weight_dtype`` = ``matmul_dtype``),
   each served at spec_k 0 and 3 on 8 of the 12 requests (4 base, the 4
   repetitive) -- spec-on tokens
   asserted equal to spec-off, launches of kernels A and B counted as
   above (kernel A standalone once a layer, in the norms as often as the
   norms run, in the SwiGLU once a layer) -- and its check per layer: the
   quantized model's plain path runs the probe prompt once, keeping each
   layer boundary's residual stream, and every layer is then fed that
   plain input on the kernel path, on two controls in the place of kernels
   A and B (the product in bf16; W8A16; the norms and the SwiGLU handing
   them their unquantized rows, ``plain_row_ops``) and on A and B's plain
   versions: each layer's output (its attention and MLP deltas) within a
   fixed limit a dtype of the plain layer's at every layer on the kernel
   path, past it at every layer for both controls, every layer's three
   readings printed (int8: A and B ``torch.equal`` to their plain
   versions, by layer and at full depth; 0.05 cannot hold: a quantizer
   turns a one-ulp difference upstream into a quantum); the full-depth
   first-token logits printed against the plain path's, two plain paths'
   and the bf16 model's, deciding nothing; F2 again under W8A8 int8; a
   profiled W8A8 int8 prefill
   window and decode tick, each of which must run kernel B, no cuBLAS
   GEMM, 2 x layers + 1 quantizing norms, and one fused SwiGLU and one
   standalone kernel A (wo's input) a layer; and one weight-only int8 run
   of 4 of the 8 requests (``matmul_dtype`` auto: the dequantize path);
4b. mixtral -- ``mixtral-8x7b`` at full width (D 4096, F 14336, E 8,
   K 2, V 32000), random bf16 weights from seed 0, capacity factor 4.0
   (E / K: dropless). Serve, cut to 4 of 32 layers (11.8 GB of
   weights): the serving MoE layer (``ops.moe.moe_layer_rows``, the
   router on the f32 decode GEMM, each expert's w3+w1 and w2 on the bf16
   one) on layer 0, its rows at M 1, 8 and 32 bitwise its rows at M 256
   (and the router's gates alone), each M within ``1e-2 + 2^-7 |plain|``
   of ``moe_layer``; the expert products of a decode tick (E 8, C 8)
   timed beside their plain version, ``torch.bmm`` and the bytes bound;
   verify rows bitwise decode rows; the 12 requests on bf16 pages at
   spec_k 0 and 3 (spec-on tokens equal to spec-off, every token; launches
   counted as above, 3 + 2 E decode GEMM launches a layer a tick or
   window, of which the router's one and the experts' 2 E are counted
   apart); the first-token logits within 0.05 of the plain attention
   path on the same expert choices (the kernels' replayed: an ulp of
   attention can move a token across a top-2 boundary, a discrete change;
   the plain path routing for itself, the choices it moved, and two plain
   paths reported); F2 (0 pages differing); a profiled prefill window and
   decode tick (305 decode GEMM launches a tick). Train, cut to 2 layers
   (3.17B parameters, 50.6 GB of f32 masters, gradients and moments),
   through ``python -m triton_kubernetes_tpu_torch.train --model
   mixtral-8x7b --expert 1``: batch 4 x 2048, fused CE, flash, bf16,
   remat full, 6 steps synced every 2; finite losses, each step's aux
   loss between 0.99 and E a layer, ``auto`` dispatch ``sort``, flash
   launches 4/2/2 a step; step ms, tokens/s, MFU over active parameters,
   peak memory; then one step at B 1 against plain flash on a fresh
   model with the kernels' expert choices replayed (loss and gradients
   within the train phase's bounds), plain flash routing for itself
   reported beside it;
5. train  -- ``python -m triton_kubernetes_tpu_torch.train``'s ``main`` on
   ``llama3-8b`` at full width cut to 4 layers (fused CE, flash attention,
   bf16 policy, remat full), batch 4 x 2048, 6 AdamW steps, with
   ``--trace-jsonl`` (the goodput ledger: step, compile -- the first step,
   which builds and warms -- host_sync, data_wait and idle must partition
   the recorded wall within 1e-6 s and pass the partition check; the
   categories are printed); checks finite
   losses and gradient norms and the flash launch counters (forward 2 x 4
   layers a step, each backward kernel 4 a step); prints step times,
   tokens/s, MFU (the reference's formula), peak memory and the losses;
   profiles one step (device time by kernel class); cross-checks one
   step's loss and gradients at B 1, S 2048, kernels vs the plain flash
   versions, beside the noise floor of two plain paths (dense vs plain
   flash). Then kill and resume, each arm a ``python -m
   triton_kubernetes_tpu_torch.train`` subprocess on the same full-width
   cut at 1 layer (a checkpoint is 15.2 GB: f32 masters and both
   moments; the script keeps its disk writes under 40 GB, which two
   4-layer checkpoints, 46 GB, exceed), 12 steps synced every 2,
   ``DevicePrefetch`` staging, JSON logs, a trace; the process's own
   caching allocator emptied first and the disk for two checkpoints
   checked free, else it raises with the bytes (A runs beside B, and C
   beside D, on the card at once, so every time printed is taken beside
   the other arm): A uninterrupted, as the rendered GPU JobSet's command
   and env (the host launcher starting one rank: a world of one); B with
   ``--checkpoint-every 4`` (one scheduled step before the kill) and
   ``--emergency-dir``, sent SIGTERM once it logs step 6 -- it must
   land an emergency save and exit 75; C ``--resume`` from the emergency
   directory -- it must restore B's emergency step and finish at step 12,
   writing nothing; D ``--resume`` over a copy (hard links) of both
   directories in which the emergency step has one byte of one leaf
   flipped -- it must quarantine that step as ``checksum-mismatch`` and
   fall back to the scheduled step, writing nothing. B's losses before
   the kill are held to A's, and C's after the restore to A's: bitwise
   when B's are bitwise A's, else within twice B's difference. Each
   arm's flash launches must be exactly 2, 1 and 1 a step, B's and C's
   goodput ledgers must pass the partition check with ``checkpoint`` and
   ``preempted_lost`` (B) and ``rollback_replay`` (C) booked, and the
   arms must build no kernel. It prints each save's pinning,
   device-to-host copy, write and sha256 seconds and GB/s, each
   restore's verify, read and copy seconds, SIGTERM-to-exit, the prefetch
   wait per window, the ledgers, and A's step times and MFU; the
   checkpoints are deleted at the end.
6. distributed -- phase 5's cut as GPipe on the card, the ring at n = 1
   and the entry point under a one-rank NCCL world (each 3 of phase 5's
   steps, their losses phase 5's first three), blockwise attention
   against the flash kernels, the fused exchange against the sharded
   step; run beside the durability arm B once arm A has ended (B then
   mostly waits on the disk), so its printed times are taken beside B;
7. expert -- ``mixtral-8x7b`` at full width cut to 2 layers, B 1 x 2048:
   the expert-1 step in this process (its expert choices recorded, its
   gradients kept), freed, then a gloo world of two processes on cuda:0
   at ``expert`` 2 (``chip_smoke.py --expert-worker``), each rank holding
   4 of the 8 experts: its first step on the recorded choices, loss
   bitwise or within 1e-6 relative of the expert-1 step's, the routers',
   wq's and its first expert's gradients within phase 4b's bound, flash
   launches 4/2/2; the choices that move when it routes for itself; each
   rank's step ms and peak memory. Then MoE under GPipe with its rows
   split: the one-process GPipe run (2 stages, 2 microbatches, B 4 x 512,
   capacity factor 1.25: tokens drop; its routing recorded), freed, then
   a gloo world of four processes on cuda:0 at ``stage`` 2 x ``data`` 2
   (``chip_smoke.py --gpipe-moe-worker``; each rank one layer and one row
   of each microbatch, its share of the global microbatch as the batch
   placer gives it; the stage shift through host memory, since gloo
   sends no CUDA tensor): each rank probes all_reduce, all_gather,
   reduce_scatter and the shift on CUDA tensors, then one forward and
   backward on the recorded routing (replayed by content), its loss
   within 1e-4 relative (phase 5's bound of two valid paths: its products
   run on half the rows) and its aux loss bitwise or within 1e-6 of the
   one-process run's, its stage's router, wq and first expert's w1 and
   w2 gradients (summed over data) within phase 4b's bound, flash
   launches 4/2/2, the dropped
   assignments over the ranks equal to the one-process run's and above 0;
   each rank's peak memory printed;
8. chaos -- the workload fault arms of ``triton_kubernetes_tpu_torch/
   chaos`` with every engine serving ``llama3-8b`` at full width and depth
   (random bf16 weights from seed 0) in the arms' own pools (block size 4:
   the paged kernels' CUDA-core designs). First fault F9's probe: the last
   row of prefill windows against the decode row at the same length
   (lengths 2-25 and 250-262, across the decode walk's first 256-key
   span), at bs 4 on the CUDA-core designs and at bs 16 on the tensor-core
   designs: rows and pages must be torch.equal on both. Then the committed corpus
   entries one card hosts, each to its pinned verdict (a mutation caught
   on exactly its invariant), engine-preempt with the prefix cache at
   spec_k 3 (a preemption and a prefix hit required), torn-checkpoint in
   all three corruptions and kv-migration-torn under ``accepted-torn``
   (caught on migration-integrity), and engine-preempt once more in a pool
   of 16-token pages (the tensor-core designs; 4 usable pages, 48-token
   prompts) where it must preempt; every engine arm must launch
   paged_decode and paged_prefill. The 8B's drafter proposes nothing on
   the arm's prompts (its greedy tokens never repeat one of their
   history's), so the spec_k 3 arm runs again on a stand-in whose drafts
   are accepted -- the F9 card test's model: llama-test at the 8B's head
   width, 512 wide, 2 layers, 256-token vocabulary, seed 9 -- where it
   must also launch paged_verify under preemption and accept at least
   one draft. The train arms (two NCCL ranks) must report the typed skip
   ``ranks-share-a-card``; their crash and resume runs as a world of one
   on the card, beside the arms (trainer processes forked beside the
   in-process checkpoint arms, the configuration that showed fault F11;
   llama-test, B 8, S 32, 4 steps, a checkpoint each
   step; rank 0 exits 3 at step 2; the resumed final loss within 1e-6 of
   an uninterrupted run, every rank trace passing the goodput check, the
   flash kernels launched). While it finishes, F11's check: the
   reshard-torn-checkpoint arm 10 times or more beside a loop of forks
   that hold the pages copy-on-write, every restore with its step's
   values. Prints a ``{"chaos": ...}`` line: verdicts,
   checked invariants, preemptions, seconds and launches by kernel and
   design.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. With ``--out DIR`` everything measured,
the per-offset prefill cases included, is also written to
``DIR/chip_smoke.json``, and the trainer's report to
``DIR/train_report.json``. ``--flash-only`` builds and checks the three
flash kernels and stops (half a minute: the first run after a change to
one of them); ``--gemm-only`` builds the GEMM, norm and quantizer,
runs the bit probe, the SiLU probe and the GEMM, norm and quantizer
checks of phase 3 and stops
(``DIR/chip_smoke_gemm.json`` with ``--out``); ``--migration-only`` builds
every kernel, runs the six spec/quant serve runs of phase 4 and then its
traced and migration runs, and stops (``DIR/chip_smoke_migration.json``);
``--http-only`` the same six runs and then the HTTP phase
(``DIR/chip_smoke_http.json``); ``--train-only`` builds and checks the
three flash kernels, then runs phase 5 with its kill and resume arms
(``DIR/chip_smoke_train.json``, the arms' reports and traces beside it);
``--mixtral-only`` builds every kernel and runs phase 4b
(``DIR/chip_smoke_mixtral.json``); ``--w8a8-only`` builds every kernel and
runs phase 4's W8A8 check on the 8B, without its serve runs
(``DIR/chip_smoke_w8a8.json``); ``--expert-only`` builds and checks the
three flash kernels and runs phase 7 (``DIR/chip_smoke_expert.json``);
``--chaos-only`` builds every kernel and runs phase 8
(``DIR/chip_smoke_chaos.json``).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# The training slice's cut of Llama-3-8B: full width, 4 of 32 layers (the
# f32 masters, gradients and two Adam moments of 32 layers, 128 GB, do not
# fit one 80 GB card), fused CE, flash attention, bf16 compute over f32
# masters, full remat; batch 4 x 2048, 6 steps (2 warm-up); batches made
# inline, as before the trainer had DevicePrefetch (the kill-and-resume
# arms below run with it).
TRAIN_MODEL, TRAIN_DEVICE = "llama3-8b", "cuda"
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 4, 4, 2048, 6, 2
TRAIN_ARGV = [
    "--model", TRAIN_MODEL, "--model-opt", f"num_layers={TRAIN_LAYERS}",
    "--model-opt", "fused_ce=true", "--model-opt", "attention=flash",
    "--precision", "bf16", "--remat-policy", "full",
    "--steps", str(TRAIN_STEPS), "--batch-size", str(TRAIN_BATCH),
    "--seq-len", str(TRAIN_SEQ), "--learning-rate", "3e-4",
    "--warmup-steps", "1", "--log-every", "1", "--device", TRAIN_DEVICE,
    "--prefetch", "0"]
# Flash launches a layer a training step (remat full: the forward twice).
FLASH_PER_LAYER = {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
FLASH_SHAPES = [(4, 2048), (1, 1000), (1, 1280), (1, 4096)]
# Besides the Llama-3-8B heads (bf16, D 128: the tensor-core design), one
# case per other branch of ``_kernels.flash_variant``, (B, S, Hq, Hkv, D):
# the tensor-core kernels at D 64 and the CUDA-core kernels at a width the
# first are not instantiated for.
FLASH_VARIANT_CASES = [(2, 200, 8, 2, 64), (1, 300, 6, 2, 96)]
# Flash kernels vs plain versions: the rounding order is shared (f32
# scores, p and ds rounded to bf16 at the same points), so they differ in
# f32 summation order only -- one bf16 ulp of the output, as for the paged
# kernels (ATOL, RTOL below); lse is f32 and held to 1e-4 absolute.
LSE_ATOL = 1e-4
# One training step, kernels vs plain flash versions, same weights and
# batch. The gradient bound is the check with teeth: each leaf within
# relative L2 0.05 (the bound of the serving logits check: bf16
# differences that compound through 4 layers and the backward); measured
# 0.0198, against 0.0546 between two valid plain paths (dense vs plain
# flash) on an H100 80GB HBM3 at 700 W. The loss at random init sits near
# ln V whatever attention computes (rms_norm precedes the head), so its
# bound is set from the readings: measured 8.0e-6 relative, plain paths
# 1.12e-5, bound 1e-4. The script prints both measures between the plain
# paths for scale.
STEP_LOSS_REL, STEP_GRAD_REL_L2 = 1e-4, 0.05

# Published peaks, dense (NVIDIA data sheets): bytes/s of HBM, bf16 FLOP/s.
PEAKS = {
    "H100 SXM": (3.35e12, 989e12),
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H200": (4.8e12, 989e12),
}

HQ, HKV, D, BS, T = 32, 8, 128, 16, 128
DECODE_LENGTHS = [0, 1, 16, 17, 300, 1000, 2047, 2048]
# Speculative verify: spec_k 3 (S = 4 rows a sequence) at lengths covering
# an inactive row, one token, rows crossing a page edge (14 + 3 = 17) and
# a near-full table (2045 + 3 = 2048).
SPEC_K = 3
VERIFY_LENGTHS = [0, 1, 14, 16, 17, 300, 1000, 2045]
# Page kinds of the paged kernels: the activation dtype, then 8-bit pools.
KV_KINDS = ("bf16", "int8", "fp8")
PREFILL_CHUNK = 256
PREFILL_OFFSETS = [0, 256, 1024]
SERVE_DEVICE = "cuda"
# New tokens of every serve-phase request (32 before the script's time
# budget: a decode step count, which the checks compare token for token).
SERVE_NEW_TOKENS = 16
SERVE_ENGINE_KW = dict(block_size=BS, num_blocks=2048, max_batch=8,
                       max_model_len=2048, prefill_chunk=PREFILL_CHUNK,
                       prefix_cache=True)
POISON = 1e4
# Kernel vs plain version, both bf16 with the same rounding order: they
# differ only in f32 summation order, which can move an output across one
# bf16 rounding boundary -- one ulp, 2^-8 relative -- so the bound is one
# ulp of the plain value plus 1e-2 absolute for outputs near zero.
ATOL, RTOL = 1e-2, 2.0 ** -7
# First-token logits, kernels vs plain versions through the whole 32-layer
# model: the matmuls are identical, the attention outputs one bf16 ulp
# apart in a few elements, and every later bf16 rounding such a flip
# touches can flip too, so the gap compounds over 32 layers to a few
# percent of the logits. For scale, the script also prints how far two
# plain paths with different rounding orders drift apart (whole-prompt
# dense attention vs the chunked plain version: 0.0585 relative L2 on an
# H100 80GB HBM3 at 700 W); kernel and plain version share one rounding
# order and came in at 0.0352. Bounds: relative L2 error, and max error
# relative to the largest logit. A wrong kernel moves logits by their
# whole spread.
LOGITS_REL_L2, LOGITS_REL_MAX = 0.05, 0.1


# Times the 128 MB flush buffer is zeroed ahead of each timed launch
# (~0.05 ms of device work a pass: enough to cover the host's enqueue).
FLUSH_PASSES = 4


# Seconds of each phase and of the serve phase's parts, as printed.
PHASE_SECONDS = {}


def phase_done(name: str, t0: float) -> float:
    """Print the seconds since ``t0`` on a line of their own, ``phase:
    NAME S s``, and keep them in PHASE_SECONDS."""
    seconds = time.perf_counter() - t0
    PHASE_SECONDS[name] = round(seconds, 1)
    print(f"phase: {name} {seconds:.1f} s", flush=True)
    return seconds


def timed(fn, *args, **kw):
    """``fn(*args, **kw)`` and the seconds it took."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def verbatim(cmd, what, log):
    """``cmd`` as rendered, each ``python`` in it (the host launcher's and
    the rank command's) replaced by this interpreter only where
    ``python`` is not on PATH (the substitution is logged in ``log``)."""
    import shutil

    cmd = list(cmd)
    if "python" in cmd and shutil.which("python") is None:
        cmd = [sys.executable if a == "python" else a for a in cmd]
        log.append(f"{what}: 'python' (not on PATH) -> {sys.executable}")
    return cmd


def start_health_probes():
    """The health DaemonSet's readiness command rendered for this host's
    GPU count N and for N + 1, each started as a process (they run beside
    the build): [(accelerator, command, process, substitutions)]."""
    from triton_kubernetes_tpu_torch.topology.daemonsets import \
        render_gpu_health_daemonset
    from triton_kubernetes_tpu_torch.topology.gpus import GpuPoolSpec

    n = torch.cuda.device_count()
    out = []
    for gpus in (n, n + 1):
        accel = f"h100-{gpus}"
        probe = render_gpu_health_daemonset(GpuPoolSpec.from_accelerator(
            accel))["spec"]["template"]["spec"]["containers"][0]
        subs = []
        cmd = verbatim(probe["readinessProbe"]["exec"]["command"],
                       "health probe", subs)
        out.append((accel, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), subs))
    return out


def health_probe_check(probes, card):
    """The rendered readiness command must exit 0 for this host's GPUs and
    non-zero for one more."""
    rcs = []
    for accel, cmd, proc, subs in probes:
        _, err = proc.communicate(timeout=300)
        rcs.append(proc.returncode)
        print(f"provisioning: health probe of an {accel} pool: {cmd!r} "
              f"exit {proc.returncode}"
              f"{'; ' + '; '.join(subs) if subs else ''}"
              f"{'; ' + err.strip().splitlines()[-1] if err.strip() else ''}"
              f" [{card}]", flush=True)
    if not (rcs[0] == 0 and rcs[1] != 0):
        raise AssertionError(f"health probe: exit codes {rcs} for "
                             f"{[p[0] for p in probes]} (want 0, non-zero)")
    return dict(accelerators=[p[0] for p in probes], exit_codes=rcs)


def card_peaks(name: str):
    for key in ("H200", "H100 NVL", "H100 PCIe"):
        if all(part in name for part in key.split()):
            return key, PEAKS[key]
    return "H100 SXM", PEAKS["H100 SXM"]


def time_ms(fn, flush: torch.Tensor, runs: int = 30, warmup: int = 3,
            read_flush: bool = False, spin_cycles: int = 0):
    """Median of ``runs`` CUDA-event timings of ``fn``, the 50 MB L2
    flushed before each (the serving path reads every layer's pages
    cold). The flush is enqueued :data:`FLUSH_PASSES` times: the card is
    still busy with it while the host prepares ``fn``'s launch, so the
    window between the two events holds the device's time and not the
    Python wrapper's (some 0.04 ms of a sub-millisecond kernel when the
    flush ran once). It zeroes the flush buffer, which leaves the L2 full
    of dirty lines that ``fn``'s reads must write back; ``read_flush``
    reads it instead, leaving clean lines (as a decode tick's kernels,
    which write little, leave them). ``spin_cycles`` holds the card in a
    spin of that many clock cycles after the flush, for an ``fn`` of many
    launches whose enqueue outlasts the flush: the events then bracket
    the device's time, not the host's."""
    words = flush.view(torch.int32)
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        for _ in range(FLUSH_PASSES):
            if read_flush:
                words.sum()
            else:
                flush.zero_()
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got.float() - want.float()).abs()
    bound = ATOL + RTOL * want.float().abs()
    worst = float(err.max())
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(
            f"{what}: kernel disagrees with its plain version: max abs err "
            f"{worst} (bound {ATOL} + {RTOL} * |plain|)")
    return worst


def make_pool(gen, n_pages, lengths_tables, device):
    """bf16 K/V pools filled with POISON, then unit normals in exactly the
    slots each sequence has written."""
    pools = []
    for _ in range(2):
        pool = torch.full((n_pages, HKV, BS, D), POISON, dtype=torch.bfloat16,
                          device=device)
        for length, table in lengths_tables:
            for t in range((length + BS - 1) // BS):
                n = min(BS, length - t * BS)
                pool[table[t], :, :n] = torch.randn(
                    (HKV, n, D), generator=gen, device=device
                ).to(torch.bfloat16)
        pools.append(pool)
    return pools


def pool_variant(kp, vp, kind):
    """The bf16 pools as the kernels of one page kind take them: (k, v,
    k_scale, v_scale), the anchored quantization of the same values for
    int8/fp8 (``ops/quantization.py``), scales None for bf16."""
    if kind == "bf16":
        return kp, vp, None, None
    from triton_kubernetes_tpu_torch.ops import quantization as qz
    dtype = qz.KV_QUANT_DTYPES[kind]
    (qk, sk), (qv, sv) = (qz.quantize_kv_pages(p.float(), dtype)
                          for p in (kp, vp))
    return qk, qv, sk, sv


def dequantized(pa, pages, scale, tables):
    """Gathered K or V in bf16 for the SDPA yardstick (dequantized first
    for 8-bit pools; not timed)."""
    if scale is None:
        return pa.gather_pages(pages, tables)
    return pa.gather_pages(pages, tables, scale, torch.bfloat16)


def paged_bytes(pages_read, kind, extra):
    """Bytes a paged kernel must move: K and V of the pages it reads (and
    their two f32 scales on 8-bit pools), plus ``extra`` (q, out, tables)."""
    elem = 2 if kind == "bf16" else 1
    scales = 0 if kind == "bf16" else pages_read * HKV * 4 * 2
    return pages_read * BS * HKV * D * elem * 2 + scales + extra


def kernel_record(name, kind, source, replaces, err, ms, pms, lms, nbytes,
                  flops, peaks, library_call, shape, variant="cuda_core",
                  **more):
    bw, flops_peak = peaks
    suffix = "" if kind == "bf16" else f"_{kind}"
    bound_ms = max(nbytes / bw, flops / flops_peak) * 1e3
    return dict(
        name=name + suffix, route="cuda",
        source=f"triton_kubernetes_tpu_torch/csrc/{source}",
        replaces=replaces, variant=variant, max_abs_err=err,
        tolerance=f"{ATOL} + {RTOL} * |plain|",
        ms=ms, plain_ms=pms, library_ms=lms,
        bound_ms=bound_ms,
        bound_by="bytes" if nbytes / bw >= flops / flops_peak
        else "operations",
        bound_share=bound_ms / ms,
        achieved_tflops=flops / (ms * 1e-3) / 1e12,
        library_call=library_call, bytes=nbytes, flops=flops,
        shape=dict(shape, pages=kind), **more)


def paged_design(pages):
    """The design the decode and verify kernels run on bf16 queries over
    these pages (``_kernels.PAGED_TENSOR_CORE``)."""
    from triton_kubernetes_tpu_torch.ops import _kernels
    return _kernels.paged_variant(torch.bfloat16, pages.dtype, BS, D)


def straddle_check(pa, device, gen):
    """Verify rows whose stagger crosses a span edge of the decode and
    verify kernels' tensor-core design (``_kernels.PAGED_SPAN_KEYS``):
    every row ``torch.equal`` to the decode kernel at its length, on bf16,
    int8 and fp8 pages. Asserted; not timed."""
    from triton_kubernetes_tpu_torch.ops import _kernels
    s, span = SPEC_K + 1, _kernels.PAGED_SPAN_KEYS
    # Row 0 just below an edge, row S - 1 past it: edges 1-4 and 7.
    lengths = [span * e - s // 2 for e in (1, 2, 3, 4, 7)] + [
        span - 1, 2 * span - 1, T * BS - s + 1]
    b = len(lengths)
    perm = torch.randperm(b * T, generator=torch.Generator().manual_seed(1))
    tables_cpu = (perm.reshape(b, T) + 1).to(torch.int32)
    for i, n in enumerate(lengths):
        tables_cpu[i, (n + s - 1 + BS - 1) // BS:] = pa.TRASH_PAGE
    kp16, vp16 = make_pool(gen, 1 + b * T,
                           [(n + s - 1, tables_cpu[i].tolist())
                            for i, n in enumerate(lengths)], device)
    tables = tables_cpu.to(device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    q = torch.randn((b, s, HQ, D), generator=gen, device=device
                    ).to(torch.bfloat16)
    for kind in KV_KINDS:
        kp, vp, ks, vs = pool_variant(kp16, vp16, kind)
        got = pa.ragged_verify_attention(q, kp, vp, tables, lens, ks, vs,
                                         impl="cuda")
        for j in range(s):
            row = pa.ragged_paged_attention(q[:, j:j + 1].contiguous(), kp,
                                            vp, tables, lens + j, ks, vs,
                                            impl="cuda")
            if not torch.equal(got[:, j:j + 1], row):
                raise AssertionError(
                    f"paged_verify ({kind} pages, {paged_design(kp)}): row "
                    f"{j} at span-straddling lengths {lengths} differs from "
                    f"paged_decode at lengths + {j}")
    print(f"kernel paged_verify: rows at span-straddling lengths {lengths} "
          f"(S {s}, span {span} keys) == paged_decode bitwise on "
          f"{', '.join(KV_KINDS)} pages", flush=True)


def prefill_window_check(pa, device, gen):
    """Prefill rows do not depend on the window they came in: rows 256-511
    of a 512-token window at offset 0 ``torch.equal`` to a 256-token window
    at offset 256 over the same pages, on bf16, int8 and fp8 pages.
    Asserted; not timed."""
    c, half = 2 * PREFILL_CHUNK, PREFILL_CHUNK
    table_cpu = (torch.randperm(T, generator=torch.Generator().manual_seed(2))
                 + 1).to(torch.int32)
    kp16, vp16 = make_pool(gen, 1 + T, [(c, table_cpu.tolist())], device)
    table = table_cpu.to(device)
    q = torch.randn((1, c, HQ, D), generator=gen, device=device
                    ).to(torch.bfloat16)
    for kind in KV_KINDS:
        kp, vp, ks, vs = pool_variant(kp16, vp16, kind)
        whole = pa.paged_prefill_attention(q, kp, vp, table, 0, ks, vs,
                                           impl="cuda")
        part = pa.paged_prefill_attention(q[:, half:].contiguous(), kp, vp,
                                          table, half, ks, vs, impl="cuda")
        if not torch.equal(whole[:, half:], part):
            worst = float((whole[:, half:].float() - part.float()).abs()
                          .max())
            raise AssertionError(
                f"paged_prefill ({kind} pages, {paged_design(kp)}): rows "
                f"{half}-{c - 1} of a {c}-token window at offset 0 differ "
                f"from a {half}-token window at offset {half} (max abs "
                f"{worst}); they must be bitwise equal")
    print(f"kernel paged_prefill: rows {half}-{c - 1} of a {c}-token window "
          f"at offset 0 == a {half}-token window at offset {half} bitwise on "
          f"{', '.join(KV_KINDS)} pages", flush=True)


def sdpa(qs, kk, vv, mask):
    return torch.nn.functional.scaled_dot_product_attention(
        qs, kk, vv, attn_mask=mask)


def kernel_phase(pa, device, flush, peaks):
    """Decode, verify and prefill against their plain versions on bf16,
    int8 and fp8 pages; verify rows against decode bit for bit. Returns
    the kernels' records."""
    gen = torch.Generator(device=device).manual_seed(1234)
    group = HQ // HKV
    records = []

    # ---- decode: B = 8 sequences at ragged lengths, own pages each.
    b = len(DECODE_LENGTHS)
    perm = torch.randperm(b * T, generator=torch.Generator().manual_seed(0))
    tables_cpu = (perm.reshape(b, T) + 1).to(torch.int32)
    for i, n in enumerate(DECODE_LENGTHS):  # unused entries -> trash page
        tables_cpu[i, (n + BS - 1) // BS:] = pa.TRASH_PAGE
    kp16, vp16 = make_pool(gen, 1 + b * T,
                           [(n, tables_cpu[i].tolist())
                            for i, n in enumerate(DECODE_LENGTHS)], device)
    tables = tables_cpu.to(device)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=device)
    q = torch.randn((b, 1, HQ, D), generator=gen, device=device
                    ).to(torch.bfloat16)
    mask = (torch.arange(T * BS, device=device)[None, :]
            < lengths[:, None])[:, None, None, :]
    pages_read = sum((n + BS - 1) // BS for n in DECODE_LENGTHS)
    for kind in KV_KINDS:
        kp, vp, ks, vs = pool_variant(kp16, vp16, kind)
        got = pa.ragged_paged_attention(q, kp, vp, tables, lengths, ks, vs,
                                        impl="cuda")
        want = pa.ragged_paged_attention(q, kp, vp, tables, lengths, ks, vs,
                                         impl="dense")
        torch.cuda.synchronize()
        err = check_close(f"paged_decode ({kind} pages)", got, want)
        if bool(got[0].any()):
            raise AssertionError("paged_decode: a length-0 slot must give 0")
        kms = time_ms(lambda: pa.ragged_paged_attention(
            q, kp, vp, tables, lengths, ks, vs, impl="cuda"), flush)
        pms = time_ms(lambda: pa.ragged_paged_attention(
            q, kp, vp, tables, lengths, ks, vs, impl="dense"), flush)
        kk = dequantized(pa, kp, ks, tables).transpose(1, 2
                                                       ).repeat_interleave(
            group, dim=1)
        vv = dequantized(pa, vp, vs, tables).transpose(1, 2
                                                       ).repeat_interleave(
            group, dim=1)
        lms = time_ms(lambda: sdpa(q.transpose(1, 2), kk, vv, mask), flush)
        del kk, vv
        records.append(kernel_record(
            "paged_decode", kind, "paged_decode.cu",
            "triton_kubernetes_tpu/ops/paged_attention.py:461", err, kms,
            pms, lms, paged_bytes(pages_read, kind, 2 * q.numel() * 2
                                  + tables.numel() * 4 + lengths.numel() * 4),
            4 * D * HQ * sum(DECODE_LENGTHS), peaks,
            "scaled_dot_product_attention over the gathered (dequantized) "
            "pages with a length mask",
            dict(B=b, Hq=HQ, Hkv=HKV, D=D, bs=BS, T=T,
                 lengths=DECODE_LENGTHS),
            variant=paged_design(kp)))

    # ---- verify: B = 8 sequences, S = spec_k + 1 staggered rows each.
    s = SPEC_K + 1
    tables_cpu = (perm.reshape(b, T) + 1).to(torch.int32)
    for i, n in enumerate(VERIFY_LENGTHS):
        tables_cpu[i, (n + s - 1 + BS - 1) // BS:] = pa.TRASH_PAGE
    kp16, vp16 = make_pool(gen, 1 + b * T,
                           [(n + s - 1, tables_cpu[i].tolist())
                            for i, n in enumerate(VERIFY_LENGTHS)], device)
    tables = tables_cpu.to(device)
    lengths = torch.tensor(VERIFY_LENGTHS, dtype=torch.int32, device=device)
    q = torch.randn((b, s, HQ, D), generator=gen, device=device
                    ).to(torch.bfloat16)
    row_len = lengths[:, None] + torch.arange(s, device=device)[None]
    mask = (torch.arange(T * BS, device=device)[None, None, :]
            < row_len[:, :, None])[:, None]  # [B, 1, S, T*bs]
    pages_read = sum(min(T, (n + s - 1 + BS - 1) // BS)
                     for n in VERIFY_LENGTHS)
    for kind in KV_KINDS:
        kp, vp, ks, vs = pool_variant(kp16, vp16, kind)
        got = pa.ragged_verify_attention(q, kp, vp, tables, lengths, ks, vs,
                                         impl="cuda")
        want = pa.ragged_verify_attention(q, kp, vp, tables, lengths, ks, vs,
                                          impl="dense")
        rows = [pa.ragged_paged_attention(q[:, j:j + 1].contiguous(), kp, vp,
                                          tables, lengths + j, ks, vs,
                                          impl="cuda") for j in range(s)]
        torch.cuda.synchronize()
        err = check_close(f"paged_verify ({kind} pages)", got, want)
        for j, row in enumerate(rows):
            if not torch.equal(got[:, j:j + 1], row):
                worst = float((got[:, j:j + 1].float() - row.float()).abs()
                              .max())
                raise AssertionError(
                    f"paged_verify ({kind} pages): row {j} differs from "
                    f"paged_decode at lengths + {j} (max abs {worst}); the "
                    f"rows must be bitwise equal")
        kms = time_ms(lambda: pa.ragged_verify_attention(
            q, kp, vp, tables, lengths, ks, vs, impl="cuda"), flush)
        pms = time_ms(lambda: pa.ragged_verify_attention(
            q, kp, vp, tables, lengths, ks, vs, impl="dense"), flush)
        kk = dequantized(pa, kp, ks, tables).transpose(1, 2
                                                       ).repeat_interleave(
            group, dim=1)
        vv = dequantized(pa, vp, vs, tables).transpose(1, 2
                                                       ).repeat_interleave(
            group, dim=1)
        lms = time_ms(lambda: sdpa(q.transpose(1, 2), kk, vv, mask), flush)
        del kk, vv
        records.append(kernel_record(
            "paged_verify", kind, "paged_verify.cu",
            "triton_kubernetes_tpu/ops/paged_attention.py:756", err, kms,
            pms, lms, paged_bytes(pages_read, kind, 2 * q.numel() * 2
                                  + tables.numel() * 4 + lengths.numel() * 4),
            4 * D * HQ * int(row_len.sum()), peaks,
            "scaled_dot_product_attention over the gathered (dequantized) "
            "pages with each row's length mask",
            dict(B=b, S=s, Hq=HQ, Hkv=HKV, D=D, bs=BS, T=T,
                 lengths=VERIFY_LENGTHS),
            variant=paged_design(kp), rows_bitwise_equal_to_decode=True))
    straddle_check(pa, device, gen)

    # ---- prefill: one C = 256 window at three offsets.
    cases = {kind: [] for kind in KV_KINDS}
    designs = {kind: set() for kind in KV_KINDS}
    from triton_kubernetes_tpu_torch.ops import _kernels
    real_entry = _kernels._entry
    codes = {v: k for k, v in _kernels.PAGED_VARIANTS.items()}
    for off in PREFILL_OFFSETS:
        total = off + PREFILL_CHUNK
        table_cpu = (torch.randperm(T, generator=torch.Generator()
                                    .manual_seed(off)) + 1).to(torch.int32)
        kp16, vp16 = make_pool(gen, 1 + T, [(total, table_cpu.tolist())],
                               device)
        table = table_cpu.to(device)
        q = torch.randn((1, PREFILL_CHUNK, HQ, D), generator=gen,
                        device=device).to(torch.bfloat16)
        qpos = off + torch.arange(PREFILL_CHUNK, device=device)
        mask = (torch.arange(T * BS, device=device)[None, :]
                <= qpos[:, None])[None, None]
        keys = sum(off + i + 1 for i in range(PREFILL_CHUNK))
        for kind in KV_KINDS:
            kp, vp, ks, vs = pool_variant(kp16, vp16, kind)

            def spy(kernel, dt, page_dtype=None, kind=kind):
                fn = real_entry(kernel, dt, page_dtype)

                def call(*args):  # args[-2]: the variant code
                    designs[kind].add(codes[args[-2]])
                    return fn(*args)
                return call

            _kernels._entry = spy
            try:
                got = pa.paged_prefill_attention(q, kp, vp, table, off, ks,
                                                 vs, impl="cuda")
            finally:
                _kernels._entry = real_entry
            want = pa.paged_prefill_attention(q, kp, vp, table, off, ks, vs,
                                              impl="dense")
            torch.cuda.synchronize()
            err = check_close(f"paged_prefill@{off} ({kind} pages)", got,
                              want)
            kms = time_ms(lambda: pa.paged_prefill_attention(
                q, kp, vp, table, off, ks, vs, impl="cuda"), flush)
            pms = time_ms(lambda: pa.paged_prefill_attention(
                q, kp, vp, table, off, ks, vs, impl="dense"), flush)
            kk = dequantized(pa, kp, ks, table[None]).transpose(1, 2)
            vv = dequantized(pa, vp, vs, table[None]).transpose(1, 2)
            kk = kk.repeat_interleave(group, dim=1)
            vv = vv.repeat_interleave(group, dim=1)
            lms = time_ms(lambda: sdpa(q.transpose(1, 2), kk, vv, mask),
                          flush)
            del kk, vv
            flops = 4 * D * HQ * keys
            nbytes = paged_bytes((total + BS - 1) // BS, kind,
                                 2 * q.numel() * 2 + table.numel() * 4)
            cases[kind].append(dict(
                offset=off, max_abs_err=err, ms=kms, plain_ms=pms,
                library_ms=lms, flops=flops, bytes=nbytes,
                bound_ms=max(flops / peaks[1], nbytes / peaks[0]) * 1e3))
    for kind in KV_KINDS:
        if designs[kind] != {"tensor_core"}:
            raise AssertionError(
                f"paged_prefill ({kind} pages): the C entry ran the "
                f"{designs[kind]} design, not the tensor cores")
        cs = cases[kind]
        rec = kernel_record(
            "paged_prefill", kind, "paged_prefill.cu",
            "triton_kubernetes_tpu/ops/paged_attention.py:633",
            max(c["max_abs_err"] for c in cs), sum(c["ms"] for c in cs),
            sum(c["plain_ms"] for c in cs), sum(c["library_ms"] for c in cs),
            sum(c["bytes"] for c in cs), sum(c["flops"] for c in cs), peaks,
            "scaled_dot_product_attention over the gathered (dequantized) "
            "pages with a causal mask at the window's offset",
            dict(C=PREFILL_CHUNK, Hq=HQ, Hkv=HKV, D=D, bs=BS, T=T,
                 offsets=PREFILL_OFFSETS, summed_over="offsets"),
            variant="tensor_core", cases=cs, rows_window_invariant=True)
        # Summed over three launches: the bound is the sum of theirs.
        rec["bound_ms"] = sum(c["bound_ms"] for c in cs)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        records.append(rec)
    prefill_window_check(pa, device, gen)
    for r in records:
        print(f"kernel {r['name']} ({r['variant']}): "
              f"max_abs_err={r['max_abs_err']:.6g} "
              f"(tolerance {r['tolerance']}) kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})"
              + (" rows == paged_decode bitwise"
                 if r.get("rows_bitwise_equal_to_decode") else "")
              + (" rows window-invariant bitwise"
                 if r.get("rows_window_invariant") else ""),
              flush=True)
    return records


# The decode and verify ticks' weight products of Llama-3-8B as the steps
# launch them, (name, K, widths of the group, out dtype): one launch a
# group of products of one input -- wq, wk and wv, then w3 and w1 -- and
# one for each other weight of a layer, and the lm head once a tick.
GEMM_GROUPS = [("wq+wk+wv", 4096, (4096, 1024, 1024), torch.bfloat16),
               ("wo", 4096, (4096,), torch.bfloat16),
               ("w3+w1", 4096, (14336, 14336), torch.bfloat16),
               ("w2", 14336, (4096,), torch.bfloat16),
               ("lm head", 4096, (128256,), torch.float32)]
# Rows of a decode tick (max_batch) and of a verify tick (max_batch x
# (spec_k + 1)); M 1 joins them in the row-invariance check.
GEMM_ROWS = (8, 32)
# Rows of a prefill window, which the GEMMs take as row tiles of 64 in one
# launch: held to the plain versions too, and each tile bitwise a launch
# of its rows alone.
WINDOW_ROWS = PREFILL_CHUNK
ROW_TILE = 64
# Every row count a decode or verify tick can have up to one launch of
# decode_gemm (max_batch x (spec_k + 1) <= 64): the plain torch ops are
# held to their own 64-row result at each, and reported.
ALL_ROWS = range(1, 65)
# Row counts of one launch past 64 rows, which the GEMMs take on their
# wgmma kernel: one row past a tile, a ragged row block, one, one and a
# half and two blocks of 128 rows. Each row is held bitwise to the same
# row through launches of at most 64 rows (mma.sync).
WGMMA_ROWS = (65, 100, 128, 192, 256)
# The bit probe of wgmma against mma.sync: seeds a case, k steps a chain.
PROBE_SEEDS = 4
PROBE_STEPS = 8


# Rows of the fused residual add + norm at D 4096: a lone sequence (1), a
# decode tick (8), a verify tick (32), one launch of decode_gemm (64) and a
# prefill window (256); and a decode tick of a model served in f32.
FUSED_CASES = [(torch.bfloat16, m) for m in (1, 8, 32, 64, 256)] + [
    (torch.float32, 8)]


def add_norm_cases(device, flush, bw, gen):
    """The fused residual add + norm (``_kernels.add_rms_norm``) at
    :data:`FUSED_CASES`: h and y ``torch.equal`` to torch's x + delta and
    the delta-null entry on it, the rows bitwise the rows at M 64, y
    within one bf16 ulp of the plain version; timed beside the plain
    version, the library's two calls (``F.rms_norm(x + delta)``), the
    delta-null kernel and ``F.rms_norm`` alone, and the bytes bound (x,
    delta and scale read once, h and y written once). Returns the cases,
    printed."""
    from triton_kubernetes_tpu_torch.ops import _kernels, norms

    rms = torch.nn.functional.rms_norm
    eps, d = 1e-5, 4096
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        rows = [m for dt, m in FUSED_CASES if dt == dtype]
        x = (3 * torch.randn((256, d), generator=gen, device=device)
             ).to(dtype)
        delta = torch.randn((256, d), generator=gen, device=device).to(dtype)
        scale = (1 + 0.1 * torch.randn((d,), generator=gen, device=device)
                 ).to(dtype)
        h64, y64 = _kernels.add_rms_norm(x[:64], delta[:64], scale, eps)
        for m in rows:
            xm, dm = x[:m], delta[:m]
            h, y = _kernels.add_rms_norm(xm, dm, scale, eps)
            h_torch = xm + dm
            if not (torch.equal(h, h_torch) and torch.equal(
                    y, _kernels.rms_norm(h_torch, scale, eps))):
                raise AssertionError(
                    f"add_rms_norm {dtype} M={m}: h or y is not bitwise "
                    f"torch's x + delta and the delta-null entry on it")
            k = min(m, 64)
            if not (torch.equal(h[:k], h64[:k])
                    and torch.equal(y[:k], y64[:k])):
                raise AssertionError(f"add_rms_norm {dtype} M={m}: rows "
                                     f"are not bitwise the rows at M 64")
            err = check_close(f"add_rms_norm {dtype} M={m}", y,
                              norms.add_rms_norm(xm, dm, scale, eps)[1])
            torch.cuda.synchronize()
            nbytes = (4 * m * d + d) * x.element_size()
            cases.append(dict(
                kernel="add_rms_norm", shape="D 4096", K=d, N=None, M=m,
                out=str(dtype).removeprefix("torch."),
                dtype=str(dtype).removeprefix("torch."), max_abs_err=err,
                ms=time_ms(lambda: _kernels.add_rms_norm(xm, dm, scale, eps),
                           flush),
                plain_ms=time_ms(
                    lambda: norms.add_rms_norm(xm, dm, scale, eps), flush),
                library_ms=time_ms(lambda: rms(xm + dm, (d,), scale, eps),
                                   flush),
                norm_kernel_ms=time_ms(
                    lambda: _kernels.rms_norm(xm, scale, eps), flush),
                library_norm_ms=time_ms(lambda: rms(xm, (d,), scale, eps),
                                        flush),
                bytes=nbytes, flops=5 * m * d, bound_ms=nbytes / bw * 1e3))
    for c in cases:
        print(f"kernel add_rms_norm D 4096 M={c['M']} ({c['dtype']}): h and "
              f"y torch.equal to torch's x + delta and the delta-null "
              f"entry, rows bitwise the rows at M 64; max_abs_err="
              f"{c['max_abs_err']:.6g} kernel_ms={c['ms']:.4f} plain_ms="
              f"{c['plain_ms']:.4f} library_ms={c['library_ms']:.4f} "
              f"(F.rms_norm(x + delta)); delta-null kernel_ms="
              f"{c['norm_kernel_ms']:.4f} library_ms="
              f"{c['library_norm_ms']:.4f} (F.rms_norm); bytes {c['bytes']} "
              f"bound_ms={c['bound_ms']:.5f} (share "
              f"{c['bound_ms'] / c['ms']:.4f})", flush=True)
    return cases


def rows_differing(fn, x, ms):
    """The row counts m in ms at which fn(x[:m]) is not bitwise fn(x)[:m]
    (fn maps [M, ...] to [M, ...])."""
    full = fn(x)
    return [m for m in ms
            if not torch.equal(fn(x[:m].contiguous()), full[:m])]


def tiles_differing(fn, x):
    """The row tiles t of x [WINDOW_ROWS, ...] at which fn(x) (one launch,
    its rows taken as tiles of ROW_TILE) is not bitwise fn of the tile's
    rows alone."""
    full = fn(x)
    return [t for t in range(-(-x.shape[0] // ROW_TILE))
            if not torch.equal(
                fn(x[t * ROW_TILE:(t + 1) * ROW_TILE].contiguous()),
                full[t * ROW_TILE:(t + 1) * ROW_TILE])]


def wgmma_rows_differing(fn):
    """The row counts m of :data:`WGMMA_ROWS` at which fn(0, m) (one
    launch: the wgmma kernel) is not bitwise the same rows through
    launches of ROW_TILE rows (the mma.sync kernels); fn(lo, m) is the
    list of outputs of one launch on rows lo .. lo + m - 1."""
    tiles = [fn(lo, ROW_TILE)
             for lo in range(0, max(WGMMA_ROWS), ROW_TILE)]
    ref = [torch.cat(parts) for parts in zip(*tiles)]
    return [m for m in WGMMA_ROWS
            if not all(torch.equal(a, b[:m]) for a, b in zip(fn(0, m),
                                                              ref))]


def probe_operands(kind, seed, case, device):
    """Operands of one bit probe (``_kernels.gemm_probe``): A [64, K], B
    and C of ``kind`` (bf16, int8, fp8) for ``case``: "wide", values over
    a wide exponent range and a nonzero C; "zero", the same with C 0 (a
    chain's start); "cancel", products that cancel in pairs inside each k
    step for half the columns, beside large and tiny ones."""
    gen = torch.Generator(device=device).manual_seed(seed)
    step = 16 if kind == "bf16" else 32
    k = PROBE_STEPS * step

    def wide(shape):  # sign x 2^[-20, 20] x [1, 2)
        e = torch.randint(-20, 21, shape, generator=gen, device=device)
        v = (1 + torch.rand(shape, generator=gen, device=device)) * torch.exp2(
            e.float())
        return torch.where(torch.rand(shape, generator=gen, device=device)
                           < 0.5, -v, v)

    if kind == "bf16":
        a, b = wide((64, k)).bfloat16(), wide((k, 64)).bfloat16()
        c = wide((64, 64))
        if case == "cancel":  # k + 8 repeats k with B negated, cols < 32
            a = a.view(64, PROBE_STEPS, 2, 8)
            a[:, :, 1] = a[:, :, 0]
            a = a.reshape(64, k)
            b = b.view(PROBE_STEPS, 2, 8, 64)
            b[:, 1, :, :32] = -b[:, 0, :, :32]
            b = b.reshape(k, 64)
    elif kind == "fp8":
        def bytes_(shape):  # every e4m3 code but the two NaNs
            v = torch.randint(0, 254, shape, generator=gen, device=device)
            v = v + (v >= 0x7f).long()
            return v.to(torch.uint8).view(torch.float8_e4m3fn)
        a, b, c = bytes_((64, k)), bytes_((64, k)), wide((64, 64))
        if case == "cancel":  # k + 16 repeats k with B's sign flipped
            a = a.view(torch.uint8).view(64, PROBE_STEPS, 2, 16)
            a[:, :, 1] = a[:, :, 0]
            a = a.reshape(64, k).view(torch.float8_e4m3fn)
            b = b.view(torch.uint8).view(64, PROBE_STEPS, 2, 16)
            b[:32, :, 1] = b[:32, :, 0] ^ 0x80
            b = b.reshape(64, k).view(torch.float8_e4m3fn)
    else:
        a = torch.randint(-128, 128, (64, k), generator=gen, device=device
                          ).to(torch.int8)
        b = torch.randint(-128, 128, (64, k), generator=gen, device=device
                          ).to(torch.int8)
        c = torch.randint(-2 ** 20, 2 ** 20, (64, 64), generator=gen,
                          device=device).to(torch.int32)
    if case == "zero":
        c = torch.zeros_like(c)
    return a.contiguous(), b.contiguous(), c.contiguous()


# (name, operand dtype, wgmma on the operands converted to f16): fp8 is
# probed both ways, its kernel runs the second.
PROBE_KINDS = (("bf16", torch.bfloat16, False),
               ("fp8", torch.float8_e4m3fn, False),
               ("fp8 as f16", torch.float8_e4m3fn, True),
               ("int8", torch.int8, False))


def gemm_probe_phase(device):
    """The bit probe: for bf16, fp8 (e4m3; directly, and converted to f16
    as the fp8 kernel runs it) and int8 operands, a chain of
    :data:`PROBE_STEPS` wgmma k steps against the same chain of mma.sync
    steps, from the same shared tiles and the same C, at
    :data:`PROBE_SEEDS` seeds of each case of :func:`probe_operands`.
    Counts the output elements whose bits differ. int8 must agree (exact
    sums); so must every kind whose M > 64 launches keep the mma.sync
    kernels' chains (``_kernels.gemm_wgmma`` false at M 1): their rows
    are bitwise the M <= 64 launches' only if one wgmma k step rounds as
    one mma.sync step. Returns {kind: {case: [differing, of]}}."""
    from triton_kubernetes_tpu_torch.ops import _kernels

    out = {}
    for kind, dtype, f16 in PROBE_KINDS:
        out[kind] = {}
        for case in ("wide", "zero", "cancel"):
            differ = total = 0
            for seed in range(PROBE_SEEDS):
                a, b, c = probe_operands(kind.split()[0],
                                         1000 * seed + len(case), case,
                                         device)
                dm, dw = _kernels.gemm_probe(a, b, c, f16)
                torch.cuda.synchronize()
                same = (dm.view(torch.int32) == dw.view(torch.int32))
                differ += int((~same).sum())
                total += same.numel()
            out[kind][case] = [differ, total]
    print("probe: wgmma vs mma.sync chains of " + str(PROBE_STEPS)
          + " k steps, elements differing bitwise: " + "; ".join(
              f"{kind} " + ", ".join(f"{case} {d}/{n}" for case, (d, n)
                                     in cases.items())
              for kind, cases in out.items()), flush=True)
    for kind, dtype, f16 in PROBE_KINDS:
        # The fp8 kernel runs the f16 chain: the direct one is reported.
        keeps_chains = (not _kernels.gemm_wgmma(dtype, 1)
                        and (dtype != torch.float8_e4m3fn or f16))
        bad = sum(d for d, _ in out[kind].values())
        if bad and (kind == "int8" or keeps_chains):
            raise AssertionError(
                f"probe: {bad} {kind} elements of the wgmma chain differ "
                f"from the mma.sync chain, yet M > 64 launches rely on "
                f"their agreement for row invariance")
    return out


def wgmma_record(name, cases, bw, ops_rate, library_call, variant):
    """The headline record of a wgmma kernel: its five 8B groups at a
    prefill window's M (the cases of that M, summed), bound by the larger
    of bytes over the memory rate and operations over ``ops_rate``."""
    mine = [c for c in cases if c["M"] == WINDOW_ROWS]
    total = {f: sum(c[f] for c in mine)
             for f in ("ms", "plain_ms", "library_ms", "bytes", "flops")}
    by_bytes, by_ops = total["bytes"] / bw, total["flops"] / ops_rate
    bound_ms = max(by_bytes, by_ops) * 1e3
    return dict(
        name=name, route="cuda",
        source="triton_kubernetes_tpu_torch/csrc/decode_gemm.cu",
        replaces="none: plain XLA matmuls in the reference "
                 "(triton_kubernetes_tpu/models/llama.py:86; W8A8: "
                 "quantized_einsum, ops/quantization.py:265)",
        variant=variant,
        max_abs_err=max(c["max_abs_err"] for c in mine),
        tolerance=mine[0].get("tolerance"),
        ms=total["ms"], plain_ms=total["plain_ms"],
        library_ms=total["library_ms"], library_call=library_call,
        bound_ms=bound_ms, bound_by="bytes" if by_bytes >= by_ops
        else "operations", bound_share=bound_ms / total["ms"],
        achieved_tflops=total["flops"] / (total["ms"] * 1e-3) / 1e12,
        bytes=total["bytes"], flops=total["flops"],
        shape=dict(M=WINDOW_ROWS, summed_over=[c["shape"] for c in mine]),
        cases=mine)


def rows_kernel_phase(device, flush, peaks):
    """The row-invariant decode GEMM and RMSNorm against their plain
    versions (torch.mm of each weight in turn, and the plain rms_norm) at
    the 8B groups and D 4096, M 8 and 32 (the GEMM at a prefill window's
    M 256 too, each 64-row tile of it bitwise a launch of its rows alone):
    the GEMM one launch a group (wq+wk+wv, wo, w3+w1, w2, the lm head),
    its K split reported; rows at M 1, 8 and 32 bitwise the rows at M 64
    (the plain ops' at every M of 1-64 reported); times beside the bytes
    bound and the library call's (one torch.mm on the group's weights
    concatenated outside the timed window; torch.nn.functional.rms_norm),
    which the port never calls.
    Returns the two kernels' records (their headline numbers at M 8: a
    decode tick's rows, summed over the groups), the per-group cases
    inside."""
    from triton_kubernetes_tpu_torch.ops import _kernels
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg
    from triton_kubernetes_tpu_torch.ops import norms

    def launch(x, ws, out):  # one launch of the kernel, as the wrapper makes
        ys = [torch.empty((x.shape[0], w.shape[1]), dtype=out,
                          device=x.device) for w in ws]
        _kernels.decode_gemm(x, ws, ys)
        return ys

    # The outputs side by side, for the checks (the copy is not timed).
    def gemm(x, ws, out):
        return torch.cat(launch(x, ws, out), dim=1)

    def plain(x, ws, out):  # the products in turn, torch.mm each
        return torch.cat(dg.decode_gemm_group_plain(x, ws, out), dim=1)

    def library(x, w_cat, out):  # one torch.mm on the weights side by side
        return (torch.mm(x, w_cat) if out == x.dtype
                else torch.mm(x, w_cat, out_dtype=out))

    bw = peaks[0]
    gen = torch.Generator(device=device).manual_seed(99)
    cases = []
    for name, k, ns, out in GEMM_GROUPS:
        ws = [(torch.randn((k, n), generator=gen, device=device) * 0.02
               ).to(torch.bfloat16) for n in ns]
        w_cat = torch.cat(ws, dim=1) if len(ws) > 1 else ws[0]
        x = torch.randn((WINDOW_ROWS, k), generator=gen, device=device
                        ).to(torch.bfloat16)
        x64 = x[:max(ALL_ROWS)]
        bad = rows_differing(lambda t: gemm(t, ws, out), x64, (1, 8, 32))
        if bad:
            raise AssertionError(f"decode_gemm {name}: rows at M {bad} are "
                                 f"not bitwise its rows at M 64")
        bad = tiles_differing(lambda t: gemm(t, ws, out), x)
        if bad:
            raise AssertionError(f"decode_gemm {name} M={WINDOW_ROWS}: row "
                                 f"tiles {bad} are not bitwise a launch of "
                                 f"their rows alone")
        bad = wgmma_rows_differing(
            lambda lo, m: launch(x[lo:lo + m].contiguous(), ws, out))
        if bad:
            raise AssertionError(f"decode_gemm {name}: rows at M {bad} (the "
                                 f"wgmma kernel) are not bitwise the same "
                                 f"rows through launches of {ROW_TILE}")
        torch_rows = rows_differing(lambda t: plain(t, ws, out), x64,
                                    ALL_ROWS)
        n = sum(ns)
        for m in GEMM_ROWS + (WINDOW_ROWS,):
            xm = x[:m].contiguous()
            got = gemm(xm, ws, out)
            want = plain(xm, ws, out)
            torch.cuda.synchronize()
            err = check_close(f"decode_gemm {name} M={m}", got, want)
            kms = time_ms(lambda: launch(xm, ws, out), flush)
            pms = time_ms(lambda: dg.decode_gemm_group_plain(xm, ws, out),
                          flush)
            lms = time_ms(lambda: library(xm, w_cat, out), flush)
            nbytes = (k * n + m * k) * 2 + m * n * got.element_size()
            tile = _kernels.gemm_tile(n)
            cases.append(dict(
                kernel="decode_gemm", shape=name, K=k, N=list(ns), M=m,
                tolerance=f"{ATOL} + {RTOL} * |plain|",
                tile_n=tile, splits=_kernels.gemm_splits(n, k),
                blocks=sum(-(-c // tile) for c in ns)
                * _kernels.gemm_splits(n, k),
                out=str(out).removeprefix("torch."), max_abs_err=err,
                ms=kms, plain_ms=pms, library_ms=lms, bytes=nbytes,
                flops=2 * m * k * n, bound_ms=nbytes / bw * 1e3,
                torch_rows_differing_at=torch_rows))
        del ws, w_cat, x, x64
    scale = (1 + 0.1 * torch.randn((4096,), generator=gen, device=device)
             ).to(torch.bfloat16)
    x = (3 * torch.randn((max(ALL_ROWS), 4096), generator=gen,
                         device=device)).to(torch.bfloat16)
    bad = rows_differing(lambda t: _kernels.rms_norm(t, scale, 1e-5), x,
                         (1, 8, 32))
    if bad:
        raise AssertionError(f"rms_norm: rows at M {bad} are not bitwise its "
                             f"rows at M 64")
    torch_rows = rows_differing(lambda t: norms.rms_norm(t, scale, 1e-5), x,
                                ALL_ROWS)
    for m in GEMM_ROWS:
        xm = x[:m].contiguous()
        got = _kernels.rms_norm(xm, scale, 1e-5)
        want = norms.rms_norm(xm, scale, 1e-5)
        torch.cuda.synchronize()
        err = check_close(f"rms_norm M={m}", got, want)
        kms = time_ms(lambda: _kernels.rms_norm(xm, scale, 1e-5), flush)
        pms = time_ms(lambda: norms.rms_norm(xm, scale, 1e-5), flush)
        lms = time_ms(lambda: torch.nn.functional.rms_norm(
            xm, (4096,), scale, 1e-5), flush)
        nbytes = 2 * m * 4096 * 2 + 4096 * 2
        cases.append(dict(
            kernel="rms_norm", shape="D 4096", K=4096, N=None, M=m,
            out="bfloat16", max_abs_err=err, ms=kms, plain_ms=pms,
            library_ms=lms, bytes=nbytes, flops=4 * m * 4096,
            bound_ms=nbytes / bw * 1e3, torch_rows_differing_at=torch_rows))
    for c in cases:
        split = (f", {c['tile_n']}-column tiles, K split in "
                 f"{c['splits']}, {c['blocks']} blocks"
                 if "splits" in c else "")
        tiles = (f"; each 64-row tile bitwise a launch of its rows alone, "
                 f"rows at M {'/'.join(map(str, WGMMA_ROWS))} (wgmma) "
                 f"bitwise launches of {ROW_TILE}"
                 if c["M"] == WINDOW_ROWS else "")
        print(f"kernel {c['kernel']} {c['shape']} M={c['M']} ({c['out']} "
              f"out{split}): max_abs_err={c['max_abs_err']:.6g} kernel_ms="
              f"{c['ms']:.4f} plain_ms={c['plain_ms']:.4f} library_ms="
              f"{c['library_ms']:.4f} bound_ms="
              f"{c['bound_ms']:.5f} (bytes; share "
              f"{c['bound_ms'] / c['ms']:.4f}); rows at M 1/8/32 bitwise "
              f"to M 64: kernel yes{tiles}; plain torch differs at M "
              f"{c['torch_rows_differing_at'] or 'none'} of 1-64",
              flush=True)
    cases += add_norm_cases(device, flush, bw, gen)
    records = []
    for name, source, library_call in (
            ("decode_gemm", "decode_gemm.cu",
             "one torch.mm of x on the group's weights side by side "
             "(out_dtype float32 for the lm head); the plain version is "
             "torch.mm of each weight in turn"),
            ("rms_norm", "rms_norm.cu", "torch.nn.functional.rms_norm"),
            ("add_rms_norm", "rms_norm.cu",
             "torch.nn.functional.rms_norm(x + delta): two calls")):
        mine = [c for c in cases if c["kernel"] == name and c["M"] == 8
                and c.get("dtype") != "float32"]
        total = {f: sum(c[f] for c in mine)
                 for f in ("ms", "plain_ms", "library_ms", "bytes", "flops",
                           "bound_ms")}
        records.append(dict(
            name=name, route="cuda",
            source=f"triton_kubernetes_tpu_torch/csrc/{source}",
            replaces={
                "decode_gemm": "none: plain XLA matmuls in the reference "
                               "(triton_kubernetes_tpu/models/llama.py:86)",
                "rms_norm": "none: a plain XLA reduction in the reference "
                            "(triton_kubernetes_tpu/ops/norms.py:11)",
                "add_rms_norm": "none: plain XLA ops in the reference, the "
                                "residual add (triton_kubernetes_tpu/models/"
                                "llama.py:407, models/paged.py:419) and "
                                "rms_norm (ops/norms.py:11)"}[name],
            variant=("tensor_core (mma.sync), one launch a group of "
                     "products of one input, tile width and K split by "
                     "the shape (_kernels.gemm_tile, gemm_splits), the "
                     "split merged in the launch"
                     if name == "decode_gemm" else
                     "cuda_core, one block a row, every load before the "
                     "first FMA"),
            max_abs_err=max(c["max_abs_err"] for c in cases
                            if c["kernel"] == name),
            tolerance=f"{ATOL} + {RTOL} * |plain|",
            ms=total["ms"], plain_ms=total["plain_ms"],
            library_ms=total["library_ms"],
            library_call=library_call, bound_ms=total["bound_ms"],
            bound_by="bytes", bound_share=total["bound_ms"] / total["ms"],
            achieved_tflops=total["flops"] / (total["ms"] * 1e-3) / 1e12,
            bytes=total["bytes"], flops=total["flops"],
            shape=dict(M=8, summed_over=[c["shape"] for c in mine]),
            cases=[c for c in cases if c["kernel"] == name]))
    records.append(wgmma_record(
        "decode_gemm_wgmma", [c for c in cases
                              if c["kernel"] == "decode_gemm"],
        bw, peaks[1], "one torch.mm of x on the group's weights side by "
        "side (out_dtype float32 for the lm head)",
        "wgmma m64nNk16 bf16, M > 64: two warpgroups of 64 rows over a "
        "cp.async ring fed by a third, the M <= 64 kernel's chains of k "
        "steps, tile width and K split by the shape"))
    return records


# Rows and widths of kernel A (the per-token quantizer) at the inputs of a
# decode tick's five product groups (K 4096 four times, w2's 14336), and
# the other row counts it is held to its plain version at: one sequence,
# a verify tick, a prefill window.
QUANT_ROWS = (1, 8, 32, 256)
QUANT_WIDTHS = (4096, 14336)
# The 8-bit kinds of the W8A8 path: (name suffix, storage dtype, the
# kernel's entry infix).
W8A8_KINDS = (("", torch.int8, "s8"), ("_fp8", torch.float8_e4m3fn, "e4m3"))
# The least rows of the library calls kernel B is timed beside:
# torch._int_mm takes more than 16, torch._scaled_mm at least 16. Fewer
# rows are timed at these.
INT_MM_ROWS = 17
SCALED_MM_ROWS = 16
# The H100's dense int8 / fp8 tensor-core rate (NVIDIA data sheet): twice
# the bf16 rate.
W8A8_OPS_FACTOR = 2


# The SiLU probe: every bf16 bit pattern.
SILU_PATTERNS = 2 ** 16
# The fused SwiGLU's design, which the probe decided once (PERF.md):
# (a) silu, the mul and kernel A in one pass -- its SiLU gives torch's bits
# on every bf16 input; (b) would keep torch's silu and fuse only the mul.
SWIGLU_DESIGN = "a"


def silu_probe_phase(device):
    """The SiLU probe: all 65,536 bf16 bit patterns through the fused
    SwiGLU kernel's SiLU (``_kernels.silu_probe``) and through torch's
    ``silu(x.float()).to(bfloat16)``, counting the patterns whose bits
    differ (two NaNs count as agreeing, reported apart). Design (a) rests
    on 0: the fused pass computes the SiLU itself. Returns the record,
    printed as a JSON line."""
    from triton_kubernetes_tpu_torch.ops import _kernels

    x = torch.arange(-SILU_PATTERNS // 2, SILU_PATTERNS // 2,
                     dtype=torch.int32, device=device).to(torch.int16).view(
                         torch.bfloat16)
    got = _kernels.silu_probe(x)
    want = torch.nn.functional.silu(x.float()).to(torch.bfloat16)
    torch.cuda.synchronize()
    both_nan = got.isnan() & want.isnan()
    differ = (got.view(torch.int16) != want.view(torch.int16)) & ~both_nan
    out = dict(differing=int(differ.sum()), of=SILU_PATTERNS,
               both_nan=int(both_nan.sum()), design=SWIGLU_DESIGN)
    print(json.dumps({"silu_probe": out}), flush=True)
    if out["differing"]:
        raise AssertionError(f"silu probe: {out['differing']} bf16 inputs "
                             f"give other bits than torch's silu, yet "
                             f"design (a) computes the SiLU in the kernel")
    return out


# Widths of kernel A's fused forms: the norm's D (the 8B model's embed
# width) and the SwiGLU's F (its MLP width, w2's input).
NORM_WIDTH = 4096
SWIGLU_WIDTH = 14336
# Kernel A's forms: (record name, source, what it replaces beside the
# quantizer, design, the shape of its headline case).
A_FORMS = (
    ("quantize_rows", "quantize_rows.cu", "",
     "standalone (wo's input): one block a row, the row's 16-byte chunks "
     "held in registers (K <= 14336), one barrier, 8-byte stores",
     f"K {NORM_WIDTH}"),
    ("rms_norm_quant", "rms_norm.cu", "; rms_norm, ops/norms.py:11",
     "epilogue of the delta-null norm (rms_norm_quant_kernel): y rounded "
     "in registers, a second reduction and barrier, y never written",
     f"D {NORM_WIDTH}"),
    ("add_rms_norm_quant", "rms_norm.cu",
     "; the residual add and rms_norm, models/llama.py",
     "epilogue of the fused residual add + norm (rms_norm_quant_kernel)",
     f"D {NORM_WIDTH}"),
    ("swiglu_quant", "quantize_rows.cu",
     "; the SwiGLU, models/llama.py:298-302",
     "fused SwiGLU of w2's input (swiglu_quant_kernel, design (a)): silu, "
     "the mul and the quantizer in one pass over the row held in "
     "registers", f"F {SWIGLU_WIDTH}"))


def bitwise(a, b):
    """torch.equal of two tensors' bits (8-bit floats compared as bytes)."""
    if a.element_size() == 1:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a, b)


def kernel_a_cases(device, flush, bw, gen):
    """Kernel A in its three forms against their plain compositions, int8
    and fp8, bf16 and f32 input, at every row count of
    :data:`QUANT_ROWS`: the standalone kernel (``quantize_rows``) at K
    4096 and 14,336 against ``quantize_rows_plain``; the norm's quantizing
    entries at D 4096 (delta null, and the residual add fused) against the
    norm kernel's entries followed by ``quantize_rows_plain`` (h too); the
    fused SwiGLU at F 14,336 against torch's ``silu(gate.float()).to(T) *
    up`` followed by ``quantize_rows_plain`` -- bytes, scales and h
    ``torch.equal``; and every output's rows at each M bitwise its rows of
    a launch of 64. bf16 at M 8, 32 and 256 timed beside the plain version
    (the plain producer, then ``quantize_rows_plain``) and the bytes bound
    (inputs read once, outputs written once). Returns the timed cases."""
    from triton_kubernetes_tpu_torch.ops import _kernels, norms
    from triton_kubernetes_tpu_torch.ops import quantization as qz

    eps, n = 1e-5, max(QUANT_ROWS)
    cases = []
    for suffix, qdtype, _ in W8A8_KINDS:
        for dtype in (torch.bfloat16, torch.float32):
            elt = torch.empty((), dtype=dtype).element_size()

            def randn(*shape, s=1.0):
                return (s * torch.randn(shape, generator=gen, device=device)
                        ).to(dtype)

            # (name, where, fn(m), composition(m), plain(m), bytes(m),
            # operations(m)): fn and the composition give the same tuple.
            forms = []
            for k in QUANT_WIDTHS:
                x = randn(n, k, s=2.0)
                forms.append((
                    "quantize_rows", f"K {k}",
                    lambda m, x=x: _kernels.quantize_rows(x[:m], qdtype),
                    lambda m, x=x: qz.quantize_rows_plain(x[:m], qdtype),
                    lambda m, x=x: qz.quantize_rows_plain(x[:m], qdtype),
                    lambda m, k=k: m * k * (elt + 1) + 4 * m,
                    lambda m, k=k: 3 * m * k))
            d = NORM_WIDTH
            x, delta = randn(n, d, s=3.0), randn(n, d)
            scale = (1 + 0.1 * torch.randn((d,), generator=gen,
                                           device=device)).to(dtype)

            def composed(h, y):
                return (h, *qz.quantize_rows_plain(y, qdtype))

            forms += [(
                "rms_norm_quant", f"D {d}",
                lambda m: _kernels.add_rms_norm_quant(x[:m], None, scale, eps,
                                                      qdtype)[1:],
                lambda m: qz.quantize_rows_plain(
                    _kernels.rms_norm(x[:m], scale, eps), qdtype),
                lambda m: norms.rms_norm_quant_plain(x[:m], scale, eps,
                                                     qdtype),
                lambda m: m * d * (elt + 1) + d * elt + 4 * m,
                lambda m: 8 * m * d), (
                "add_rms_norm_quant", f"D {d}",
                lambda m: _kernels.add_rms_norm_quant(x[:m], delta[:m], scale,
                                                      eps, qdtype),
                lambda m: composed(*_kernels.add_rms_norm(
                    x[:m], delta[:m], scale, eps)),
                lambda m: norms.add_rms_norm_quant_plain(
                    x[:m], delta[:m], scale, eps, qdtype),
                lambda m: m * d * (3 * elt + 1) + d * elt + 4 * m,
                lambda m: 9 * m * d)]
            f = SWIGLU_WIDTH
            gate, up = randn(n, f, s=3.0), randn(n, f)
            forms.append((
                "swiglu_quant", f"F {f}",
                lambda m: _kernels.swiglu_quant(gate[:m], up[:m], qdtype),
                lambda m: qz.swiglu_quantize_rows_plain(gate[:m], up[:m],
                                                        qdtype)[:2],
                lambda m: qz.swiglu_quantize_rows_plain(gate[:m], up[:m],
                                                        qdtype),
                lambda m: m * f * (2 * elt + 1) + 4 * m,
                lambda m: 10 * m * f))
            for name, where, fn, comp, plain, nbytes, ops in forms:
                tag = f"{name}{suffix} {where} {dtype}"
                full = fn(ROW_TILE)
                for m in QUANT_ROWS:
                    got = fn(m)
                    if not all(bitwise(a, b) for a, b in zip(got, comp(m))):
                        raise AssertionError(f"{tag} M={m}: not bitwise its "
                                             f"plain composition")
                    k = min(m, ROW_TILE)
                    if not all(bitwise(a[:k], b[:k])
                               for a, b in zip(got, full)):
                        raise AssertionError(f"{tag} M={m}: rows are not "
                                             f"bitwise its rows at M "
                                             f"{ROW_TILE}")
                    if dtype != torch.bfloat16 or m == 1:
                        continue
                    cases.append(dict(
                        kernel=name + suffix, where=where, M=m,
                        dtype="bfloat16", max_abs_err=0.0,
                        ms=time_ms(lambda: fn(m), flush),
                        plain_ms=time_ms(lambda: plain(m), flush),
                        library_ms=None, bytes=nbytes(m), flops=ops(m),
                        bound_ms=nbytes(m) / bw * 1e3))
            del x, delta, gate, up
    print(f"kernel A: standalone, in the norm (delta null and fused) and in "
          f"the SwiGLU, int8 and fp8, bf16 and f32 input, M {QUANT_ROWS}: "
          f"bytes, scales and h torch.equal to the producer then "
          f"quantize_rows_plain; rows bitwise the rows at M {ROW_TILE}",
          flush=True)
    return cases


def kernel_a_records(cases, bw):
    """One record per form of kernel A and 8-bit kind: its headline case,
    one launch of bf16 rows at M 8 (a decode tick's) at the form's width
    on the serving path (the standalone kernel: wo's input, K 4096)."""
    records = []
    for suffix, qdtype, _ in W8A8_KINDS:
        for name, source, also, variant, where in A_FORMS:
            c = next(c for c in cases if c["kernel"] == name + suffix
                     and c["M"] == 8 and c["where"] == where)
            records.append(dict(
                name=name + suffix, route="cuda",
                source=f"triton_kubernetes_tpu_torch/csrc/{source}",
                replaces=("none: plain XLA ops in the reference's "
                          "quantized_einsum (triton_kubernetes_tpu/ops/"
                          f"quantization.py:265-305{also})"),
                variant=variant, max_abs_err=0.0, tolerance="torch.equal",
                ms=c["ms"], plain_ms=c["plain_ms"], library_ms=None,
                library_call=None, bound_ms=c["bound_ms"], bound_by="bytes",
                bound_share=c["bound_ms"] / c["ms"],
                achieved_tflops=c["flops"] / (c["ms"] * 1e-3) / 1e12,
                bytes=c["bytes"], flops=c["flops"],
                shape=dict(M=8, at=where),
                cases=[d for d in cases if d["kernel"] == name + suffix]))
    return records


def w8a8_kernel_phase(device, flush, peaks):
    """Kernel A (``quantize_rows``) and kernel B (``decode_gemm_w8a8``)
    against their plain versions, int8 and fp8. A: every row count of
    :data:`QUANT_ROWS` at both widths, bf16 and f32 input, bytes and
    scales ``torch.equal``. B: the 8B model's five groups (one launch a
    group, weights quantized per column and stored [N, K]) at M 8, 32 and
    a prefill window's 256, int8 ``torch.equal`` to its plain version and
    fp8 within ATOL + RTOL |plain|; rows at M 1, 8 and 32 bitwise the rows
    of a 64-row launch, and each 64-row tile of the 256-row launch bitwise
    a launch of its rows alone. Timed beside the bytes bound, the plain
    version and the library's nearest call (``torch._int_mm``, its int32
    product alone, and ``torch._scaled_mm`` with row and column scales; at
    M 8 run at :data:`INT_MM_ROWS` and :data:`SCALED_MM_ROWS` rows, the
    least each takes), which the port never calls.
    A in its three forms: :func:`kernel_a_cases`.
    Returns the records (A's forms and B, int8 and fp8; B's headline at M
    8, a decode tick's rows, summed over the five groups; A's a form's one
    launch at M 8)."""
    from triton_kubernetes_tpu_torch.ops import _kernels
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg
    from triton_kubernetes_tpu_torch.ops import quantization as qz

    bw = peaks[0]
    gen = torch.Generator(device=device).manual_seed(123)
    cases = kernel_a_cases(device, flush, bw, gen)
    for suffix, qdtype, _ in W8A8_KINDS:
        name = "decode_gemm_w8a8" + suffix
        for group, k, ns, out in GEMM_GROUPS:
            pairs = [qz.quantize_channelwise(
                torch.randn((k, n), generator=gen, device=device) * 0.02, 0,
                qdtype) for n in ns]
            wqs = [q.t().contiguous() for q, _ in pairs]
            wss = [sc.reshape(-1).contiguous() for _, sc in pairs]
            del pairs
            x = torch.randn((WINDOW_ROWS, k), generator=gen, device=device
                            ).to(torch.bfloat16)
            xq, xs = qz.quantize_rows_plain(x, qdtype)

            def launch(m, lo=0):  # one launch on rows lo .. lo + m - 1
                ys = [torch.empty((m, w.shape[0]), dtype=out, device=device)
                      for w in wqs]
                _kernels.decode_gemm_w8a8(xq[lo:lo + m], xs[lo:lo + m], wqs,
                                          wss, ys)
                return ys

            full = launch(ROW_TILE)
            for m in (1, 8, 32):
                for a, b in zip(launch(m), full):
                    if not torch.equal(a, b[:m]):
                        raise AssertionError(f"{name} {group}: rows at M {m}"
                                             f" are not bitwise its rows at "
                                             f"M 64")
            full = launch(WINDOW_ROWS)
            for lo in range(0, WINDOW_ROWS, ROW_TILE):
                for a, b in zip(launch(ROW_TILE, lo), full):
                    if not torch.equal(a, b[lo:lo + ROW_TILE]):
                        raise AssertionError(
                            f"{name} {group} M={WINDOW_ROWS}: the row tile "
                            f"at row {lo} is not bitwise a launch of its "
                            f"rows alone")
            del full
            bad = wgmma_rows_differing(lambda lo, m: launch(m, lo))
            if bad:
                raise AssertionError(f"{name} {group}: rows at M {bad} (the "
                                     f"wgmma kernel) are not bitwise the "
                                     f"same rows through launches of "
                                     f"{ROW_TILE}")
            n = sum(ns)
            w_cat = torch.cat(wqs, dim=0)  # [N, K]: the library's operand
            s_cat = torch.cat(wss)[None, :]
            for m in GEMM_ROWS + (WINDOW_ROWS,):
                got = launch(m)
                want = dg.w8a8_gemm_group_plain(xq[:m], xs[:m], wqs, wss, out)
                torch.cuda.synchronize()
                if qdtype == torch.int8:
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"{name} {group} M={m}: not "
                                             f"bitwise its plain version")
                    err = 0.0
                else:
                    err = max(check_close(f"{name} {group} M={m}", a, b)
                              for a, b in zip(got, want))
                xm, sm = xq[:m].contiguous(), xs[:m].contiguous()
                if qdtype == torch.int8:
                    # _int_mm takes more than 16 rows.
                    rows = max(m, INT_MM_ROWS)
                    xl = xq[:rows].contiguous()
                    lib = (f"torch._int_mm (int32 product alone), {rows} "
                           f"rows")
                    lms = time_ms(lambda: torch._int_mm(xl, w_cat.t()),
                                  flush)
                else:
                    rows = max(m, SCALED_MM_ROWS)
                    xl = xq[:rows].contiguous()
                    sl = xs[:rows].contiguous()[:, None]
                    # Row-wise scales take a bf16 out only.
                    lib = (f"torch._scaled_mm, row and column scales, "
                           f"{rows} rows, bfloat16 out")
                    lms = time_ms(lambda: torch._scaled_mm(
                        xl, w_cat.t(), scale_a=sl, scale_b=s_cat,
                        out_dtype=torch.bfloat16), flush)
                nbytes = (k * n + m * k + 4 * (m + n)
                          + m * n * torch.empty((), dtype=out).element_size())
                cases.append(dict(
                    kernel=name, shape=group, K=k, N=list(ns), M=m,
                    tolerance=("torch.equal" if qdtype == torch.int8
                               else f"{ATOL} + {RTOL} * |plain|"),
                    tile_n=_kernels.gemm_tile(n),
                    splits=_kernels.gemm_splits(n, k),
                    out=str(out).removeprefix("torch."), max_abs_err=err,
                    ms=time_ms(lambda: launch(m), flush),
                    plain_ms=time_ms(lambda: dg.w8a8_gemm_group_plain(
                        xm, sm, wqs, wss, out), flush),
                    library_ms=lms, library_call=lib, bytes=nbytes,
                    flops=2 * m * k * n, bound_ms=nbytes / bw * 1e3))
            del wqs, wss, w_cat, x, xq
    for c in cases:
        where = (f"{c['shape']} (tile {c['tile_n']}, K split in "
                 f"{c['splits']})" if "shape" in c else c["where"])
        lib = ("not measured" if c["library_ms"] is None
               else f"{c['library_ms']:.4f} ({c['library_call']})")
        print(f"kernel {c['kernel']} {where} M={c['M']}: "
              f"{'torch.equal to' if c['max_abs_err'] == 0 else 'within tolerance of'}"
              f" plain (max_abs_err {c['max_abs_err']:.6g}); kernel_ms="
              f"{c['ms']:.4f} plain_ms={c['plain_ms']:.4f} library_ms={lib}"
              f" bound_ms={c['bound_ms']:.5f} (bytes; share "
              f"{c['bound_ms'] / c['ms']:.4f})", flush=True)
    records = kernel_a_records(cases, bw)
    for suffix, qdtype, infix in W8A8_KINDS:
        for name, source in (("decode_gemm_w8a8", "decode_gemm.cu"),):
            name += suffix
            # A decode tick's five products at M 8, one launch a group.
            mine = [c for c in cases if c["kernel"] == name
                    and c["M"] == 8]
            total = {f: sum(c[f] for c in mine)
                     for f in ("ms", "plain_ms", "bytes", "flops")}
            lms = [c["library_ms"] for c in mine]
            bound_ms = max(total["bytes"] / bw, total["flops"] / (
                W8A8_OPS_FACTOR * peaks[1])) * 1e3
            records.append(dict(
                name=name, route="cuda",
                source=f"triton_kubernetes_tpu_torch/csrc/{source}",
                replaces=(
                    "none: plain XLA ops in the reference's quantized_einsum "
                    "(triton_kubernetes_tpu/ops/quantization.py:265-305)"),
                variant=("tensor_core (mma.sync m16n8k32 s8), one launch "
                         "a group, tile and K split by the shape"
                         if infix == "s8" else "tensor_core (wgmma m64nNk16 "
                         "f16 on e4m3 converted in shared memory, the kernel "
                         "of every M), one launch a group, tile and K split "
                         "by the shape"),
                max_abs_err=max(c["max_abs_err"] for c in cases
                                if c["kernel"] == name),
                tolerance=("torch.equal" if qdtype == torch.int8
                           else f"{ATOL} + {RTOL} * |plain|"),
                ms=total["ms"], plain_ms=total["plain_ms"],
                library_ms=(None if None in lms else sum(lms)),
                library_call=(None if None in lms else mine[0][
                    "library_call"]),
                bound_ms=bound_ms,
                bound_by=("bytes" if total["bytes"] / bw >= total["flops"] / (
                    W8A8_OPS_FACTOR * peaks[1]) else "operations"),
                bound_share=bound_ms / total["ms"],
                achieved_tflops=total["flops"] / (total["ms"] * 1e-3) / 1e12,
                bytes=total["bytes"], flops=total["flops"],
                shape=dict(M=8, summed_over=[c.get("shape", c["K"])
                                             for c in mine]),
                cases=[c for c in cases if c["kernel"] == name]))
        records.append(wgmma_record(
            "decode_gemm_w8a8_wgmma" + suffix, [
                c for c in cases if c["kernel"] == "decode_gemm_w8a8" + suffix],
            bw, W8A8_OPS_FACTOR * peaks[1],
            "torch._int_mm (int32 product alone)" if qdtype == torch.int8
            else "torch._scaled_mm, row and column scales, bfloat16 out",
            "wgmma m64nNk32 s8, M > 64: two warpgroups of 64 rows over two "
            "column tiles, one exact int32 sum" if qdtype == torch.int8 else
            "wgmma m64nNk16 f16 on the e4m3 operands converted in shared "
            "memory, every M (two warpgroups of 64 rows; both convert), "
            "the mma.sync kernel's chains of k steps"))
    return records


def f1_probe(model, cfg):
    """Fault F1's probe: one verify tick's layer input x [8, 4, D] (the
    embeddings of seeded tokens) through each row op of layer 0 and the
    head, once on the 32 rows as the verify step runs them and once on
    each x[:, j] of 8 rows as the decode step does, by the plain torch
    ops and by the row-invariant kernels. Returns {op: (torch bitwise,
    kernels bitwise)}; raises unless every kernel op is."""
    from triton_kubernetes_tpu_torch.models import llama
    from triton_kubernetes_tpu_torch.ops import norms
    from triton_kubernetes_tpu_torch.ops.decode_gemm import decode_gemm

    b, s = SERVE_ENGINE_KW["max_batch"], SPEC_K + 1
    gen = torch.Generator(device=SERVE_DEVICE).manual_seed(61)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=SERVE_DEVICE)
    layer, eps = model.layers[0], cfg.norm_eps
    head = llama.head_weights(model)

    def einsum(spec, w):
        return lambda t: torch.einsum(spec, t, w)

    def kernel_product(spec, w):
        return lambda t: llama._row_products(spec, t, [w])[0]

    def einsums(spec, ws):  # the group's products in turn, side by side
        return lambda t: torch.cat([torch.einsum(spec, t, w).flatten(2)
                                    for w in ws], dim=-1)

    def kernel_group(spec, ws):  # one launch for the group
        return lambda t: torch.cat([y.flatten(2) for y in
                                    llama._row_products(spec, t, ws)],
                                   dim=-1)

    def norm(fn, scale):
        return lambda t: fn(t, scale, eps)

    def head_mm(t):
        return torch.mm(t.reshape(-1, t.shape[-1]), head,
                        out_dtype=torch.float32).reshape(*t.shape[:2], -1)

    def head_kernel(t):
        return decode_gemm(t.reshape(-1, t.shape[-1]).contiguous(), head,
                           torch.float32).reshape(*t.shape[:2], -1)

    with torch.inference_mode():
        x = model.embed[tokens]  # [B, S, D]
        h = norms.rms_norm(x, layer.attn_norm, eps)
        attn = torch.randn((b, s, cfg.num_heads, cfg.head_dim),
                           generator=gen, device=SERVE_DEVICE
                           ).to(x.dtype)
        h2 = norms.rms_norm(x, layer.mlp_norm, eps)
        up = torch.einsum("bsd,df->bsf", h2, layer.w1)
        gate = torch.nn.functional.silu(torch.einsum(
            "bsd,df->bsf", h2, layer.w3).float()).to(x.dtype)
        # op: (input [B, S, ...], plain torch op, kernel op)
        ops = {
            "rms_norm (attn_norm)": (x, norm(norms.rms_norm, layer.attn_norm),
                                     norm(norms.rms_norm_rows,
                                          layer.attn_norm)),
            "wq": (h, einsum("bsd,dhk->bshk", layer.wq),
                   kernel_product("bsd,dhk->bshk", layer.wq)),
            "wk": (h, einsum("bsd,dhk->bshk", layer.wk),
                   kernel_product("bsd,dhk->bshk", layer.wk)),
            "wv": (h, einsum("bsd,dhk->bshk", layer.wv),
                   kernel_product("bsd,dhk->bshk", layer.wv)),
            "wq+wk+wv (one launch)": (
                h, einsums("bsd,dhk->bshk", (layer.wq, layer.wk, layer.wv)),
                kernel_group("bsd,dhk->bshk",
                             (layer.wq, layer.wk, layer.wv))),
            "project_out (wo)": (attn, einsum("bshk,hkd->bsd", layer.wo),
                                 kernel_product("bshk,hkd->bsd", layer.wo)),
            "rms_norm (mlp_norm)": (x, norm(norms.rms_norm, layer.mlp_norm),
                                    norm(norms.rms_norm_rows,
                                         layer.mlp_norm)),
            "w3": (h2, einsum("bsd,df->bsf", layer.w3),
                   kernel_product("bsd,df->bsf", layer.w3)),
            "w1": (h2, einsum("bsd,df->bsf", layer.w1),
                   kernel_product("bsd,df->bsf", layer.w1)),
            "w3+w1 (one launch)": (
                h2, einsums("bsd,df->bsf", (layer.w3, layer.w1)),
                kernel_group("bsd,df->bsf", (layer.w3, layer.w1))),
            "w2": (gate * up, einsum("bsf,fd->bsd", layer.w2),
                   kernel_product("bsf,fd->bsd", layer.w2)),
            "final_norm_hidden": (x, norm(norms.rms_norm, model.final_norm),
                                  norm(norms.rms_norm_rows,
                                       model.final_norm)),
            "unembed mm (f32 out)": (h2, head_mm, head_kernel),
        }
        result = {}
        for op, (inp, plain, kernel) in ops.items():
            same = []
            for fn in (plain, kernel):
                full = fn(inp)
                same.append(all(
                    torch.equal(fn(inp[:, j:j + 1].contiguous())[:, 0],
                                full[:, j]) for j in range(s)))
            result[op] = tuple(same)
    torch.cuda.synchronize()
    print(f"F1 probe (layer 0 and head at width {cfg.embed_dim}; verify's "
          f"{b * s} rows vs "
          "decode's 8 at each j, row for row torch.equal): " + "; ".join(
              f"{op}: torch {'yes' if t else 'NO'}, kernel "
              f"{'yes' if k else 'NO'}" for op, (t, k) in result.items()),
          flush=True)
    bad = [op for op, (_, k) in result.items() if not k]
    if bad:
        raise AssertionError(f"F1 probe: the row-invariant kernels give "
                             f"verify rows other bits than decode rows in "
                             f"{bad}")
    return {op: dict(torch_bitwise=t, kernel_bitwise=k)
            for op, (t, k) in result.items()}


def verify_rows_check(model, cfg, paged):
    """Each verify logits row (b, j) against the decode logits at that
    length, at the serve configuration (max_batch 8 sequences, spec_k 3):
    8 seeded prompts prefilled into one pool, one paged_verify_step on a
    copy of it and four paged_decode_steps on another, fed the same
    tokens. Raises unless every row, and the two pools after, are
    bitwise equal."""
    rng = np.random.default_rng(5)
    dev = SERVE_DEVICE
    b, s = SERVE_ENGINE_KW["max_batch"], SPEC_K + 1
    per = 512 // BS  # pages a sequence: two prefill windows
    cache = paged.init_paged_cache(cfg, 1 + b * per, BS, device=dev)
    tables = (torch.arange(b * per, dtype=torch.int32, device=dev)
              .reshape(b, per) + 1)
    lengths, tokens = [], []
    with torch.inference_mode():
        for i in range(b):
            n = int(rng.integers(100, 512 - s))
            prompt = rng.integers(0, cfg.vocab_size, n).tolist()
            for off in range(0, n, PREFILL_CHUNK):
                clen = min(PREFILL_CHUNK, n - off)
                toks = prompt[off:off + clen] + [0] * (PREFILL_CHUNK - clen)
                logits = paged.paged_prefill_chunk(
                    model, torch.tensor([toks], dtype=torch.int32,
                                        device=dev),
                    off, clen, cfg, cache, tables[i])
            lengths.append(n)
            tokens.append([int(logits.argmax())] + rng.integers(
                0, cfg.vocab_size, s - 1).tolist())
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        tok = torch.tensor(tokens, dtype=torch.int32, device=dev)
        copies = [paged.PagedKVCache(cache.k.clone(), cache.v.clone())
                  for _ in range(3)]
        vcache, dcache = copies[0], paged.PagedKVCache(cache.k, cache.v)
        verify, _ = paged.paged_verify_step(model, tok, cfg, vcache, tables,
                                            lens)
        decode = [paged.paged_decode_step(model, tok[:, j].contiguous(), cfg,
                                          dcache, tables, lens + j)
                  for j in range(s)]
        unfused = unfused_ticks(model, cfg, paged, copies[1:], tok, tables,
                                lens)
    torch.cuda.synchronize()
    fused_equal = {"decode": torch.equal(decode[0], unfused[0]),
                   "verify": torch.equal(verify, unfused[1])}
    print(f"fused vs unfused layer boundaries (one decode tick and one "
          f"verify tick of the same 8 sequences, torch add then the "
          f"delta-null norm kernel at each boundary): logits torch.equal: "
          f"{fused_equal}", flush=True)
    if not all(fused_equal.values()):
        raise AssertionError(f"fused add + norm: logits differ from the "
                             f"unfused composition: {fused_equal}")
    equal = [[bool(torch.equal(verify[i, j], decode[j][i])) for j in
              range(s)] for i in range(b)]
    pools = (torch.equal(vcache.k, dcache.k)
             and torch.equal(vcache.v, dcache.v))
    worst = max(float((verify[:, j] - decode[j]).abs().max())
                for j in range(s))
    print(f"verify rows vs decode ({cfg.num_layers} layers, width "
          f"{cfg.embed_dim}, B {b}, S {s}, "
          f"lengths {lengths}): {sum(map(sum, equal))}/{b * s} logits rows "
          f"torch.equal (max abs diff {worst}), pools after "
          f"{'bitwise equal' if pools else 'DIFFERENT'}", flush=True)
    if not all(map(all, equal)) or not pools:
        raise AssertionError(f"verify rows vs decode: rows equal {equal}, "
                             f"pools equal {pools}: a verify row must be "
                             f"bitwise the decode row at its length")
    del cache, vcache, dcache, copies
    gc.collect()
    torch.cuda.empty_cache()
    return dict(lengths=lengths, rows_equal=b * s, pools_equal=pools,
                fused_logits_equal_unfused=fused_equal)


def unfused_ticks(model, cfg, paged, caches, tok, tables, lens):
    """One decode tick (the first column of ``tok``) on ``caches[0]`` and
    one verify tick on ``caches[1]`` with every layer boundary composed
    unfused: torch's ``x + delta``, then the delta-null norm kernel
    (``rms_norm_rows``) -- the sequence the steps ran before the fusion.
    Returns (decode logits, verify logits)."""
    from triton_kubernetes_tpu_torch.ops import norms

    def add_then_norm(x, delta, scale, eps):
        h = x + delta
        return h, norms.rms_norm_rows(h, scale, eps)

    fused = paged.add_rms_norm_rows
    paged.add_rms_norm_rows = add_then_norm
    try:
        decode = paged.paged_decode_step(model, tok[:, 0].contiguous(), cfg,
                                         caches[0], tables, lens)
        verify, _ = paged.paged_verify_step(model, tok, cfg, caches[1],
                                            tables, lens)
    finally:
        paged.add_rms_norm_rows = fused
    return decode, verify


def make_requests(cfg, Request):
    """8 requests, prompts of 200-1000 tokens from a seeded RNG; r0-r3
    share a 512-token prefix; r5 is sampled, the rest greedy."""
    rng = np.random.default_rng(2024)
    prefix = rng.integers(0, cfg.vocab_size, 512).tolist()
    reqs = []
    for i in range(8):
        if i < 4:
            n = int(rng.integers(600, 1001))
            toks = prefix + rng.integers(0, cfg.vocab_size, n - 512).tolist()
        else:
            n = int(rng.integers(200, 1001))
            toks = rng.integers(0, cfg.vocab_size, n).tolist()
        sampled = dict(temperature=0.8, top_p=0.9, seed=11) if i == 5 else {}
        reqs.append(Request(f"r{i}", toks, SERVE_NEW_TOKENS, **sampled))
    return reqs


def prefill_fresh(model, cfg, prompt, impl, paged, kv_dtype="auto",
                  spare_windows=0):
    """A fresh pool holding one prompt, written by its prefill windows with
    the given attention impl: (logits at the last token, pool, table).
    The table has ``spare_windows`` more windows of pages past the
    prompt's."""
    windows = -(-len(prompt) // PREFILL_CHUNK) + spare_windows
    pages = windows * PREFILL_CHUNK // BS
    cache = paged.init_paged_cache(cfg, pages + 1, BS, kv_dtype=kv_dtype,
                                   device=SERVE_DEVICE)
    table = torch.arange(1, pages + 1, dtype=torch.int32,
                         device=SERVE_DEVICE)
    with torch.inference_mode():
        for off in range(0, len(prompt), PREFILL_CHUNK):
            clen = min(PREFILL_CHUNK, len(prompt) - off)
            toks = prompt[off:off + clen] + [0] * (PREFILL_CHUNK - clen)
            logits = paged.paged_prefill_chunk(
                model, torch.tensor([toks], dtype=torch.int32,
                                    device=SERVE_DEVICE),
                off, clen, cfg, cache, table, attention_impl=impl)
    return logits, cache, table


def first_token_logits(model, cfg, prompt, impl, paged, kv_dtype="auto"):
    """Logits at a prompt's last token through all its prefill windows,
    on a fresh pool, with the given attention impl."""
    return prefill_fresh(model, cfg, prompt, impl, paged, kv_dtype)[0]


# Fault F2's check: one seeded prompt written by windows of each of these
# widths; every full page must hold the same bytes (the reference pins
# "page contents are a function of the tokens alone").
F2_CHUNKS = (128, 256)
F2_PROMPT_TOKENS = 800
# An integer dtype of each element size, to compare tensors' bits.
BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def window_invariance_check(model, cfg, paged, tag, kv_dtype="auto",
                            row_invariant=True):
    """One seeded prompt of :data:`F2_PROMPT_TOKENS` tokens prefilled on a
    fresh pool by windows of each width of :data:`F2_CHUNKS`: counts the
    full pages (K and V of every layer, scales on 8-bit pools) that
    differ between the widths, and profiles each width's windows (device
    busy ms by torch.profiler, wall ms by the host clock, a second pass
    after a warm-up one). ``row_invariant=False`` runs the windows'
    weight products as cuBLAS einsums, as before the repair of F2 (for
    the before/after numbers). Returns the record; the caller asserts."""
    from torch.profiler import ProfilerActivity, profile
    from triton_kubernetes_tpu_torch.models import llama

    rng = np.random.default_rng(31)
    prompt = rng.integers(0, cfg.vocab_size, F2_PROMPT_TOKENS).tolist()
    n, full = len(prompt), len(prompt) // BS
    dev = SERVE_DEVICE
    pools, times = {}, {}
    row_products = llama._row_products
    if not row_invariant:
        llama._row_products = lambda spec, x, ws: [torch.einsum(spec, x, w)
                                                   for w in ws]
    reset_row_counts()
    try:
        for c in F2_CHUNKS:
            windows = -(-n // c)
            cache = paged.init_paged_cache(cfg, windows * c // BS + 1, BS,
                                           kv_dtype=kv_dtype, device=dev)
            table = torch.arange(1, windows * c // BS + 1,
                                 dtype=torch.int32, device=dev)
            toks = [torch.tensor([prompt[off:off + c] + [0] * max(
                0, off + c - n)], dtype=torch.int32, device=dev)
                for off in range(0, n, c)]

            def run():
                with torch.inference_mode():
                    for j, off in enumerate(range(0, n, c)):
                        paged.paged_prefill_chunk(model, toks[j], off,
                                                  min(c, n - off), cfg,
                                                  cache, table)
                torch.cuda.synchronize()

            run()  # warms cuBLAS and the kernels
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                wall = (time.perf_counter() - t0) * 1e3
            times[c] = dict(windows=windows, **tick_profile(
                [prof], windows, wall / windows))
            pools[c] = [t[:, 1:1 + full].view(BITS[t.element_size()])
                        for t in (cache.k, cache.v, cache.k_scale,
                                  cache.v_scale) if t is not None]
    finally:
        llama._row_products = row_products
    counts = row_counts()
    wgmma = counts["decode_gemm_wgmma"] + counts["decode_gemm_w8a8_wgmma"]
    if row_invariant and not wgmma:
        raise AssertionError(f"F2 ({tag}): the windows launched no wgmma "
                             f"GEMM")
    a, b = (pools[c] for c in F2_CHUNKS)
    # A page differs if any layer's K or V bytes (or scale) at it differ.
    differ = torch.zeros(full, dtype=torch.bool, device=dev)
    for x, y in zip(a, b):
        ne = x != y
        differ |= ne.reshape(ne.shape[0], full, -1).any(dim=2).any(dim=0)
    n_differ = int(differ.sum())
    how = ("row-invariant" if row_invariant
           else "cuBLAS einsums, as before the repair")
    print(f"F2 window invariance ({tag}, weight products {how}, "
          f"{cfg.num_layers} layers, prompt {n} tokens, {full} "
          f"full pages, prefill_chunk {F2_CHUNKS[0]} vs {F2_CHUNKS[1]}): "
          f"{n_differ} pages differ, {wgmma} wgmma GEMM launches; a "
          f"window's device busy / wall ms "
          + ", ".join(
              f"C {c}: {t['device_busy_ms_per_tick']:.3f} / "
              f"{t['wall_ms_per_tick']:.3f} ({t['windows']} windows, "
              f"{t['launches_per_tick']:.0f} launches; GEMM ms: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in
                  t["device_ms_per_tick_by_class"].items()
                  if "gemm" in k.lower()) + ")"
              for c, t in times.items()), flush=True)
    del pools, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return dict(tag=tag, row_invariant=row_invariant, prompt_tokens=n,
                full_pages=full, pages_differing=n_differ,
                wgmma_launches=wgmma,
                chunks=list(F2_CHUNKS),
                windows={str(c): t for c, t in times.items()})


# decode_gemm launches made by ops/moe.py while the Mixtral phase's
# counting wrapper (``counting_moe_gemms``) is installed: the router's
# (f32 operands) apart from the experts' (bf16). Zeroed with the
# row-invariant kernels' counters.
MOE_GEMMS = {"router": 0, "experts": 0}


def reset_row_counts():
    from triton_kubernetes_tpu_torch.ops import decode_gemm, norms
    from triton_kubernetes_tpu_torch.ops import quantization
    decode_gemm.reset_launch_counts()
    norms.reset_launch_counts()
    quantization.reset_launch_counts()
    MOE_GEMMS.update(router=0, experts=0)


def row_counts():
    """Launches of the row-invariant kernels since reset_row_counts."""
    return {k: n for k, n in launch_counts().items()
            if not k.startswith("paged_")}


def launch_counts():
    """Launches of every serving kernel since the counters were reset:
    the serving front end's own count (``/stats`` reports it too)."""
    from triton_kubernetes_tpu_torch.serve.server import kernel_launches

    return kernel_launches()


def row_counts_wanted(ticks, windows, cfg, w8a8=None):
    """What ``ticks`` decode or verify ticks and ``windows`` prefill
    windows launch: one launch for each of a layer's four weight-product
    groups (wq+wk+wv, wo, w3+w1, w2), and the lm head (a window's on its
    one last row, the decode GEMM at M 1 as a tick's); a tick and a
    window each one norm of the embeddings and a fused residual add + norm
    at each of the 2 L layer boundaries (the last one's norm the final
    norm). Under W8A8 (``w8a8`` the 8-bit operand dtype) the products are
    ``decode_gemm_w8a8`` launches, and each input is quantized by the
    launch that produces it: the norms' quantizing entries (the same
    counts as the norms') and the fused SwiGLU (one a layer) -- only wo's
    input, the attention's output, by a standalone ``quantize_rows`` (one
    a layer). Of the GEMM launches, those of
    more than 64 rows -- a window's groups, PREFILL_CHUNK rows -- run the
    wgmma kernel (``_kernels.gemm_wgmma``), counted apart too. An MoE
    layer (dropless: an expert's C slots are the step's rows) launches
    wq+wk+wv, wo, the router (f32 operands: never wgmma) and, for each
    of E experts, w3+w1 and w2 (bf16, not W8A8)."""
    from triton_kubernetes_tpu_torch.ops import _kernels

    if cfg.is_moe and w8a8 is not None:
        raise ValueError("the MoE layer's products are never W8A8")
    per_layer = 3 + 2 * cfg.num_experts if cfg.is_moe else 4
    per_window = per_layer * cfg.num_layers
    groups = ticks * (per_window + 1)
    dtype = torch.bfloat16 if w8a8 is None else w8a8
    tick_wg = _kernels.gemm_wgmma(dtype, 1)
    window_wg = _kernels.gemm_wgmma(dtype, PREFILL_CHUNK)
    window_wg_groups = (per_layer - cfg.is_moe) * cfg.num_layers
    want = {"decode_gemm": groups + windows * (per_window + 1),
            "decode_gemm_wgmma": ((groups + windows) * tick_wg
                                  + windows * window_wg_groups * window_wg),
            "decode_gemm_w8a8": 0, "decode_gemm_w8a8_wgmma": 0,
            "quantize_rows": 0,
            "rms_norm": ticks + windows,
            "add_rms_norm": (ticks + windows) * 2 * cfg.num_layers,
            "rms_norm_quant": 0, "add_rms_norm_quant": 0, "swiglu_quant": 0}
    if w8a8 is not None:
        want.update(decode_gemm=0, decode_gemm_wgmma=0,
                    decode_gemm_w8a8=groups + windows * (per_window + 1),
                    decode_gemm_w8a8_wgmma=(groups + windows) * tick_wg
                    + windows * per_window * window_wg,
                    quantize_rows=(ticks + windows) * cfg.num_layers,
                    rms_norm=0, add_rms_norm=0,
                    rms_norm_quant=want["rms_norm"],
                    add_rms_norm_quant=want["add_rms_norm"],
                    swiglu_quant=(ticks + windows) * cfg.num_layers)
    return want


# Kernel classes of a profiled tick: (class, what its kernels' names hold).
TICK_CLASSES = (("paged_decode kernel", "paged_decode_"),
                ("paged_verify kernel", "paged_verify_"),
                ("paged_prefill kernel", "paged_prefill_"),
                ("decode_gemm kernel", "decode_gemm_kernel"),
                ("decode_gemm_f32 kernel", "decode_gemm_f32_kernel"),
                ("decode_gemm_wgmma kernel", "decode_gemm_wgmma_kernel"),
                ("decode_gemm_w8a8 kernel", "decode_gemm_w8a8_kernel"),
                ("decode_gemm_w8a8_wgmma kernel",
                 "decode_gemm_w8a8_wgmma_kernel"),
                ("quantize_rows kernel", "quantize_rows_kernel"),
                ("rms_norm_quant kernel", "rms_norm_quant_kernel"),
                ("swiglu_quant kernel", "swiglu_quant_kernel"),
                ("rms_norm kernel", "rms_norm_kernel"))


def tick_profile(profiles, ticks, wall_ms):
    """Device time per tick by kernel class, launches per tick, the idle
    share against ``wall_ms`` per tick, and the paged kernels' names, from
    the events of one or more torch.profiler runs over ``ticks`` ticks."""
    by_class = {c: 0.0 for c, _ in TICK_CLASSES}
    by_class.update({"GEMM (cuBLAS)": 0.0, "other kernels": 0.0})
    kernels = dict.fromkeys(by_class, 0)
    launches, names, others, device_kernels = 0, set(), {}, 0
    for prof in profiles:
        events = prof.events()
        launches += sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                   "cuLaunchKernelEx") for e in events)
        for e in events:
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            device_kernels += not e.name.startswith(("Memcpy", "Memset"))
            us = e.time_range.elapsed_us()
            cls = next((c for c, key in TICK_CLASSES if key in e.name), None)
            if cls is None:
                cls = ("GEMM (cuBLAS)"
                       if e.name.startswith(("nvjet", "sm90_xmma", "cutlass"))
                       or "gemm" in e.name.lower() else "other kernels")
                if cls == "other kernels":
                    others[e.name[:120]] = others.get(e.name[:120], 0) + 1
            elif cls.startswith("paged_"):
                m = re.search(r"paged_\w+_kernel(<[^()]*>)?", e.name)
                names.add(m.group(0) if m else e.name)
            by_class[cls] += us
            kernels[cls] += 1
    by_class = {k: v / 1e3 / ticks for k, v in by_class.items()}
    busy_ms = sum(by_class.values())
    return dict(wall_ms_per_tick=wall_ms, device_busy_ms_per_tick=busy_ms,
                device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
                launches_per_tick=launches / ticks,
                device_kernels_per_tick=device_kernels / ticks,
                device_ms_per_tick_by_class=by_class,
                kernels_per_tick_by_class={k: v / ticks
                                           for k, v in kernels.items()},
                paged_kernels=sorted(names),
                other_kernels_per_tick={
                    k: v / ticks for k, v in sorted(
                        others.items(), key=lambda kv: -kv[1])[:16]})


# torch.profiler on the card at times drops a few device events from a
# trace (a decode tick's once held 1,492 of its 1,511 kernels), and a check
# that counts a tick's kernels by class would read each lost event as a
# launch that did not happen: such a profile is taken again.
PROFILE_ATTEMPTS = 3


def complete_profile(engine, run):
    """``run()``'s :func:`tick_profile` record, taken again (on a released
    prefix cache) while its trace holds fewer device kernels than the
    launches it recorded, at most PROFILE_ATTEMPTS times; the last is
    returned either way, with the number of attempts."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        if attempt > 1:
            engine.release_prefix_cache()
        prof = run()
        kernels = prof["device_kernels_per_tick"]
        if not kernels or kernels >= prof["launches_per_tick"]:
            break
    return dict(prof, attempts=attempt)


def profile_prefill(engine, cfg, Request, windows_before=2):
    """Where a prefill window's time goes: one 1,000-token prompt alone on
    an idle engine, its third 256-token window (offset 512) run under
    torch.profiler. Returns :func:`tick_profile`'s record of that tick."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(9)
    engine.submit(Request("prefill-profile", rng.integers(
        0, cfg.vocab_size, 1000).tolist(), 2))
    for _ in range(windows_before):
        engine.step()
    before = engine.stats()
    torch.cuda.synchronize()
    reset_row_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = row_counts()
    after = engine.stats()
    if (after["prefill_windows"] != before["prefill_windows"] + 1
            or after["decode_steps"] != before["decode_steps"]):
        raise AssertionError("profile: the profiled tick was not one "
                             "prefill window alone")
    wgmma = counts["decode_gemm_wgmma"] + counts["decode_gemm_w8a8_wgmma"]
    if not wgmma:
        raise AssertionError("profile: the prefill window launched no wgmma "
                             "GEMM")
    engine.run_until_idle()
    return dict(tick_profile([prof], 1, wall_ms), wgmma_launches=wgmma,
                row_launches_per_tick=counts)


def profile_decode(engine, cfg, Request, ticks=4):
    """Where a decode tick's time goes: 8 sequences of 600-token prompts
    decoding, ``ticks`` decode-only ticks under torch.profiler. Returns
    :func:`tick_profile`'s record."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(7)
    # Long enough that no sequence finishes while the others still
    # prefill (one 256-token window per tick, three per prompt).
    new_tokens = 3 * engine.max_batch + ticks + 8
    for i in range(engine.max_batch):
        engine.submit(Request(f"p{i}", rng.integers(
            0, cfg.vocab_size, 600).tolist(), new_tokens))
    for _ in range(new_tokens):
        if all(s is not None and s.prefilled >= s.target
               for s in engine.slots):
            break
        engine.step()
    else:
        raise AssertionError("profile: the batch never reached decode")
    engine.step()
    torch.cuda.synchronize()
    reset_row_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    counts = dict(row_counts(), **{f"moe_{k}": n
                                   for k, n in MOE_GEMMS.items()})
    engine.run_until_idle()
    return dict(tick_profile([prof], ticks, wall_ms),
                row_launches_per_tick={k: v / ticks
                                       for k, v in counts.items()})


def profile_verify(model, cfg, Request, ticks=2, max_steps=60):
    """Where a verify tick's time goes: a spec_k 3 engine on bf16 pages,
    8 sequences of one seeded token tiled 600 times (so the model repeats
    itself and the drafter proposes), each tick after prefill run under
    its own torch.profiler; the first ``ticks`` ticks that verified are
    kept. Returns :func:`tick_profile`'s record of those ticks."""
    from torch.profiler import ProfilerActivity, profile
    from triton_kubernetes_tpu_torch.serve import ServeEngine

    engine = ServeEngine(model, cfg, device=SERVE_DEVICE,
                         **dict(SERVE_ENGINE_KW, spec_k=SPEC_K))
    rng = np.random.default_rng(8)
    # Enough new tokens that no sequence finishes, even accepting every
    # draft, before the last one has prefilled and the kept ticks ran.
    new_tokens = (SPEC_K + 1) * (3 * engine.max_batch + max_steps)
    for i in range(engine.max_batch):
        engine.submit(Request(f"v{i}", [int(rng.integers(
            0, cfg.vocab_size))] * 600, new_tokens))
    for _ in range(max_steps):
        if all(s is not None and s.prefilled >= s.target
               for s in engine.slots):
            break
        engine.step()
    else:
        raise AssertionError("profile: the batch never reached decode")
    profiles, walls = [], []
    for _ in range(max_steps):
        if len(profiles) == ticks or not engine.has_work:
            break
        before = engine.stats()["verify_steps"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        if engine.stats()["verify_steps"] > before:
            profiles.append(prof)
            walls.append(wall)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    if not profiles:
        raise AssertionError("profile: no tick verified a draft")
    return tick_profile(profiles, len(profiles), statistics.mean(walls))


def print_tick_profile(what, prof, card):
    if prof["device_idle_share"] is None:
        print(f"serve: {what} profile: the profiler saw no device kernels; "
              f"device time not measured", flush=True)
        return
    classes = ", ".join(
        f"{k} {v:.3f} ms ({prof['kernels_per_tick_by_class'][k]:.0f} "
        f"kernels)" for k, v in prof["device_ms_per_tick_by_class"].items())
    print(f"serve: {what} profiled: wall {prof['wall_ms_per_tick']:.3f} ms, "
          f"device busy {prof['device_busy_ms_per_tick']:.3f} ms (idle "
          f"share {prof['device_idle_share']:.3f}), "
          f"{prof['launches_per_tick']:.0f} launches, "
          f"{prof['device_kernels_per_tick']:.2f} kernels in the trace"
          f"{' (attempt %d)' % prof['attempts'] if 'attempts' in prof else ''}"
          f"; {classes}; paged kernels {prof['paged_kernels']} [{card}]",
          flush=True)


# Phase 4's serve run: the requests of make_requests submitted at these
# ticks (request indices by tick).
SERVE_ARRIVALS = {0: [0, 4, 5], 5: [1, 2, 3], 6: [6, 7]}


def serve_ticks(engine, requests, arrivals=SERVE_ARRIVALS):
    """Phase 4's serve run on a warmed engine: submits ``requests`` at
    their ticks and steps the engine until it drains, timing each tick by
    what it ran. Returns the finished requests by id, the ticks' ms by
    kind, and the run's wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, tick = {}, 0
    tick_ms = {"decode only": [], "prefill window + decode": [],
               "prefill window only": []}
    while engine.has_work or tick <= max(arrivals):
        for i in arrivals.get(tick, []):
            engine.submit(requests[i])
        before = engine.stats()
        t_tick = time.perf_counter()
        for d in engine.step():
            done[d.request_id] = d
        torch.cuda.synchronize()
        after = engine.stats()
        window = after["prefill_windows"] > before["prefill_windows"]
        decode = after["decode_steps"] > before["decode_steps"]
        kind = ("prefill window + decode" if window and decode else
                "prefill window only" if window else "decode only")
        tick_ms[kind].append((time.perf_counter() - t_tick) * 1e3)
        tick += 1
        if tick > 10_000:
            raise AssertionError("engine did not drain")
    return done, tick_ms, time.perf_counter() - t0


def serve_phase(card):
    from triton_kubernetes_tpu_torch.models import get_config, init_params
    from triton_kubernetes_tpu_torch.models import paged
    from triton_kubernetes_tpu_torch.ops import paged_attention as pa
    from triton_kubernetes_tpu_torch.serve import Request, ServeEngine
    from triton_kubernetes_tpu_torch.utils import metrics

    cfg = get_config("llama3-8b")
    t0 = t_part = time.perf_counter()
    model = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"serve: llama3-8b {cfg.num_layers} layers, width {cfg.embed_dim},"
          f" vocab {cfg.vocab_size}: {cfg.num_params() / 1e9:.3f}B bf16 "
          f"params initialised in {time.perf_counter() - t0:.1f} s", flush=True)
    probe_ops = f1_probe(model, cfg)
    rows_check = verify_rows_check(model, cfg, paged)
    engine_kw = SERVE_ENGINE_KW
    engine = ServeEngine(model, cfg, **engine_kw)

    # Warm-up (cuBLAS handles, first launches), then a clean slate.
    engine.submit(Request("warmup", list(range(1, 65)), 2))
    engine.run_until_idle()
    engine.release_prefix_cache()
    metrics.configure()
    base = engine.stats()
    requests = make_requests(cfg, Request)

    reset_row_counts()
    pa.reset_launch_counts()
    done, tick_ms, wall = serve_ticks(engine, requests)
    launches = {"paged_decode": pa.ragged_paged_attention.launches,
                "paged_prefill": pa.paged_prefill_attention.launches,
                **row_counts()}
    stats = engine.stats()
    windows = stats["prefill_windows"] - base["prefill_windows"]
    ticks = stats["decode_steps"] - base["decode_steps"]

    for r in requests:
        d = done[r.request_id]
        if (len(d.tokens) != SERVE_NEW_TOKENS
                or d.finish_reason != "length"):
            raise AssertionError(f"{r.request_id}: {len(d.tokens)} tokens, "
                                 f"{d.finish_reason}")
        if not all(0 <= t < cfg.vocab_size for t in d.tokens):
            raise AssertionError(f"{r.request_id}: token outside the vocab")
    hits = metrics.counter("tk8s_serve_prefix_hit_tokens_total").value()
    if hits <= 0:
        raise AssertionError("no prefix-cache hit")
    engine.release_prefix_cache()
    if engine.allocator.in_use != 0:
        raise AssertionError(f"{engine.allocator.in_use} pages leaked")
    want = {"paged_prefill": windows * cfg.num_layers,
            "paged_decode": ticks * cfg.num_layers,
            **row_counts_wanted(ticks, windows, cfg)}
    if launches != want or not all(launches[k] for k in want if k not in (
            "decode_gemm_w8a8", "decode_gemm_w8a8_wgmma", "quantize_rows",
            "rms_norm_quant", "add_rms_norm_quant", "swiglu_quant")):
        raise AssertionError(f"launch counts {launches} != expected {want}")

    ttft = [done[r.request_id].ttft for r in requests]
    tpot = [done[r.request_id].tpot for r in requests]
    generated = sum(len(done[r.request_id].tokens) for r in requests)
    prompt_tokens = sum(len(r.tokens) for r in requests)
    print(f"serve: {len(requests)} requests, {prompt_tokens} prompt tokens "
          f"({int(hits)} from the prefix cache), {windows} prefill windows, "
          f"{ticks} decode ticks, launches {launches}", flush=True)
    for kind, ms in tick_ms.items():
        if ms:
            print(f"serve: {len(ms)} ticks {kind}: median "
                  f"{statistics.median(ms):.3f} ms, max {max(ms):.3f} ms",
                  flush=True)
    print(f"serve: TTFT median {statistics.median(ttft):.4f} s max "
          f"{max(ttft):.4f} s, TPOT median {statistics.median(tpot):.5f} s, "
          f"{generated / wall:.2f} generated tokens/s over {wall:.3f} s "
          f"[{card}]", flush=True)

    # Cross-check one greedy request against the plain versions.
    probe = requests[4]
    lk = first_token_logits(model, cfg, probe.tokens, None, paged)
    ld = first_token_logits(model, cfg, probe.tokens, "dense", paged)
    if lk.shape != (cfg.vocab_size,) or not bool(torch.isfinite(lk).all()):
        raise AssertionError("first-token logits not finite or misshapen")
    # Noise floor: the whole-prompt prefill (dense causal attention, a
    # different but equally valid bf16 rounding order) against the plain
    # chunked path -- how far two correct bf16 paths drift apart.
    n = len(probe.tokens)
    width = -(-n // BS) * BS
    floor_cache = paged.init_paged_cache(cfg, width // BS + 1, BS,
                                         device="cuda")
    with torch.inference_mode():
        lw = paged.paged_prefill(
            model, torch.tensor([probe.tokens + [0] * (width - n)],
                                dtype=torch.int32, device="cuda"),
            n, cfg, floor_cache,
            torch.arange(1, width // BS + 1, dtype=torch.int32,
                         device="cuda"))
    floor_rel_l2 = float((lw - ld).norm() / ld.norm())
    logit_err = float((lk - ld).abs().max())
    logit_max = float(ld.abs().max())
    rel_l2 = float((lk - ld).norm() / ld.norm())
    if rel_l2 > LOGITS_REL_L2 or logit_err > LOGITS_REL_MAX * logit_max:
        raise AssertionError(
            f"first-token logits: kernels vs plain differ by {logit_err} "
            f"(max |logit| {logit_max}), relative L2 {rel_l2}; bounds "
            f"{LOGITS_REL_MAX} * max |logit| and {LOGITS_REL_L2}")
    dense = ServeEngine(model, get_config("llama3-8b", attention="dense"),
                        **dict(engine_kw, num_blocks=256))
    dense.submit(Request(probe.request_id, list(probe.tokens),
                         SERVE_NEW_TOKENS))
    ref = dense.run_until_idle()[0].tokens
    got = done[probe.request_id].tokens
    same = sum(a == b for a, b in zip(got, ref))
    top2 = torch.topk(ld, 2).values
    gap = float(top2[0] - top2[1])
    print(f"serve: {probe.request_id} first-token logits kernels vs plain: "
          f"max abs diff {logit_err:.5f} (bound {LOGITS_REL_MAX} * max "
          f"|logit| {logit_max:.4f}), relative L2 {rel_l2:.5f} (bound "
          f"{LOGITS_REL_L2}; two plain bf16 paths differ by {floor_rel_l2:.5f})"
          f", same argmax: {int(lk.argmax()) == int(ld.argmax())}"
          f" (plain top-2 gap {gap:.5f}); {same}/{SERVE_NEW_TOKENS} tokens "
          f"equal to the "
          f"plain-version engine", flush=True)
    pprof = complete_profile(
        engine, lambda: profile_prefill(engine, cfg, Request))
    print_tick_profile(f"prefill window ({PREFILL_CHUNK} tokens at offset "
                       f"{2 * PREFILL_CHUNK}, one sequence)", pprof, card)
    prof = complete_profile(
        engine, lambda: profile_decode(engine, cfg, Request))
    del engine, dense
    gc.collect()
    torch.cuda.empty_cache()
    print_tick_profile("decode tick (8 x ~600-token contexts)", prof, card)
    vprof = profile_verify(model, cfg, Request)
    print_tick_profile(f"verify tick (spec_k {SPEC_K}, bf16 pages, 8 x "
                       f"~600-token contexts)", vprof, card)
    # The span walk runs the main path's ticks, and the profiles show it by
    # name (when the profiler sees the device at all).
    for what, p, key in (("decode", prof, "paged_decode_span_kernel"),
                         ("verify", vprof, "paged_verify_span_kernel"),
                         ("prefill", pprof, "paged_prefill_mma_kernel")):
        if p["device_idle_share"] is not None and not any(
                n.startswith(key) for n in p["paged_kernels"]):
            raise AssertionError(f"{what} tick profile: no {key} among "
                                 f"{p['paged_kernels']}")
    # A decode tick and a prefill window run the norm kernel once a layer
    # boundary and once on the embeddings, nothing else.
    for what, p in (("decode", prof), ("prefill", pprof)):
        norms_run = p["kernels_per_tick_by_class"]["rms_norm kernel"]
        if p["device_idle_share"] is not None and (
                norms_run != 2 * cfg.num_layers + 1):
            raise AssertionError(f"{what} tick profile: {norms_run} norm "
                                 f"kernels a tick, not "
                                 f"{2 * cfg.num_layers + 1}")
    phase_done("4 serve: probes, engine run, profiles", t_part)
    t_part = time.perf_counter()
    runs = spec_quant_phase(model, cfg, card, requests)
    phase_done("4 serve: spec/quant runs", t_part)
    # Tracing and migration, on the 12 requests of those runs, which are
    # their baselines.
    t_new = time.perf_counter()
    traced, tracing_cost = traced_phase(model, cfg, card, requests, runs)
    migrations, migration = migration_phase(model, cfg, card, requests, runs)
    new_phases_s = phase_done("4 serve: traced and migration runs", t_new)
    t_part = time.perf_counter()
    http = http_phase(model, cfg, card, requests, runs)
    phase_done("4 serve: HTTP", t_part)
    t_part = time.perf_counter()
    probes = [rewind_probe(model, cfg, kind, requests[4].tokens)
              for kind in ("bf16", "int8")]
    # Fault F2: full pages the same under two window widths; the cuBLAS
    # products of the windows before the repair, for scale (not asserted).
    f2 = [window_invariance_check(model, cfg, paged, "bf16 weights, bf16 "
                                  "pages", row_invariant=False),
          window_invariance_check(model, cfg, paged, "bf16 weights, bf16 "
                                  "pages")]
    if f2[1]["pages_differing"]:
        raise AssertionError(f"F2: {f2[1]['pages_differing']} full pages "
                             f"differ between prefill_chunk {F2_CHUNKS}")
    phase_done("4 serve: rewind and F2 checks", t_part)
    t_part = time.perf_counter()
    w8a8_runs, w8a8 = w8a8_phase(model, cfg, card, requests, lk)
    runs += w8a8_runs
    phase_done("4 serve: W8A8 runs", t_part)
    peak = torch.cuda.max_memory_allocated()
    return launches, dict(
        f1_probe=probe_ops, verify_rows_vs_decode=rows_check,
        spec_quant_runs=runs, rewind_probes=probes, traced_runs=traced,
        tracing_cost_us=tracing_cost,
        migration_runs=migrations, migration=migration,
        traced_and_migration_s=new_phases_s, http=http,
        window_invariance=f2 + w8a8.pop("window_invariance"), w8a8=w8a8,
        requests=len(requests), prompt_tokens=prompt_tokens,
        prefix_hit_tokens=hits, prefill_windows=windows, decode_ticks=ticks,
        launches=launches, wall_s=wall, ttft_s=ttft, tpot_s=tpot,
        generated_tokens=generated, tokens_per_s=generated / wall,
        first_token_logit_max_abs_diff=logit_err,
        first_token_logit_max_abs=logit_max,
        first_token_logit_rel_l2=rel_l2,
        first_token_plain_top2_gap=gap,
        first_token_plain_paths_rel_l2=floor_rel_l2,
        tick_ms=tick_ms,
        prefill_window_profile=pprof, decode_tick_profile=prof,
        verify_tick_profile=vprof,
        tokens_equal_to_plain_engine=same,
        peak_memory_bytes=peak)


def migration_only(card, http_only=False):
    """``--migration-only``: the 8B model, the six spec/quant serve runs
    (the baselines), then the traced and the migration runs;
    ``--http-only`` (``http_only``): the baselines, then the HTTP phase."""
    from triton_kubernetes_tpu_torch.models import get_config, init_params
    from triton_kubernetes_tpu_torch.serve import Request

    cfg = get_config("llama3-8b")
    model = init_params(cfg, seed=0, device="cuda")
    requests = make_requests(cfg, Request)
    runs = spec_quant_phase(model, cfg, card, requests)
    if http_only:
        return dict(spec_quant_runs=runs,
                    http=http_phase(model, cfg, card, requests, runs))
    t0 = time.perf_counter()
    traced, tracing_cost = traced_phase(model, cfg, card, requests, runs)
    migrations, migration = migration_phase(model, cfg, card, requests, runs)
    took = time.perf_counter() - t0
    print(f"serve: the traced and migration runs took {took:.1f} s "
          f"[{card}]", flush=True)
    return dict(spec_quant_runs=runs, traced_runs=traced,
                tracing_cost_us=tracing_cost, migration_runs=migrations, migration=migration,
                traced_and_migration_s=took)


def w8a8_only(card):
    """``--w8a8-only``: the 8B model, the bf16 kernels' first-token logits
    of the probe, and :func:`w8a8_logits_check` for int8 and fp8: the
    per-layer readings, without the serve runs."""
    from triton_kubernetes_tpu_torch.models import (get_config, init_params,
                                                    paged, quantize_weights)
    from triton_kubernetes_tpu_torch.serve import Request

    cfg = get_config("llama3-8b")
    model = init_params(cfg, seed=0, device="cuda")
    requests = make_requests(cfg, Request)
    probe = requests[4].tokens
    with torch.inference_mode():
        bf16_logits = first_token_logits(model, cfg, probe, None, paged)
    out = {}
    for wd in ("int8", "fp8"):
        qmodel = quantize_weights(model, wd)
        qcfg = dataclasses.replace(cfg, weight_quant=wd, matmul_dtype=wd)
        out[wd] = w8a8_logits_check(qmodel, qcfg, probe, bf16_logits, wd,
                                    card, requests[4].request_id)
        del qmodel
        gc.collect()
        torch.cuda.empty_cache()
    return out


def repetitive_requests(cfg, Request):
    """4 prompts of 300-700 copies of one seeded token: a motif tiled so far
    that this random-weight model settles into repeating its own output,
    which the n-gram drafter then proposes. (Tiled random motifs of 4-32
    tokens, and motifs of the model's own greedy continuation, gave it
    nothing to draft in 32 tokens on the H100: with random weights the
    continuation never repeats the prompt.)"""
    rng = np.random.default_rng(77)
    return [Request(f"m{i}", [int(rng.integers(0, cfg.vocab_size))]
                    * int(rng.integers(300, 701)), SERVE_NEW_TOKENS)
            for i in range(4)]


# When each of the 12 requests of the spec/quant, traced and migration runs
# arrives (tick: request indices).
SPEC_ARRIVALS = {0: [0, 4, 5, 8, 9], 5: [1, 2, 3], 6: [6, 7, 10, 11]}


def serve_run(model, cfg, kind, spec_k, requests, arrivals,
              weights=("auto", "auto"), traced=None):
    """One engine run of ``requests`` on a pool of ``kind`` pages with
    ``spec_k`` and ``weights`` = (weight_dtype, matmul_dtype); the
    kernels' launch counts are zeroed just before it and read just after.
    Checks completions, pool drain, launches = ticks x layers for each
    kernel, drafts where speculating and a finite quant error on 8-bit
    pools. ``traced`` (a JSONL path) attaches a ``FlightRecorder`` with a
    ``TraceWriter`` there and a ``GoodputRecorder("serve")`` on the same
    writer after the warm-up; the record then carries each request's
    phases and the goodput snapshot. Returns the run's record."""
    from triton_kubernetes_tpu_torch.ops import paged_attention as pa
    from triton_kubernetes_tpu_torch.serve import Request, ServeEngine
    from triton_kubernetes_tpu_torch.utils import metrics
    from triton_kubernetes_tpu_torch.utils import trace

    engine = ServeEngine(model, cfg, device=SERVE_DEVICE, **dict(
        SERVE_ENGINE_KW, kv_dtype="auto" if kind == "bf16" else kind,
        spec_k=spec_k, weight_dtype=weights[0], matmul_dtype=weights[1]))
    w8a8 = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(weights[1])
    engine.submit(Request("warmup", list(range(1, 65)), 2))
    engine.run_until_idle()
    engine.release_prefix_cache()
    metrics.configure()
    base = engine.stats()
    writer = goodput = None
    if traced is not None:
        writer = trace.TraceWriter(str(traced), "replica-0")
        engine.flight = trace.FlightRecorder(writer=writer)
        engine.goodput = goodput = trace.GoodputRecorder("serve",
                                                         writer=writer)
    pa.reset_launch_counts()
    reset_row_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, tick, per_verify = {}, 0, []
    while engine.has_work or tick <= max(arrivals):
        for i in arrivals.get(tick, []):
            engine.submit(requests[i])
        # The counter itself: stats() would also snapshot the recorder.
        verifies = engine._verify_steps
        for d in engine.step():
            done[d.request_id] = d
        if engine._verify_steps > verifies:
            per_verify.append(metrics.gauge(
                "tk8s_serve_spec_tokens_per_step").value())
        tick += 1
        if tick > 10_000:
            raise AssertionError("engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if traced is not None:
        goodput.close()
        writer.close()
    launches = launch_counts()
    stats = engine.stats()
    counts = {k: stats[k] - base[k] for k in
              ("prefill_windows", "decode_steps", "verify_steps")}
    tag = f"{kind} pages, weights {weights}, spec_k={spec_k}"
    for r in requests:
        d = done[r.request_id]
        if len(d.tokens) != r.max_new_tokens or d.finish_reason != "length":
            raise AssertionError(f"{tag}: {r.request_id}: {len(d.tokens)} "
                                 f"tokens, {d.finish_reason}")
        if not all(0 <= t < cfg.vocab_size for t in d.tokens):
            raise AssertionError(f"{tag}: {r.request_id}: token outside "
                                 f"the vocab")
    engine.release_prefix_cache()
    if engine.allocator.in_use != 0:
        raise AssertionError(f"{tag}: {engine.allocator.in_use} pages "
                             f"leaked")
    want = {"paged_prefill": counts["prefill_windows"] * cfg.num_layers,
            "paged_decode": counts["decode_steps"] * cfg.num_layers,
            "paged_verify": counts["verify_steps"] * cfg.num_layers,
            **row_counts_wanted(counts["decode_steps"]
                                + counts["verify_steps"],
                                counts["prefill_windows"], cfg, w8a8)}
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches} != "
                             f"expected {want}")
    proposed = metrics.counter("tk8s_serve_spec_proposed_tokens_total"
                               ).value()
    accepted = metrics.counter("tk8s_serve_spec_accepted_tokens_total"
                               ).value()
    if spec_k and not (proposed > 0 and counts["verify_steps"] > 0):
        raise AssertionError(f"{tag}: the drafter never proposed")
    quant_err = {t: metrics.gauge("tk8s_serve_quant_error").value(tensor=t)
                 for t in ("k", "v")}
    if kind != "bf16" and not all(np.isfinite(e) and e > 0
                                  for e in quant_err.values()):
        raise AssertionError(f"{tag}: quant error {quant_err}")
    pool_bytes = stats["kv_pool_bytes"]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    ttft = [done[r.request_id].ttft for r in requests]
    tpot = [done[r.request_id].tpot for r in requests]
    generated = sum(len(done[r.request_id].tokens) for r in requests)
    extra = {}
    if traced is not None:
        extra = dict(
            phases={r.request_id: done[r.request_id].phases
                    for r in requests},
            phase_sum_err=max(
                abs(sum(done[r.request_id].phases.values())
                    - (done[r.request_id].finished_at
                       - done[r.request_id].submitted_at))
                for r in requests),
            goodput=goodput.snapshot(),
            goodput_sum_err=abs(goodput.accounted_seconds()
                                - goodput.wall_seconds()))
    return dict(
        kind=kind, weights=list(weights), spec_k=spec_k, launches=launches,
        **counts, ticks=tick, **extra,
        wall_s=wall, ttft_s=ttft, tpot_s=tpot, generated_tokens=generated,
        tokens_per_s=generated / wall, proposed=proposed, accepted=accepted,
        accept_rate=accepted / proposed if proposed else None,
        tokens_per_seq_per_verify=(statistics.mean(per_verify)
                                   if per_verify else None),
        quant_error=quant_err, kv_pool_bytes=pool_bytes,
        tokens={r.request_id: done[r.request_id].tokens for r in requests})


def spec_quant_phase(model, cfg, card, requests):
    """The serve runs of this slice: bf16, int8 and fp8 pools, each with
    spec_k 0 and 3, on the 8 requests plus 4 repetitive ones. Prints each
    run's numbers, its tokens against the spec-off run of its pool kind,
    and checks the 8-bit kernels'
    first-token logits against the plain versions on the same pool kind.
    Every token of a spec_k 3 run must equal its spec-off run's: verify
    rows are bitwise decode rows, so speculation changes no greedy token
    (the sampled request draws with the same (seed, position) keys)."""
    from triton_kubernetes_tpu_torch.models import paged
    from triton_kubernetes_tpu_torch.serve import Request

    reqs = list(requests) + repetitive_requests(cfg, Request)
    arrivals = SPEC_ARRIVALS
    runs = []
    for kind in KV_KINDS:
        for spec_k in (0, SPEC_K):
            run = serve_run(model, cfg, kind, spec_k, reqs, arrivals)
            runs.append(run)
            agree = ""
            if spec_k:
                off, got = runs[-2]["tokens"], run["tokens"]
                run["tokens_equal_to_spec_off"] = sum(
                    x == y for r in reqs
                    for x, y in zip(got[r.request_id], off[r.request_id]))
                run["first_differences_from_spec_off"] = [
                    f"{r.request_id}@{i}" for r in reqs
                    for i, (x, y) in enumerate(zip(got[r.request_id],
                                                   off[r.request_id]))
                    if x != y and got[r.request_id][:i] == off[r.request_id][:i]]
                agree = (f"; {run['tokens_equal_to_spec_off']}/"
                         f"{run['generated_tokens']} tokens equal to "
                         f"spec_k=0 on {kind} pages, first differences "
                         f"{run['first_differences_from_spec_off']}")
                if run["tokens_equal_to_spec_off"] != run["generated_tokens"]:
                    raise AssertionError(
                        f"{kind} spec_k={spec_k}: greedy tokens must equal "
                        f"the spec_k=0 run's (the reference's pin)"
                        + agree)
            print_serve_run(f"{kind} pages", run, reqs,
                            runs[0]["kv_pool_bytes"], card, agree)
        if kind == "bf16":
            continue
        probe = requests[4].tokens
        lk = first_token_logits(model, cfg, probe, None, paged, kind)
        ld = first_token_logits(model, cfg, probe, "dense", paged, kind)
        err = rel_l2(lk, ld)
        if not bool(torch.isfinite(lk).all()) or err > LOGITS_REL_L2:
            raise AssertionError(
                f"{kind} first-token logits: kernels vs plain relative L2 "
                f"{err} (bound {LOGITS_REL_L2})")
        runs[-1]["first_token_logits_rel_l2_vs_plain"] = err
        print(f"serve[{kind} pages]: {requests[4].request_id} first-token "
              f"logits, kernels vs plain on {kind} pages: relative L2 "
              f"{err:.5f} (bound {LOGITS_REL_L2}), same argmax: "
              f"{int(lk.argmax()) == int(ld.argmax())}", flush=True)
    return runs


def tokens_equal(run, base, reqs):
    """How many of ``run``'s tokens equal ``base``'s, position by position
    (and the first differing positions)."""
    same, first = 0, []
    for r in reqs:
        got, want = run["tokens"][r.request_id], base["tokens"][r.request_id]
        same += sum(x == y for x, y in zip(got, want))
        if got != want:
            first.append(f"{r.request_id}@" + str(next(
                (i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                min(len(got), len(want)))))
    return same, first


def baseline_run(runs, kind, spec_k):
    return next(r for r in runs if r["kind"] == kind
                and r["spec_k"] == spec_k and r["weights"] == ["auto", "auto"])


def traced_phase(model, cfg, card, requests, runs):
    """The 12 requests again on bf16 pages at spec_k 0 and 3, with a
    ``FlightRecorder`` writing JSONL and a serve ``GoodputRecorder``: tokens
    and every kernel's launches must equal the untraced run's (the recorder
    adds no device work), each request's phases must sum to its e2e, the
    goodput categories to the recorder's wall time, and the trace must pass
    the goodput partition check and, merged, the Chrome-trace validator.
    Prints the wall ms per tick traced against untraced, the useful share
    and the category seconds (not asserted)."""
    from triton_kubernetes_tpu_torch.serve import Request
    from triton_kubernetes_tpu_torch.utils import trace

    reqs = list(requests) + repetitive_requests(cfg, Request)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for spec_k in (0, SPEC_K):
            base = baseline_run(runs, "bf16", spec_k)
            path = Path(tmp) / f"serve_spec{spec_k}.jsonl"
            run = serve_run(model, cfg, "bf16", spec_k, reqs, SPEC_ARRIVALS,
                            traced=path)
            tag = f"traced bf16 pages, spec_k={spec_k}"
            same, first = tokens_equal(run, base, reqs)
            if same != run["generated_tokens"]:
                raise AssertionError(f"{tag}: {same}/{run['generated_tokens']}"
                                     f" tokens equal to untraced, first "
                                     f"differences {first}")
            if run["launches"] != base["launches"]:
                raise AssertionError(f"{tag}: launches {run['launches']} != "
                                     f"untraced {base['launches']}")
            if run["phase_sum_err"] > 1e-9:
                raise AssertionError(f"{tag}: phases miss e2e by "
                                     f"{run['phase_sum_err']} s")
            if run["goodput_sum_err"] > 1e-6:
                raise AssertionError(f"{tag}: goodput categories miss the "
                                     f"wall by {run['goodput_sum_err']} s")
            problems = trace.validate_goodput_trace([str(path)])
            problems += trace.validate_chrome_trace(
                trace.merge_trace_files([str(path)]))
            if problems:
                raise AssertionError(f"{tag}: trace problems {problems[:5]}")
            chaos = trace.validate_chaos_trace([str(path)])
            summary = trace.summarize_goodput([str(path)])["processes"][0]
            lines = sum(1 for _ in open(path))
            traced_ms = run["wall_s"] / run["ticks"] * 1e3
            plain_ms = base["wall_s"] / base["ticks"] * 1e3
            cats = ", ".join(f"{c} {v:.4f} s"
                             for c, v in summary["seconds"].items())
            print(f"serve[{tag}]: {same}/{run['generated_tokens']} tokens "
                  f"and every launch count equal to untraced; wall per tick "
                  f"{traced_ms:.3f} ms traced vs {plain_ms:.3f} ms untraced "
                  f"({run['ticks']} / {base['ticks']} ticks), {lines} trace "
                  f"lines, phases sum to e2e within "
                  f"{run['phase_sum_err']:.3g} s; goodput useful share "
                  f"{summary['useful_fraction']:.4f}: {cats} (wall "
                  f"{summary['wall_s']:.4f} s); chaos-trace check problems: "
                  f"{len(chaos)} [{card}]", flush=True)
            out.append(dict(
                spec_k=spec_k, trace_lines_per_tick=lines / run["ticks"],
                tokens_equal=same, launches=run["launches"],
                ticks=run["ticks"], untraced_ticks=base["ticks"],
                wall_s=run["wall_s"], untraced_wall_s=base["wall_s"],
                wall_ms_per_tick=traced_ms,
                untraced_wall_ms_per_tick=plain_ms, trace_lines=lines,
                phase_sum_err=run["phase_sum_err"],
                goodput_sum_err=run["goodput_sum_err"],
                goodput=summary, chaos_problems=chaos[:5],
                ttft_s=run["ttft_s"], tpot_s=run["tpot_s"]))
    cost = tracing_cost_us()
    for run in out:
        run["tracing_host_us_per_tick"] = (run["trace_lines_per_tick"]
                                           * cost["us_per_line"])
    print(f"serve: the recorder's host cost on this machine: "
          f"{cost['us_per_event']:.2f} us a request event, "
          f"{cost['us_per_transition']:.2f} us a goodput segment (span + "
          f"counter); at "
          + " / ".join(f"{r['trace_lines_per_tick']:.2f}" for r in out)
          + " lines a tick (spec_k 0 / 3): "
          + " / ".join(f"{r['tracing_host_us_per_tick']:.1f}" for r in out)
          + f" us a tick [{card}]", flush=True)
    return out, cost


def tracing_cost_us(n=20_000):
    """The host's cost of the recorder alone: ``n`` request events through
    a ``FlightRecorder`` with a ``TraceWriter``, and ``n`` goodput segments
    (a span line and a counter tick each), per call."""
    from triton_kubernetes_tpu_torch.utils import trace

    with tempfile.TemporaryDirectory() as tmp:
        w = trace.TraceWriter(str(Path(tmp) / "cost.jsonl"), "cost")
        fr = trace.FlightRecorder(writer=w)
        fr.begin("r0", "t0", 0.0)
        t0 = time.perf_counter()
        for i in range(n):
            fr.event("r0", "serve.verify", float(i), proposed=3, accepted=1)
        event = (time.perf_counter() - t0) / n * 1e6
        g = trace.GoodputRecorder("serve", writer=w)
        t0 = time.perf_counter()
        for i in range(n):
            g.transition("decode" if i % 2 else "prefill")
        segment = (time.perf_counter() - t0) / n * 1e6
        w.close()
    return dict(us_per_event=event, us_per_transition=segment,
                us_per_line=max(event, segment))


# The drains of the migration phase: (pool kind, spec_k), and how many decode
# or verify ticks the source runs first.
MIGRATION_DRAINS = (("bf16", SPEC_K), ("int8", 0))
# The pool kind and spec_k the HTTP phase's arm B hands every request off
# in (over /migrate, tokens checked against the engine-level run): the
# migration phase's own handoffs take the other five.
HTTP_HANDOFF = ("int8", SPEC_K)
DRAIN_AFTER_TICKS = 4
# The migration phase's handoffs and drains serve half of the 12 requests
# (every other one: 4 of the 8 base ones, r0 among them for the prefix
# check, and 2 of the 4 repetitive ones, whose drafts are accepted), on
# SPEC_ARRIVALS' ticks; a request's tokens do not depend on which others
# share its ticks (rows bitwise across row counts), so each is still held
# to the whole run's.
MIGRATION_REQUESTS = tuple(range(0, 12, 2))
MIGRATION_ARRIVALS = {t: [i for i in ids if i in MIGRATION_REQUESTS]
                      for t, ids in SPEC_ARRIVALS.items()}


def served_engine(model, cfg, kind="bf16", spec_k=0):
    """An engine of SERVE_ENGINE_KW with its own pool of ``kind`` pages."""
    from triton_kubernetes_tpu_torch.serve import ServeEngine

    return ServeEngine(model, cfg, device=SERVE_DEVICE, **dict(
        SERVE_ENGINE_KW, kv_dtype="auto" if kind == "bf16" else kind,
        spec_k=spec_k))


def engine_pair(model, cfg, kind, spec_k):
    """A source and a destination engine, each with its own pool."""
    return (served_engine(model, cfg, kind, spec_k),
            served_engine(model, cfg, kind, spec_k))


def ship(src, dst, rid, reason, rec):
    """Export ``rid`` from ``src``, import it into ``dst`` under the same
    id, release it on ``src``; times the export (gather, device to host,
    pack, sha256) and the import (digest, unpack, host to device, write)
    from a drained queue, and sha256 alone over the blob."""
    import hashlib

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = src.export_session(rid, reason=reason)
    t1 = time.perf_counter()
    dst.import_session(blob, request_id=rid, reason=reason)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    hashlib.sha256(blob).digest()
    t3 = time.perf_counter()
    src.release_session(rid)
    rec["bytes"].append(len(blob))
    rec["export_ms"].append((t1 - t0) * 1e3)
    rec["import_ms"].append((t2 - t1) * 1e3)
    rec["sha256_ms"].append((t3 - t2) * 1e3)
    return blob


def export_breakdown(engine, rid):
    """One parked session's export taken apart (ms): the indexed read of
    the pool and the device-to-host copy, pack_session (the join copy and
    sha256), and sha256 alone over the blob. Reads only."""
    import hashlib

    from triton_kubernetes_tpu_torch.ops.paged_attention import byte_view
    from triton_kubernetes_tpu_torch.serve import pack_session

    seq = engine.parked[rid]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = torch.tensor(seq.pages, dtype=torch.long, device=SERVE_DEVICE)
    arrays = {n: byte_view(p)[:, idx].cpu().view(p.dtype)
              for n, p in engine._components().items()}
    t1 = time.perf_counter()
    blob = pack_session(model="m", kv_dtype=engine.kv_dtype,
                        block_size=engine.block_size, arrays=arrays,
                        request={}, generated=[1], prefilled=1, target=1,
                        preemptions=0)
    t2 = time.perf_counter()
    hashlib.sha256(blob).digest()
    t3 = time.perf_counter()
    return dict(bytes=len(blob), gather_d2h_ms=(t1 - t0) * 1e3,
                pack_ms=(t2 - t1) * 1e3, sha256_ms=(t3 - t2) * 1e3)


def _new_ship_record():
    return dict(bytes=[], export_ms=[], import_ms=[], sha256_ms=[])


def _check_migrated(tag, done, reqs, base, launches, spec_k):
    """Every request finished, its tokens the baseline's; the paged kernels
    ran (decode and verify on imported pages)."""
    missing = [r.request_id for r in reqs if r.request_id not in done]
    if missing:
        raise AssertionError(f"{tag}: {missing} never finished")
    same, first = tokens_equal({"tokens": done}, base, reqs)
    total = sum(len(done[r.request_id]) for r in reqs)
    if same != total or total != sum(len(base["tokens"][r.request_id])
                                     for r in reqs):
        raise AssertionError(f"{tag}: {same}/{total} tokens equal to the "
                             f"unmigrated run, first differences {first}")
    ran = ["paged_prefill", "paged_decode"] + (["paged_verify"]
                                              if spec_k else [])
    if not all(launches[k] for k in ran):
        raise AssertionError(f"{tag}: launches {launches}")
    return same, total


def _drained(tag, *engines):
    for e in engines:
        e.release_prefix_cache()
        if e.allocator.in_use:
            raise AssertionError(f"{tag}: {e.allocator.in_use} pages leaked")


def handoff_run(model, cfg, kind, spec_k, reqs, base, prefix_check=False):
    """The source serves the MIGRATION_REQUESTS of the 12 (``reqs``) with
    ``handoff=True``: each
    finishes with "handoff" after its first token and is shipped to the
    destination as it finishes, which decodes it to the end, both engines
    stepping in one loop."""
    from triton_kubernetes_tpu_torch.ops import paged_attention as pa

    tag = f"handoff, {kind} pages, spec_k={spec_k}"
    src, dst = engine_pair(model, cfg, kind, spec_k)
    hreqs = [dataclasses.replace(r, handoff=True) for r in reqs]
    rec = _new_ship_record()
    pa.reset_launch_counts()
    reset_row_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, done, tick = {}, {}, 0
    while src.has_work or dst.has_work or tick <= max(MIGRATION_ARRIVALS):
        for i in MIGRATION_ARRIVALS.get(tick, []):
            src.submit(hreqs[i])
        for d in src.step():
            if d.finish_reason != "handoff":
                raise AssertionError(f"{tag}: {d.request_id} finished "
                                     f"{d.finish_reason} on the source")
            first[d.request_id] = d.tokens
            if not rec["bytes"]:
                rec["breakdown"] = export_breakdown(src, d.request_id)
            ship(src, dst, d.request_id, "handoff", rec)
        for d in dst.step():
            done[d.request_id] = d.tokens
            if d.tokens[:1] != first[d.request_id]:
                raise AssertionError(f"{tag}: {d.request_id}'s stream does "
                                     f"not start with the source's token")
        tick += 1
        if tick > 10_000:
            raise AssertionError(f"{tag}: engines did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    mine = [reqs[i] for i in MIGRATION_REQUESTS]
    same, total = _check_migrated(tag, done, mine, base, launches, spec_k)
    prefix = prefix_reference_check(src, dst, reqs, base) \
        if prefix_check else None
    _drained(tag, src, dst)
    del src, dst
    gc.collect()
    torch.cuda.empty_cache()
    return dict(what="handoff", kind=kind, spec_k=spec_k, tokens_equal=same,
                tokens=total, wall_s=wall, launches=launches, prefix=prefix, **rec)


def prefix_reference_check(src, dst, reqs, base):
    """The destination first serves one request that shares only r0's
    512-token prefix; then r0, handed off by the source, is imported: its
    32 prefix pages must be mapped by reference (already indexed, no fresh
    page, bytes as shipped -- F2: the same windows wrote them on either
    engine), the rest written fresh, and its tokens the baseline's."""
    from triton_kubernetes_tpu_torch.serve import Request, unpack_session

    _drained("prefix check", src, dst)
    r0 = reqs[0]
    n_prefix = 512
    rng = np.random.default_rng(5)
    warm = Request("warm", r0.tokens[:n_prefix] + rng.integers(
        0, dst.config.vocab_size, 100).tolist(), 2)
    dst.submit(warm)
    dst.run_until_idle()
    cached = set(dst.prefix.indexed_pages())
    in_use = dst.allocator.in_use
    src.submit(dataclasses.replace(r0, request_id="p0", handoff=True))
    (handed,) = src.run_until_idle()
    blob = src.export_session("p0")
    sp = unpack_session(blob)
    dst.import_session(blob, request_id="p0")
    src.release_session("p0")
    seq = next(s for s in dst.waiting if s.request.request_id == "p0")
    reused = sum(p in cached for p in seq.pages)
    fresh = dst.allocator.in_use - in_use
    idx = torch.tensor(seq.pages, dtype=torch.long, device=SERVE_DEVICE)
    landed = all(torch.equal(pool[:, idx], sp.arrays[name].to(SERVE_DEVICE))
                 for name, pool in (("k", dst.cache.k), ("v", dst.cache.v)))
    want_reused = n_prefix // BS
    if (reused != want_reused or fresh != sp.pages - want_reused
            or not landed):
        raise AssertionError(f"prefix pages: {reused} reused (want "
                             f"{want_reused}), {fresh} fresh of "
                             f"{sp.pages}, pool bytes as shipped: {landed}")
    (d,) = dst.run_until_idle()
    if handed.tokens + d.tokens[1:] != base["tokens"][r0.request_id] \
            or d.tokens != base["tokens"][r0.request_id]:
        raise AssertionError("prefix pages: tokens differ from the "
                             "unmigrated run's")
    return dict(pages=sp.pages, reused_pages=reused, fresh_pages=fresh,
                bytes=len(blob))


def drain_run(model, cfg, kind, spec_k, reqs, base, torn_check=False):
    """The source serves the MIGRATION_REQUESTS of the 12 (``reqs``); after
    DRAIN_AFTER_TICKS decode or
    verify ticks every id in ``exportable_sessions()`` is exported,
    imported into the destination and released on the source, and both run
    to the end (with ``torn_check``, once two sessions are exportable). With
    ``torn_check`` the first session's payload is first
    damaged (a bit flipped in the middle of the pages, and a copy cut
    there): each must raise ``TornPayloadError`` with the destination's
    pool ``torch.equal`` to a clone taken before and its pages in use
    unchanged, and the source then resumes that session to the end."""
    from triton_kubernetes_tpu_torch.ops import paged_attention as pa
    from triton_kubernetes_tpu_torch.serve import TornPayloadError, corrupt

    tag = f"drain, {kind} pages, spec_k={spec_k}"
    src, dst = engine_pair(model, cfg, kind, spec_k)
    rec = _new_ship_record()
    pa.reset_launch_counts()
    reset_row_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, tick, drained, torn = {}, 0, [], None
    while src.has_work or dst.has_work or tick <= max(MIGRATION_ARRIVALS):
        for i in MIGRATION_ARRIVALS.get(tick, []):
            src.submit(reqs[i])
        for eng in (src, dst):
            for d in eng.step():
                done[d.request_id] = d.tokens
        # The torn check keeps its session on the source: drain once a
        # second one can move too.
        if not drained and (src.stats()["decode_steps"]
                            + src.stats()["verify_steps"]
                            >= DRAIN_AFTER_TICKS) and len(
                src.exportable_sessions()) > int(torn_check):
            drained = src.exportable_sessions()
            for rid in drained:
                if torn_check and torn is None:
                    torn = torn_transfer_check(src, dst, rid, corrupt,
                                               TornPayloadError)
                    src.resume_session(rid)
                    continue
                ship(src, dst, rid, "drain", rec)
            if not rec["bytes"]:
                raise AssertionError(f"{tag}: {drained} exportable after "
                                     f"{DRAIN_AFTER_TICKS} ticks: none "
                                     f"left to ship")
        tick += 1
        if tick > 10_000:
            raise AssertionError(f"{tag}: engines did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    same, total = _check_migrated(tag, done, [reqs[i] for i in
                                              MIGRATION_REQUESTS],
                                  base, launches, spec_k)
    _drained(tag, src, dst)
    del src, dst
    gc.collect()
    torch.cuda.empty_cache()
    return dict(what="drain", kind=kind, spec_k=spec_k, tokens_equal=same,
                tokens=total, drained=drained, torn=torn, wall_s=wall, launches=launches,
                **rec)


def torn_transfer_check(src, dst, rid, corrupt, TornPayloadError):
    blob = src.export_session(rid, reason="drain")
    hdr_end = 12 + int.from_bytes(blob[8:12], "big")
    mid = hdr_end + (len(blob) - 32 - hdr_end) // 2
    before = {n: t.clone() for n, t in dst._components().items()}
    in_use = dst.allocator.in_use
    for mode in ("bitflip", "truncate"):
        try:
            dst.import_session(corrupt(blob, mode=mode, offset=mid))
        except TornPayloadError:
            pass
        else:
            raise AssertionError(f"torn transfer: a {mode} payload was "
                                 f"imported")
        if dst.allocator.in_use != in_use or not all(
                torch.equal(t, before[n])
                for n, t in dst._components().items()):
            raise AssertionError(f"torn transfer: the {mode} attempt "
                                 f"changed the destination")
    del before
    return dict(session=rid, bytes=len(blob), damaged_at=mid,
                refused=["bitflip", "truncate"])


def migration_phase(model, cfg, card, requests, runs):
    """KV-session migration between two engines on the card (each with its
    own 2,048-page pool): handoff in every pool kind at spec_k 0 and 3
    but HTTP_HANDOFF's (the HTTP phase's arm B hands those off),
    with the prefix-by-reference check after the bf16 spec_k 0 one; drains
    of MIGRATION_DRAINS, the first with the torn-transfer check. Every
    stream must equal the unmigrated run's, every token. Prints and returns the
    payload bytes, export and import times and rates by pool kind."""
    from triton_kubernetes_tpu_torch.serve import Request

    reqs = list(requests) + repetitive_requests(cfg, Request)
    out = []
    for kind in KV_KINDS:
        for spec_k in (0, SPEC_K):
            if (kind, spec_k) == HTTP_HANDOFF:
                continue  # the HTTP phase's arm B hands these off
            run = handoff_run(model, cfg, kind, spec_k, reqs,
                              baseline_run(runs, kind, spec_k),
                              prefix_check=(kind, spec_k) == ("bf16", 0))
            out.append(run)
            print(f"migrate[{run['what']}, {kind} pages, spec_k={spec_k}]: "
                  f"{run['tokens_equal']}/{run['tokens']} tokens equal to "
                  f"the unmigrated run; {len(run['bytes'])} "
                  f"sessions, {statistics.mean(run['bytes']) / 1e6:.2f} MB "
                  f"each, export median "
                  f"{statistics.median(run['export_ms']):.2f} ms, import "
                  f"median {statistics.median(run['import_ms']):.2f} ms, "
                  f"sha256 alone {statistics.median(run['sha256_ms']):.2f} "
                  f"ms; wall {run['wall_s']:.3f} s"
                  + (f"; prefix pages {run['prefix']}" if run['prefix']
                     else "") + f" [{card}]", flush=True)
    for i, (kind, spec_k) in enumerate(MIGRATION_DRAINS):
        run = drain_run(model, cfg, kind, spec_k, reqs,
                        baseline_run(runs, kind, spec_k), torn_check=i == 0)
        out.append(run)
        print(f"migrate[drain, {kind} pages, spec_k={spec_k}]: "
              f"{run['tokens_equal']}/{run['tokens']} tokens equal to the "
              f"unmigrated run; {len(run['bytes'])} sessions shipped, "
              f"drained {run['drained']}, torn transfer {run['torn']}; "
              f"wall {run['wall_s']:.3f} s [{card}]", flush=True)
    summary = {}
    for kind in KV_KINDS:
        mine = [r for r in out if r["kind"] == kind]
        nbytes = sum(sum(r["bytes"]) for r in mine)
        exp = sum(sum(r["export_ms"]) for r in mine)
        imp = sum(sum(r["import_ms"]) for r in mine)
        sha = sum(sum(r["sha256_ms"]) for r in mine)
        summary[kind] = dict(
            sessions=sum(len(r["bytes"]) for r in mine),
            payload_bytes_per_session=nbytes / max(1, sum(
                len(r["bytes"]) for r in mine)),
            export_ms_median=statistics.median(
                [x for r in mine for x in r["export_ms"]]),
            import_ms_median=statistics.median(
                [x for r in mine for x in r["import_ms"]]),
            sha256_ms_median=statistics.median(
                [x for r in mine for x in r["sha256_ms"]]),
            export_gb_per_s=nbytes / 1e6 / exp,
            import_gb_per_s=nbytes / 1e6 / imp,
            sha256_gb_per_s=nbytes / 1e6 / sha)
    for kind in KV_KINDS:
        parts = [r["breakdown"] for r in out
                 if r["kind"] == kind and r.get("breakdown")]
        summary[kind]["export_breakdown_first_session"] = parts
    prefix = next(r["prefix"] for r in out if r["prefix"])
    summary["prefix_pages_by_reference"] = prefix
    summary["card"] = card
    print(json.dumps({"migration": summary}), flush=True)
    return out, summary


# The HTTP phase: the open loop that arms A and C replay (the port's copy of
# the reference's seeded Poisson schedule; vocab_size is the model's), how
# long a client waits on one response, and how long a replica subprocess
# may take to print its URL (torch import, 8B init, kernel load, pool).
HTTP_POISSON = dict(rate=2.0, n=8, prompt_len_range=(200, 1000),
                    max_new_tokens=SERVE_NEW_TOKENS, seed=0)
HTTP_TIMEOUT_S = 300.0
HTTP_START_S = 300.0
# Arm C's replicas: the entry point's flags for the 8B model.
HTTP_SERVE_ARGS = ["--model", "llama3-8b", "--num-blocks", "2048",
                   "--max-batch", "8", "--max-model-len", "2048"]
# What every HTTP arm must have launched: kernels 4 and 5, the row-invariant
# GEMM and the fused residual add + norm.
SERVED_KERNELS = ["paged_decode", "paged_prefill", "decode_gemm",
                  "add_rms_norm"]


def http_call(url, payload=None):
    """(status, JSON body) of a GET (``payload`` None) or a JSON POST; an
    HTTP error status is returned, not raised."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def http_metrics(url):
    """A ``/metrics`` scrape, parsed by the port's ``parse_prometheus``."""
    import urllib.request

    from triton_kubernetes_tpu_torch.utils.metrics import parse_prometheus

    with urllib.request.urlopen(url + "/metrics",
                                timeout=HTTP_TIMEOUT_S) as r:
        return parse_prometheus(r.read().decode())


def route_counts(router_url):
    """The router's placements so far, by reason (its /metrics)."""
    fam = http_metrics(router_url).get("tk8s_route_requests_total")
    out = {}
    for s in (fam or {}).get("series", []):
        reason = s["labels"]["reason"]
        out[reason] = out.get(reason, 0) + int(s["value"])
    return out


def generate_payload(r):
    """The /generate body of an engine ``Request`` (sampling fields too)."""
    return {"tokens": list(r.tokens), "max_new_tokens": r.max_new_tokens,
            "temperature": r.temperature, "top_k": r.top_k,
            "top_p": r.top_p, "seed": r.seed}


def fire(url, payloads, at=None):
    """POST each payload to ``url``/generate on a thread of its own: all at
    once, or each ``at[i]`` seconds after the start (an open loop). Returns
    [(status, body, sent_s, done_s)] in payload order."""
    import threading

    out = [None] * len(payloads)
    t0 = time.perf_counter()

    def one(i):
        if at is not None:
            time.sleep(max(0.0, t0 + at[i] - time.perf_counter()))
        sent = time.perf_counter()
        status, body = http_call(url + "/generate", payloads[i])
        out[i] = (status, body, sent - t0, time.perf_counter() - t0)

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + HTTP_TIMEOUT_S + max(at or [0]) + 60
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    missing = [i for i, o in enumerate(out) if o is None]
    if missing:
        raise AssertionError(f"requests {missing} never returned")
    return out


def load_stats(tag, results, n_tokens, card):
    """Checks every response is 200 with ``n_tokens`` tokens, then TTFT and
    TPOT (the replica's clock, from the bodies), the client's end-to-end
    latency, the time outside the engine (client e2e - the replica's e2e:
    HTTP, the router and the wait in the engine loop's inbox; for a
    handoff the replica's e2e is the decode replica's, so this holds the
    prefill and the transfer too) and the generated tokens/s from the
    first send to the last answer. Prints them."""
    from triton_kubernetes_tpu_torch.serve.loadgen import percentile

    bad = [(i, s, b) for i, (s, b, _, _) in enumerate(results)
           if s != 200 or len(b.get("tokens", ())) != n_tokens]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} bad responses, first "
                             f"{bad[0][:2]} {str(bad[0][2])[:300]}")
    ttft = [b["ttft_s"] for _, b, _, _ in results]
    tpot = [b["tpot_s"] for _, b, _, _ in results]
    e2e = [done - sent for _, _, sent, done in results]
    outside = [(done - sent) - b["e2e_s"] for _, b, sent, done in results]
    wall = (max(done for *_, done in results)
            - min(sent for _, _, sent, _ in results))
    tokens = sum(len(b["tokens"]) for _, b, _, _ in results)

    def pct(v):
        return {"p50": percentile(v, 50), "p99": percentile(v, 99)}

    out = dict(requests=len(results), generated_tokens=tokens, wall_s=wall,
               tokens_per_s=tokens / wall, ttft_s=pct(ttft),
               tpot_s=pct(tpot), client_e2e_s=pct(e2e),
               outside_engine_s=pct(outside))
    print(f"http[{tag}]: {len(results)} requests all 200, {tokens} tokens "
          f"in {wall:.3f} s = {out['tokens_per_s']:.2f} tokens/s; TTFT p50 "
          f"{out['ttft_s']['p50']:.4f} p99 {out['ttft_s']['p99']:.4f} s, "
          f"TPOT p50 {out['tpot_s']['p50']:.5f} p99 "
          f"{out['tpot_s']['p99']:.5f} s, client e2e p50 "
          f"{out['client_e2e_s']['p50']:.4f} p99 "
          f"{out['client_e2e_s']['p99']:.4f} s, outside the engine p50 "
          f"{out['outside_engine_s']['p50'] * 1e3:.2f} p99 "
          f"{out['outside_engine_s']['p99'] * 1e3:.2f} ms [{card}]",
          flush=True)
    return out


def poisson_payloads(cfg):
    from triton_kubernetes_tpu_torch.serve.loadgen import PoissonSchedule

    sched = list(PoissonSchedule(vocab_size=cfg.vocab_size, **HTTP_POISSON))
    return ([{"tokens": r.tokens, "max_new_tokens": r.max_new_tokens}
             for r in sched], [r.at for r in sched])


def poisson_run(tag, router_url, cfg, card):
    """The open loop through a router: load stats and placements."""
    payloads, at = poisson_payloads(cfg)
    before = route_counts(router_url)
    stats = load_stats(tag, fire(router_url, payloads, at),
                       HTTP_POISSON["max_new_tokens"], card)
    after = route_counts(router_url)
    stats["placements"] = {k: after.get(k, 0) - before.get(k, 0)
                           for k in after}
    print(f"http[{tag}]: router placements {stats['placements']} [{card}]",
          flush=True)
    return stats


def http_tokens_check(tag, results, reqs, base):
    """Every response 200; the streams equal the engine-level baseline's."""
    bad = [(r.request_id, s) for r, (s, *_) in zip(reqs, results) if s != 200]
    if bad:
        raise AssertionError(f"{tag}: non-200 responses {bad}: "
                             f"{[b for s, b, *_ in results if s != 200][:1]}")
    run = {"tokens": {r.request_id: b["tokens"]
                      for r, (_, b, *_) in zip(reqs, results)}}
    same, first = tokens_equal(run, base, reqs)
    total = sum(len(t) for t in run["tokens"].values())
    if same != base["generated_tokens"] or total != same:
        raise AssertionError(f"{tag}: {same}/{total} tokens equal to the "
                             f"engine-level run, first differences {first}")
    return same


def kernels_reached(tag, launches, wanted):
    """The served path ran the hand-written kernels: each of ``wanted``
    launched at least once."""
    idle = [k for k in wanted if not launches.get(k)]
    if idle:
        raise AssertionError(f"{tag}: kernels {idle} never launched: "
                             f"{launches}")


@contextlib.contextmanager
def http_fleet(engines, decode_engines=()):
    """Replicas (``ServeHTTPServer``) over ``engines`` and
    ``decode_engines``, all on loopback, behind one ``RouterHTTPServer``
    (the second list its decode pool). Yields (router, replicas); on exit
    checks no engine loop died and stops everything."""
    from triton_kubernetes_tpu_torch.serve import (RouterHTTPServer,
                                                   ServeHTTPServer)

    replicas = [ServeHTTPServer(e).start() for e in engines]
    decoders = [ServeHTTPServer(e).start() for e in decode_engines]
    router = RouterHTTPServer([s.url for s in replicas],
                              decode_urls=[s.url for s in decoders] or None,
                              health_interval_s=0.5).start()
    try:
        yield router, replicas + decoders
        died = [s.loop_error for s in replicas + decoders if s.loop_error]
        if died:
            raise AssertionError(f"engine loops died: {died}")
    finally:
        router.stop()
        for s in replicas + decoders:
            s.stop()


def start_entry_point(args, log):
    """A ``python -m triton_kubernetes_tpu_torch.tools.<...>`` subprocess
    and the URL of its first line (``... on http://host:port ...``)."""
    import threading

    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", *args],
            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
            stderr=err, text=True)
    line = []
    reader = threading.Thread(target=lambda: line.append(
        proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(HTTP_START_S)
    if not line or " on http://" not in line[0]:
        proc.kill()
        raise AssertionError(f"{args[0]} did not start: "
                             f"{line[:1]} {Path(log).read_text()[-2000:]}")
    return proc, line[0].split(" on ")[1].split()[0]


def http_phase(model, cfg, card, requests, runs):
    """Serving through HTTP on the card (``serve/server.py``,
    ``serve/router.py``, the two entry points), on the 12 requests of the
    spec/quant runs, whose engine-level runs are the token reference: arms
    A (``http_fleet_arm``), B (``http_disagg_arm``) and C
    (``http_entry_point_arm``). Launch counters are zeroed before each arm;
    kernels 4 and 5 (6 in B), the GEMM and the fused norm must have run."""
    from triton_kubernetes_tpu_torch.serve import Request

    reqs = list(requests) + repetitive_requests(cfg, Request)
    t0 = time.perf_counter()
    out = dict(A=http_fleet_arm(model, cfg, card, reqs, runs),
               B=http_disagg_arm(model, cfg, card, reqs, runs))
    gc.collect()
    torch.cuda.empty_cache()
    out["C"] = http_entry_point_arm(
        cfg, card, [generate_payload(r) for r in reqs])
    out["phase_s"] = time.perf_counter() - t0
    out["gil"] = dict(
        burst_tokens_per_s_one_replica=out["A"]["single_replica"][
            "tokens_per_s"],
        burst_tokens_per_s_two_in_one_process=out["A"]["burst"][
            "tokens_per_s"],
        burst_tokens_per_s_two_processes=out["C"]["burst"]["tokens_per_s"],
        poisson_tokens_per_s_two_in_one_process=out["A"]["poisson"][
            "tokens_per_s"],
        poisson_tokens_per_s_two_processes=out["C"]["poisson"][
            "tokens_per_s"])
    out["card"] = card
    print(json.dumps({"http": {k: out[k] for k in ("gil", "phase_s")}}),
          flush=True)
    print(f"http: the phase took {out['phase_s']:.1f} s [{card}]",
          flush=True)
    return out


def reset_counts():
    """Zero the kernels' launch counters and the metrics registry."""
    from triton_kubernetes_tpu_torch.ops import paged_attention as pa
    from triton_kubernetes_tpu_torch.utils import metrics

    pa.reset_launch_counts()
    reset_row_counts()
    metrics.configure()


def http_fleet_arm(model, cfg, card, reqs, runs):
    """A: the 12 fired at once at one replica behind the router, then at
    two replicas in this process sharing the model's weights, each with its
    own 2,048-page bf16 pool (both from cold prefix caches; tokens = the
    bf16 spec_k 0 run, every token each time), then the Poisson open loop
    through the two."""
    payloads = [generate_payload(r) for r in reqs]
    base = baseline_run(runs, "bf16", 0)
    reset_counts()
    with http_fleet([served_engine(model, cfg)]) as (router, _):
        results = fire(router.url, payloads)
        same = http_tokens_check("A, one replica", results, reqs, base)
        single = load_stats("A: 12 at once, one replica", results,
                            SERVE_NEW_TOKENS, card)
    gc.collect()
    torch.cuda.empty_cache()
    with http_fleet([served_engine(model, cfg),
                     served_engine(model, cfg)]) as (router, _):
        results = fire(router.url, payloads)
        same += http_tokens_check("A, two replicas", results, reqs, base)
        burst = load_stats("A: 12 at once, 2 replicas in one process",
                           results, SERVE_NEW_TOKENS, card)
        poisson = poisson_run(f"A: Poisson 2 req/s x {HTTP_POISSON['n']}, "
                              f"2 replicas in one process", router.url, cfg,
                              card)
        launches = launch_counts()
    kernels_reached("arm A", launches, SERVED_KERNELS)
    print(f"http[A]: {same}/{2 * len(reqs) * SERVE_NEW_TOKENS} tokens "
          f"equal to the "
          f"engine-level bf16 spec_k=0 run; launches {launches} [{card}]",
          flush=True)
    return dict(tokens_equal=same, burst=burst, single_replica=single,
                poisson=poisson, launches=launches)


def http_disagg_arm(model, cfg, card, reqs, runs):
    """B: a prefill and a decode replica, int8 pools, spec_k 3, behind a
    router with a decode pool: every request goes /generate (handoff) ->
    /migrate/out -> /migrate/in -> /await (tokens = the int8 spec_k 3
    run); the transfer histogram from a /metrics scrape."""
    reset_counts()
    engines = [served_engine(model, cfg, "int8", SPEC_K) for _ in range(2)]
    with http_fleet(engines[:1], engines[1:]) as (router, replicas):
        results = fire(router.url, [generate_payload(r) for r in reqs])
        same = http_tokens_check("B, disaggregated", results, reqs,
                                 baseline_run(runs, "int8", SPEC_K))
        handoffs = [b.get("decode_replica") for _, b, *_ in results]
        if handoffs != ["d0"] * len(reqs):
            raise AssertionError(f"B: decode replicas {handoffs}")
        burst = load_stats("B: 12 at once, prefill -> decode, int8 pages, "
                           f"spec_k={SPEC_K}", results, SERVE_NEW_TOKENS,
                           card)
        hist = http_metrics(replicas[0].url)[
            "tk8s_serve_migration_transfer_seconds"]["series"][0]
        launches = launch_counts()
    kernels_reached("arm B", launches, SERVED_KERNELS + ["paged_verify"])
    if hist["count"] != len(reqs):
        raise AssertionError(f"B: {hist['count']} transfers observed")
    out = dict(tokens_equal=same, burst=burst, launches=launches,
               transfer_count=hist["count"],
               transfer_seconds_sum=hist["sum"],
               transfer_ms_mean=hist["sum"] / hist["count"] * 1e3)
    print(f"http[B]: {same}/{len(reqs) * SERVE_NEW_TOKENS} tokens equal "
          f"to the "
          f"engine-level int8 spec_k={SPEC_K} run; "
          f"tk8s_serve_migration_transfer_seconds count {hist['count']} sum "
          f"{hist['sum']:.4f} s ({out['transfer_ms_mean']:.2f} ms a "
          f"transfer); launches {launches} [{card}]", flush=True)
    return out


def http_entry_point_arm(cfg, card, payloads):
    """C: two ``tools.serve`` subprocesses (``HTTP_SERVE_ARGS``: their own
    8B init at seed 0, 2,048-page pools) and a ``tools.route`` over them:
    /healthz, one greedy request at each replica (identical tokens: the
    same seed), the 12 at once, the Poisson open loop, each replica's
    kernel launches from /stats, then SIGTERM: exit 143 each, and every
    ``--trace-jsonl`` closed (the goodput ledgers validate)."""
    import signal

    from triton_kubernetes_tpu_torch.utils.trace import \
        validate_goodput_trace

    from triton_kubernetes_tpu_torch.topology import serving
    from triton_kubernetes_tpu_torch.topology.gpus import GpuPoolSpec

    def rendered_argv(deployment):
        """The argv after ``python -m`` of a rendered Deployment's
        container."""
        cmd = deployment["spec"]["template"]["spec"]["containers"][0][
            "command"]
        if cmd[:2] != ["python", "-m"]:
            raise AssertionError(f"C: rendered command {cmd}")
        return cmd[2:]

    pool = GpuPoolSpec.from_accelerator(f"h100-{torch.cuda.device_count()}")
    serve_argv = rendered_argv(serving.render_serving_deployment(
        "chip-serve", pool, "chip-smoke-pool", "tk8s/torch-cuda-runtime",
        HTTP_SERVE_ARGS[HTTP_SERVE_ARGS.index("--model") + 1]))
    # Appended to the rendered argv: the pool shape, and a port each and
    # the loopback address, since both replicas share this host.
    serve_extra = [a for a in HTTP_SERVE_ARGS[2:]] + [
        "--serve-host", "127.0.0.1", "--port", "0"]
    t0 = time.perf_counter()
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        traces = [str(Path(tmp) / f"{n}.jsonl") for n in ("s0", "s1", "r")]
        try:
            # The two replicas start side by side (each its own 8B init).
            starts = []
            with concurrent.futures.ThreadPoolExecutor(2) as ex:
                for i in range(2):
                    extra = serve_extra + ["--trace-jsonl", traces[i]]
                    print(f"http[C]: replica {i}: the rendered serve "
                          f"Deployment's argv {serve_argv} + appended "
                          f"{extra}", flush=True)
                    starts.append(ex.submit(start_entry_point,
                                            serve_argv + extra,
                                            Path(tmp) / f"s{i}.log"))
                for f in starts:
                    if f.exception() is None:
                        procs.append(f.result()[0])
            urls = [f.result()[1] for f in starts]
            route_argv = rendered_argv(serving.render_router_deployment(
                "chip-route", "tk8s/torch-cuda-runtime", urls))
            extra = ["--route-host", "127.0.0.1", "--port", "0",
                     "--trace-jsonl", traces[2]]
            print(f"http[C]: router: the rendered route Deployment's argv "
                  f"{route_argv} + appended {extra}", flush=True)
            proc, rurl = start_entry_point(route_argv + extra,
                                           Path(tmp) / "r.log")
            procs.append(proc)
            started = time.perf_counter() - t0
            for u in urls + [rurl]:
                status, body = http_call(u + "/healthz")
                if status != 200 or not body.get("ok"):
                    raise AssertionError(f"C: {u}/healthz {status} {body}")
            greedy = [http_call(u + "/generate", payloads[0]) for u in urls]
            if not (all(s == 200 for s, _ in greedy)
                    and greedy[0][1]["tokens"] == greedy[1][1]["tokens"]
                    and len(greedy[0][1]["tokens"]) == SERVE_NEW_TOKENS):
                raise AssertionError(f"C: greedy requests differ: {greedy}")
            burst = load_stats("C: 12 at once, 2 replica processes",
                               fire(rurl, payloads), SERVE_NEW_TOKENS,
                               card)
            poisson = poisson_run(f"C: Poisson 2 req/s x "
                                  f"{HTTP_POISSON['n']}, 2 replica "
                                  f"processes", rurl, cfg, card)
            stats = [http_call(u + "/stats")[1] for u in urls]
            launches = {k: sum(s["kernel_launches"][k] for s in stats)
                        for k in stats[0]["kernel_launches"]}
            kernels_reached("arm C", launches, SERVED_KERNELS)
            for proc in procs[::-1]:
                proc.send_signal(signal.SIGTERM)
            codes = [proc.wait(60) for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(60)
        if codes != [143, 143, 143]:
            raise AssertionError(f"C: exit codes on SIGTERM {codes}")
        problems = validate_goodput_trace(traces[:2])
        problems += validate_goodput_trace(traces[2:])
        if problems:
            raise AssertionError(f"C: trace files after SIGTERM: "
                                 f"{problems[:5]}")
    print(f"http[C]: 3 processes listening after {started:.1f} s; greedy "
          f"tokens identical on both replicas; launches {launches}; "
          f"SIGTERM exit codes {codes}, trace files closed [{card}]",
          flush=True)
    return dict(start_s=started, burst=burst, poisson=poisson,
                launches=launches, exit_codes=codes)


def plain_w8a8_rows(x, qs, scales, out):
    """W8A8 products of x on the plain versions of kernels A and B."""
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg
    from triton_kubernetes_tpu_torch.ops import quantization as qz

    return dg.w8a8_gemm_group_plain(
        *qz.quantize_rows_plain(x, qs[0].dtype), qs, scales, out)


def bf16_product_rows(x, qs, scales, out):
    """A control, not W8A8: the activation quantized as W8A8 does, but
    the 8-bit product taken in bf16 (the operands are exact in bf16; the
    sum is rounded to bf16 once, as a bf16 GEMM rounds its out), then the
    epilogue."""
    from triton_kubernetes_tpu_torch.ops import quantization as qz

    xq, xs = qz.quantize_rows_plain(x, qs[0].dtype)
    xb = xq.to(torch.bfloat16)
    return [((torch.mm(xb, q.to(torch.bfloat16).t()).float() * xs[:, None])
             * s[None, :]).to(out) for q, s in zip(qs, scales)]


def w8a16_rows(x, qs, scales, out):
    """A control, not W8A8: the activation left in bf16, the weight
    dequantized to bf16, one bf16 product."""
    xb = x.to(torch.bfloat16)
    return [torch.mm(xb, (q.float() * s[:, None]).to(torch.bfloat16).t()
                     ).to(out) for q, s in zip(qs, scales)]


# The W8A8 check is per layer: the quantized 8B's plain path (every row
# op and attention plain) runs the probe prompt once and keeps each layer
# boundary's residual stream; then every layer is fed that plain input
# (``layer_boundaries``) on the kernel path, on each of ``W8A8_CONTROLS``
# in the place of kernels A and B, and on the plain versions of A and B,
# and its output -- the two residual deltas it adds, attention's and the
# MLP's, over the prompt's rows -- is held to the plain layer's, relative
# L2. A quantizer turns a one-ulp difference upstream into a whole
# quantum, so at full depth two valid plain paths differ by more than a
# sound kernel does (int8 0.24, fp8 0.38); fed the plain input, a layer's
# error does not grow with depth. The limit a dtype is midway between the
# kernel path's worst layer and the nearest control's best layer as read
# on the current kernels and plain versions (H100 80GB HBM3, 700 W;
# PERF.md), so each side has the same room; the full-depth first-token
# numbers are printed beside them and decide nothing.
W8A8_LAYER_SOUND_READING = {"int8": 0.00068, "fp8": 0.00113}
W8A8_LAYER_NEAREST_CONTROL = {"int8": 0.01420, "fp8": 0.01937}
W8A8_LAYER_LIMIT = {
    wd: (None if W8A8_LAYER_SOUND_READING[wd] is None else round(
        (W8A8_LAYER_SOUND_READING[wd] + W8A8_LAYER_NEAREST_CONTROL[wd]) / 2,
        5)) for wd in W8A8_LAYER_SOUND_READING}
# The controls the W8A8 check must reject: each takes the place of
# kernels A and B on the serving steps (everything else the same kernels),
# and its best layer must sit past the dtype's limit.
W8A8_CONTROLS = (("bf16 product", bf16_product_rows),
                 ("W8A16", w8a16_rows))


# The W8A8 serve runs take 8 of the 12 requests: the first four base
# ones and the four repetitive ones (whose drafts the spec_k 3 runs
# accept), on SPEC_ARRIVALS' ticks.
W8A8_REQUESTS = (0, 1, 2, 3, 8, 9, 10, 11)
# The weight-only (dequantize path) run's requests, of the 8 base ones.
DEQUANT_REQUESTS = (0, 1, 2, 3)


@contextlib.contextmanager
def layer_boundaries(deltas, xs=None, forced=None):
    """The serving steps' layer boundaries (``paged._serve_layers``: each
    residual add and the norm after it, one launch), as they stand when
    entered (kernels, or ``plain_row_ops``' swaps): every boundary's delta
    -- the attention or MLP output it adds -- is appended to ``deltas``,
    and with ``xs`` the residual stream it hands on (``x + delta``). With
    ``forced`` (an earlier run's ``xs``, in order) a boundary hands on that
    stream instead, and its norm of it: each sub-block is then fed the
    other run's input."""
    from triton_kubernetes_tpu_torch.models import paged

    saved = (paged.add_rms_norm_rows, paged.add_rms_norm_quant_rows)
    feed = iter(forced) if forced is not None else None

    def wrap(fn):
        def boundary(x, delta, *rest):
            deltas.append(delta.clone())
            if feed is not None:
                x, delta = next(feed), torch.zeros_like(delta)
            out = fn(x, delta, *rest)
            if xs is not None:
                xs.append(out[0].clone())
            return out
        return boundary

    paged.add_rms_norm_rows, paged.add_rms_norm_quant_rows = map(wrap,
                                                                  saved)
    try:
        yield
    finally:
        paged.add_rms_norm_rows, paged.add_rms_norm_quant_rows = saved


def layer_errors(deltas, want, layers, rows):
    """Relative L2 of each layer's output -- its two deltas over the
    windows' real rows (``rows``: real rows a window, in order) -- against
    ``want``'s, and whether each is bitwise."""
    errs, same = [], []
    for i in range(layers):
        got, ref = [], []
        for w, n in enumerate(rows):
            for j in (2 * i, 2 * i + 1):
                k = w * 2 * layers + j
                got.append(deltas[k][:, :n].reshape(-1))
                ref.append(want[k][:, :n].reshape(-1))
        got, ref = torch.cat(got), torch.cat(ref)
        errs.append(rel_l2(got, ref))
        same.append(bool(torch.equal(got, ref)))
    return errs, same


@contextlib.contextmanager
def plain_row_ops(w8a8_only=False, w8a8_rows=plain_w8a8_rows):
    """The serving steps' W8A8 products taken by ``w8a8_rows`` (default:
    the plain versions of the quantizer and GEMM, ``quantize_rows_plain``
    and ``w8a8_gemm_group_plain``), and unless ``w8a8_only`` the decode
    GEMM (``decode_gemm_group_plain``) and the norms on their plain
    versions too -- with ``attention_impl="dense"``, a model's plain path
    end to end. The launches that quantize a product's input as they
    produce it (the norms' quantizing entries, the fused SwiGLU) hand
    ``w8a8_rows`` their unquantized rows instead -- the norm's (kernel or
    plain) and torch's ``silu(gate.float()).to(T) * up`` -- so kernel A
    runs nowhere but in ``w8a8_rows``, and a control that takes bf16 rows
    gets them."""
    from triton_kubernetes_tpu_torch.models import llama, paged
    from triton_kubernetes_tpu_torch.ops import decode_gemm as dg
    from triton_kubernetes_tpu_torch.ops import norms
    from triton_kubernetes_tpu_torch.ops import quantization as qz

    saved = (llama.decode_gemm_group, llama.w8a8_rows,
             llama.swiglu_quantize_rows, paged.rms_norm_rows,
             paged.add_rms_norm_rows, paged.rms_norm_quant_rows,
             paged.add_rms_norm_quant_rows)
    llama.w8a8_rows = w8a8_rows
    llama.swiglu_quantize_rows = lambda gate, up, dtype: qz.swiglu(gate, up)
    if not w8a8_only:
        llama.decode_gemm_group = lambda x, ws, out=None: (
            dg.decode_gemm_group_plain(x, ws, out or x.dtype))
        paged.rms_norm_rows, paged.add_rms_norm_rows = (norms.rms_norm,
                                                        norms.add_rms_norm)
    norm, add_norm = paged.rms_norm_rows, paged.add_rms_norm_rows
    paged.rms_norm_quant_rows = lambda x, scale, eps, dtype: norm(x, scale,
                                                                  eps)
    paged.add_rms_norm_quant_rows = (
        lambda x, delta, scale, eps, dtype: add_norm(x, delta, scale, eps))
    try:
        yield
    finally:
        (llama.decode_gemm_group, llama.w8a8_rows,
         llama.swiglu_quantize_rows, paged.rms_norm_rows,
         paged.add_rms_norm_rows, paged.rms_norm_quant_rows,
         paged.add_rms_norm_quant_rows) = saved


def w8a8_logits_check(qmodel, qcfg, probe, bf16_logits, wd, card, rid):
    """The W8A8 check of one dtype on the probe prompt: per layer, each
    layer fed the plain path's input (:func:`layer_boundaries`), the kernel
    path within :data:`W8A8_LAYER_LIMIT` of the plain layer at every layer
    and each of :data:`W8A8_CONTROLS` past it at every layer (int8: every
    layer's output with kernels A and B ``torch.equal`` to the same with
    their plain versions); at full depth, the first-token logits of the
    kernel path against the plain path, two plain paths (the chunked
    windows and the one-shot prefill) and the bf16 model's, printed (int8:
    kernels A and B ``torch.equal`` to their plain versions, asserted).
    Returns the record."""
    from triton_kubernetes_tpu_torch.models import paged

    n = len(probe)
    width = -(-n // BS) * BS
    rows = [min(PREFILL_CHUNK, n - off) for off in range(0, n, PREFILL_CHUNK)]
    layers = qcfg.num_layers
    plain_deltas, plain_xs = [], []
    with torch.inference_mode():
        lk = first_token_logits(qmodel, qcfg, probe, None, paged)
        with plain_row_ops(w8a8_only=True):
            lw = first_token_logits(qmodel, qcfg, probe, None, paged)
        with plain_row_ops():
            with layer_boundaries(plain_deltas, xs=plain_xs):
                lp = first_token_logits(qmodel, qcfg, probe, "dense", paged)
            lo = paged.paged_prefill(
                qmodel, torch.tensor([probe + [0] * (width - n)],
                                     dtype=torch.int32, device=SERVE_DEVICE),
                n, qcfg, paged.init_paged_cache(
                    qcfg, width // BS + 1, BS, device=SERVE_DEVICE),
                torch.arange(1, width // BS + 1, dtype=torch.int32,
                             device=SERVE_DEVICE))
        # Each layer fed the plain path's input, three ways.
        arms = [("kernels A and B", contextlib.nullcontext())]
        arms += [(label, plain_row_ops(w8a8_only=True, w8a8_rows=fn))
                 for label, fn in W8A8_CONTROLS]
        arms.append(("plain A and B", plain_row_ops(w8a8_only=True)))
        per_layer, bitwise, outs = {}, {}, {}
        for label, ops in arms:
            deltas = []
            with ops, layer_boundaries(deltas, forced=plain_xs):
                first_token_logits(qmodel, qcfg, probe, None, paged)
            per_layer[label], bitwise[label] = layer_errors(
                deltas, plain_deltas, layers, rows)
            if wd == "int8" and label in ("kernels A and B", "plain A and B"):
                outs[label] = deltas
            del deltas
    del plain_deltas, plain_xs
    ab_equal = None
    if wd == "int8":
        ab_equal = [all(torch.equal(a, b) for a, b in zip(
            outs["kernels A and B"][2 * i::2 * layers],
            outs["plain A and B"][2 * i::2 * layers])) and all(
            torch.equal(a, b) for a, b in zip(
                outs["kernels A and B"][2 * i + 1::2 * layers],
                outs["plain A and B"][2 * i + 1::2 * layers]))
            for i in range(layers)]
        del outs
    limit = W8A8_LAYER_LIMIT[wd]
    kernel_worst = max(per_layer["kernels A and B"])
    control_best = {label: min(per_layer[label])
                    for label, _ in W8A8_CONTROLS}
    err, floor = rel_l2(lk, lp), rel_l2(lo, lp)
    ops_err, vs_bf16 = rel_l2(lk, lw), rel_l2(lk, bf16_logits)
    record = dict(
        per_layer_rel_l2=per_layer, per_layer_limit=limit,
        per_layer_kernel_worst=kernel_worst,
        per_layer_control_best=control_best,
        per_layer_int8_ab_bitwise=ab_equal,
        rel_l2_vs_plain=err, plain_paths_rel_l2=floor,
        rel_l2_vs_plain_w8a8_ops=ops_err, rel_l2_vs_bf16=vs_bf16,
        same_argmax_as_plain=int(lk.argmax()) == int(lp.argmax()))
    labels = [label for label, _ in arms]
    print(f"serve[W8A8 {wd}]: per layer, fed the plain path's input, "
          f"relative L2 of the layer's output (attention and MLP deltas, "
          f"{sum(rows)} rows) against the plain layer's, "
          f"({', '.join(labels)}):", flush=True)
    for i in range(layers):
        print(f"serve[W8A8 {wd}]: layer {i}: " + " ".join(
            f"{per_layer[label][i]:.5f}" for label in labels)
            + (f" (A and B torch.equal their plain versions: "
               f"{ab_equal[i]})" if ab_equal is not None else ""),
            flush=True)
    shown = ", ".join(f"{label} {e:.5f}" for label, e in control_best.items())
    print(f"serve[W8A8 {wd}]: {rid}: the kernel path's worst layer "
          f"{kernel_worst:.5f} (limit {limit}; the controls' best layers, "
          f"which must fall past it: {shown}); at full depth, the "
          f"first-token logits: kernels A and B vs their plain versions "
          f"{ops_err:.5f}{' (torch.equal)' if ops_err == 0 else ''}, the "
          f"kernel path vs the plain path {err:.5f}, two plain paths "
          f"{floor:.5f}, vs the bf16 model's kernels {vs_bf16:.5f} (not "
          f"bounded), same argmax: {record['same_argmax_as_plain']} "
          f"[{card}]", flush=True)
    if not bool(torch.isfinite(lk).all()):
        raise AssertionError(f"W8A8 {wd} first-token logits not finite")
    if limit is None:
        raise AssertionError(f"W8A8 {wd}: no per-layer limit set (readings: "
                             f"kernel worst {kernel_worst}, controls' best "
                             f"{control_best})")
    if kernel_worst > limit:
        raise AssertionError(f"W8A8 {wd}: the kernel path's worst layer "
                             f"{kernel_worst} is past the limit {limit}")
    passed = [label for label, e in control_best.items() if e <= limit]
    if passed:
        raise AssertionError(f"W8A8 {wd}: the controls {passed} in the "
                             f"kernels' place come within the limit {limit} "
                             f"at some layer ({control_best}): the check "
                             f"cannot tell a fault")
    if wd == "int8" and not (torch.equal(lk, lw) and all(ab_equal)):
        raise AssertionError(f"W8A8 int8: kernels A and B vs their plain "
                             f"versions differ (full depth relative L2 "
                             f"{ops_err}; bitwise by layer {ab_equal}); "
                             f"they must be torch.equal")
    return record


def w8a8_phase(model, cfg, card, requests, bf16_logits):
    """The W8A8 serve runs of the 8B model: weights int8 and fp8 with
    W8A8 arithmetic (bf16 pages), each at spec_k 0 and 3 -- spec-on greedy
    tokens asserted equal to spec-off -- and one weight-only int8 run of
    4 of the 8 requests (``matmul_dtype`` auto: the dequantize path). Then, per
    W8A8 dtype, :func:`w8a8_logits_check`: each layer fed the same
    quantized model's plain path's input, the kernel path within
    :data:`W8A8_LAYER_LIMIT` of the plain layer and each of
    :data:`W8A8_CONTROLS` in the kernels' place past it (int8: kernels A
    and B ``torch.equal`` to their plain versions, by layer and at full
    depth), and the full-depth first-token logits printed against the
    plain path's and the bf16 model's; F2's window check under W8A8 int8;
    and a profiled
    W8A8 int8 decode tick, which must run kernels A and B and no cuBLAS
    GEMM. Returns (the runs' records, the phase's record)."""
    from triton_kubernetes_tpu_torch.models import paged, quantize_weights
    from triton_kubernetes_tpu_torch.serve import Request, ServeEngine

    reqs = list(requests) + repetitive_requests(cfg, Request)
    reqs = [reqs[i] for i in W8A8_REQUESTS]
    arrivals = {t: [W8A8_REQUESTS.index(i) for i in ids
                    if i in W8A8_REQUESTS]
                for t, ids in SPEC_ARRIVALS.items()}
    runs, record = [], {"logits": {}}
    probe = requests[4].tokens
    for wd in ("int8", "fp8"):
        qmodel = quantize_weights(model, wd)
        qcfg = dataclasses.replace(cfg, weight_quant=wd, matmul_dtype=wd)
        for spec_k in (0, SPEC_K):
            run = serve_run(qmodel, cfg, "bf16", spec_k, reqs, arrivals,
                            weights=(wd, wd))
            runs.append(run)
            agree = ""
            if spec_k:
                off, got = runs[-2]["tokens"], run["tokens"]
                run["tokens_equal_to_spec_off"] = sum(
                    x == y for r in reqs
                    for x, y in zip(got[r.request_id], off[r.request_id]))
                agree = (f"; {run['tokens_equal_to_spec_off']}/"
                         f"{run['generated_tokens']} tokens equal to "
                         f"spec_k=0")
                if run["tokens_equal_to_spec_off"] != run["generated_tokens"]:
                    raise AssertionError(f"W8A8 {wd} spec_k={spec_k}: greedy "
                                         f"tokens must equal spec_k=0's"
                                         + agree)
            print_serve_run(f"W8A8 {wd} weights, bf16 pages", run, reqs,
                            runs[0]["kv_pool_bytes"], card, agree)
        record["logits"][wd] = w8a8_logits_check(
            qmodel, qcfg, probe, bf16_logits, wd, card,
            requests[4].request_id)
        if wd == "int8":
            f2 = window_invariance_check(qmodel, qcfg, paged,
                                         "W8A8 int8, bf16 pages")
            if f2["pages_differing"]:
                raise AssertionError(f"F2 under W8A8 int8: "
                                     f"{f2['pages_differing']} full pages "
                                     f"differ")
            record["window_invariance"] = [f2]
            engine = ServeEngine(qmodel, cfg, device=SERVE_DEVICE,
                                 weight_dtype=wd, matmul_dtype=wd,
                                 **SERVE_ENGINE_KW)
            pprof = profile_prefill(engine, cfg, Request)
            prof = profile_decode(engine, cfg, Request)
            del engine
            print_tick_profile(f"W8A8 int8 prefill window ({PREFILL_CHUNK} "
                               f"tokens at offset {2 * PREFILL_CHUNK}, one "
                               f"sequence)", pprof, card)
            print_tick_profile("W8A8 int8 decode tick (8 x ~600-token "
                               "contexts)", prof, card)
            # Every W8A8 input but wo's is quantized by the launch that
            # produces it: a norm at each of the 2 L + 1 norms, the SwiGLU
            # once a layer; wo's by the standalone kernel A (the launch
            # counters, exact); the profile must see those kernels run and
            # no bf16 norm or GEMM, no cuBLAS.
            layers = cfg.num_layers
            want = {"rms_norm_quant": 1, "add_rms_norm_quant": 2 * layers,
                    "swiglu_quant": layers, "quantize_rows": layers,
                    "rms_norm": 0, "add_rms_norm": 0, "decode_gemm": 0}
            for what, p in (("decode tick", prof), ("prefill window", pprof)):
                got = {k: p["row_launches_per_tick"][k] for k in want}
                if got != want:
                    raise AssertionError(f"W8A8 int8 {what}: launches a "
                                         f"tick {got}, want {want}")
                ran = p["kernels_per_tick_by_class"]
                if p["device_idle_share"] is not None and not (
                        all(ran[k + " kernel"] for k in (
                            "rms_norm_quant", "swiglu_quant",
                            "quantize_rows", "decode_gemm_w8a8"))
                        and not any(ran[k] for k in (
                            "rms_norm kernel", "decode_gemm kernel",
                            "GEMM (cuBLAS)"))):
                    raise AssertionError(f"W8A8 int8 {what}: kernels by "
                                         f"class {ran}: want kernel A's "
                                         f"three forms and decode_gemm_w8a8,"
                                         f" no bf16 norm or GEMM")
            record["decode_tick_profile"] = prof
            record["window_profile"] = pprof
        del qmodel
        gc.collect()
        torch.cuda.empty_cache()
    # The dequantize path serves 4 of the 8 requests of phase 4's first
    # run (no drafter at spec_k 0 to feed), all submitted at tick 0: at a
    # TPOT near 0.18 s it is the slowest serve run of the script.
    few = [requests[i] for i in DEQUANT_REQUESTS]
    run = serve_run(model, cfg, "bf16", 0, few,
                    {0: list(range(len(few)))}, weights=("int8", "auto"))
    runs.append(run)
    print_serve_run("int8 weights, dequantize path (matmul_dtype auto), "
                    "bf16 pages", run, few, runs[0]["kv_pool_bytes"],
                    card, "")
    return runs, record


def print_serve_run(what, run, reqs, base_pool_bytes, card, agree):
    """One serve run's line: ticks, launches, TTFT, TPOT, throughput,
    speculation, quant error and pool bytes."""
    rate = run["accept_rate"]
    tpv = run["tokens_per_seq_per_verify"]
    print(f"serve[{what}, spec_k={run['spec_k']}]: {len(reqs)} requests, "
          f"{run['prefill_windows']} windows, {run['decode_steps']} decode + "
          f"{run['verify_steps']} verify ticks, launches {run['launches']}; "
          f"TTFT median {statistics.median(run['ttft_s']):.4f} s, TPOT "
          f"median {statistics.median(run['tpot_s']):.5f} s, "
          f"{run['tokens_per_s']:.2f} tokens/s over {run['wall_s']:.3f} s; "
          f"proposed {run['proposed']:.0f}, accepted {run['accepted']:.0f} "
          f"(rate {'n/a' if rate is None else f'{rate:.4f}'}), tokens per "
          f"sequence per verify {'n/a' if tpv is None else f'{tpv:.4f}'}; "
          f"quant error k {run['quant_error']['k']:.6f} v "
          f"{run['quant_error']['v']:.6f}; pool bytes {run['kv_pool_bytes']} "
          f"({run['kv_pool_bytes'] / base_pool_bytes:.4f} x bf16){agree} "
          f"[{card}]", flush=True)


def rewind_probe(model, cfg, kind, prompt):
    """One prefilled sequence of 254 tokens (so the junk run crosses a page
    edge and anchors a page's scale); verify it with junk drafts, rewind
    with keep = 1. Every rejected slot and every scale must be byte-equal
    to the pre-verify pool; the kept slot is compared with the write of a
    decode step and reported."""
    from triton_kubernetes_tpu_torch.models import paged
    from triton_kubernetes_tpu_torch.ops.paged_attention import (
        TRASH_PAGE, byte_view)

    prompt = list(prompt[:254])
    n = len(prompt)
    logits, cache, table = prefill_fresh(
        model, cfg, prompt, None, paged,
        "auto" if kind == "bf16" else kind, spare_windows=1)
    tok0 = int(logits.argmax())
    dev = SERVE_DEVICE
    bt, lens = table[None], torch.tensor([n], dtype=torch.int32, device=dev)
    fields = ("k", "v", "k_scale", "v_scale")
    before = {f: byte_view(getattr(cache, f)).clone() for f in fields
              if getattr(cache, f) is not None}
    ref = paged.PagedKVCache(*[None if getattr(cache, f) is None
                               else getattr(cache, f).clone()
                               for f in fields])
    junk = [tok0] + [(tok0 + 7 * (j + 1)) % cfg.vocab_size
                     for j in range(SPEC_K)]
    with torch.inference_mode():
        paged.paged_decode_step(
            model, torch.tensor([tok0], dtype=torch.int32, device=dev), cfg,
            ref, bt, lens)
        _, undo = paged.paged_verify_step(
            model, torch.tensor([junk], dtype=torch.int32, device=dev), cfg,
            cache, bt, lens)
        wrote = not torch.equal(byte_view(cache.k), before["k"])
        paged.paged_rewind(cache, undo, bt, lens,
                           torch.tensor([1], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    if not wrote:
        raise AssertionError(f"rewind probe ({kind}): the verify wrote "
                             f"nothing; the probe is vacuous")
    page, slot = int(table[n // BS]), n % BS
    for f in ("k", "v"):
        got = byte_view(getattr(cache, f))
        keep = torch.ones(got.shape[:4], dtype=torch.bool, device=dev)
        keep[:, page, :, slot] = False
        keep[:, TRASH_PAGE] = False
        if not torch.equal(got[keep], before[f][keep]):
            raise AssertionError(f"rewind probe ({kind}): a rejected slot "
                                 f"of {f} differs from the pre-verify pool")
    for f in ("k_scale", "v_scale"):
        if f in before and not torch.equal(getattr(cache, f)[:, 1:],
                                           before[f][:, 1:]):
            raise AssertionError(f"rewind probe ({kind}): {f} not restored")
    kept = {}
    for f in ("k", "v"):
        a = getattr(cache, f)[:, page, :, slot].float()
        b = getattr(ref, f)[:, page, :, slot].float()
        kept[f] = dict(bitwise=bool(torch.equal(
            byte_view(getattr(cache, f))[:, page, :, slot],
            byte_view(getattr(ref, f))[:, page, :, slot])),
            max_abs_diff=float((a - b).abs().max()))
    print(f"rewind probe ({kind} pages, prompt {n} tokens, junk drafts "
          f"{junk[1:]}, keep 1): every rejected slot"
          f"{' and scale' if 'k_scale' in before else ''} byte-equal to the "
          f"pre-verify pool; kept slot vs a decode step's write: {kept}",
          flush=True)
    del cache, ref, undo, before
    gc.collect()
    torch.cuda.empty_cache()
    return dict(kind=kind, prompt_tokens=n, kept_slot_vs_decode=kept)


# Phase 4b: the Mixtral MoE family. Mixtral-8x7B at full width (D 4096,
# F 14336, E 8, K 2, V 32000) with random bf16 weights from seed 0. The
# whole model, 93.4 GB in bf16, does not fit one 80 GB card, so serving
# cuts it to 4 of 32 layers (11.8 GB of weights, 0.5 GB of pool: the
# script's time budget; 16 fit) and
# training to 2 (3.17B parameters at 16 bytes each: f32 masters,
# gradients and two Adam moments, 50.6 GB; 3 layers would need 73.9 GB
# before activations). Capacity factor 4.0 = E / K: dropless routing, which
# generate requires and which makes the serving layer's rows independent
# of the row count (an expert's C slots are then the step's rows).
MIXTRAL_MODEL = "mixtral-8x7b"
MIXTRAL_SERVE_LAYERS = 4
MIXTRAL_CF = 4.0
# Row counts of the serving MoE layer's bitwise check: a lone sequence, a
# decode tick, a verify tick, a prefill window.
MOE_ROWS = (1, 8, 32, 256)
# The decode tick's shape of the expert products: E experts of C = 8
# slots (dropless at B 8).
MOE_TICK_SLOTS = 8
# Clock cycles of the spin ahead of each timed expert-products call (~2 ms
# at the H100's 1.98 GHz boost clock).
MOE_SPIN_CYCLES = 4_000_000
MIXTRAL_TRAIN_LAYERS, MIXTRAL_TRAIN_STEPS, MIXTRAL_TRAIN_SYNC = 2, 6, 2
MIXTRAL_TRAIN_ARGV = [
    "--model", MIXTRAL_MODEL, "--model-opt",
    f"num_layers={MIXTRAL_TRAIN_LAYERS}", "--expert", "1",
    "--model-opt", "fused_ce=true", "--model-opt", "attention=flash",
    "--precision", "bf16", "--remat-policy", "full",
    "--steps", str(MIXTRAL_TRAIN_STEPS), "--batch-size", str(TRAIN_BATCH),
    "--seq-len", str(TRAIN_SEQ), "--sync-every", str(MIXTRAL_TRAIN_SYNC),
    "--log-every", str(MIXTRAL_TRAIN_SYNC), "--learning-rate", "3e-4",
    "--warmup-steps", "1", "--device", TRAIN_DEVICE, "--prefetch", "0"]
# A layer's aux loss lies between 0.99 (the reference test's floor; 1 is
# perfectly balanced routing) and E (every token's first choice on one
# expert that holds all the probability).
AUX_PER_LAYER = 0.99


@contextlib.contextmanager
def counting_moe_gemms():
    """Count ops/moe.py's decode_gemm launches into MOE_GEMMS while the
    block runs: the router's (f32 operands) and the experts' (bf16)."""
    from triton_kubernetes_tpu_torch.ops import moe

    real = moe.decode_gemm_group

    def counted(x, ws, out_dtype=None):
        if x.shape[0]:
            MOE_GEMMS["router" if x.dtype == torch.float32
                      else "experts"] += 1
        return real(x, ws, out_dtype)

    moe.decode_gemm_group = counted
    try:
        yield MOE_GEMMS
    finally:
        moe.decode_gemm_group = real


def moe_rows_check(model, cfg, flush, peaks, card):
    """The serving MoE layer (``moe_layer_rows``: the router on the f32
    decode GEMM, each expert's w3+w1 and w2 on the bf16 one) on layer 0's
    weights: its rows at M 1, 8 and 32 bitwise its rows at M 256, the
    router's gates alone too; each M within ATOL + RTOL |plain| of the
    plain ``moe_layer``; then the expert products of a decode tick (E 8,
    C 8) timed as the layer launches them (2 E launches), as the plain
    version (``torch.mm`` each product in turn) and as ``torch.bmm`` (one
    call a weight over the experts), beside the bytes bound: device time,
    the host's enqueue hidden behind a spin."""
    from triton_kubernetes_tpu_torch.models import llama
    from triton_kubernetes_tpu_torch.ops import moe
    from triton_kubernetes_tpu_torch.ops.decode_gemm import (
        decode_gemm_group, decode_gemm_group_plain)

    layer = model.layers[0]
    ad = cfg.activation_dtype
    e, d, f = cfg.num_experts, cfg.embed_dim, cfg.mlp_dim
    dev = SERVE_DEVICE
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((max(MOE_ROWS), d), generator=gen, device=dev).to(ad)

    def rows(xx):
        return llama._mlp_normed(xx[None], layer, cfg,
                                 row_invariant=True)[0][0]

    def gates(xx):
        top_p, top_i, _ = moe._gates(moe.router_logits_rows(xx, layer.router),
                                     cfg.num_selected)
        return torch.cat([top_p, top_i.float()], dim=1)

    with torch.inference_mode():
        differing = rows_differing(rows, x, MOE_ROWS[:-1])
        gates_differing = rows_differing(gates, x, MOE_ROWS[:-1])
        errs = {m: check_close(
            f"MoE serve layer at {m} rows vs moe_layer", rows(x[:m]),
            llama._mlp_normed(x[:m][None], layer, cfg)[0][0])
            for m in MOE_ROWS}
        c = MOE_TICK_SLOTS
        xe = torch.randn((e, c, d), generator=gen, device=dev).to(ad)
        act = torch.randn((e, c, f), generator=gen, device=dev).to(ad)
        w1, w3, w2 = layer.moe_w1, layer.moe_w3, layer.moe_w2

        def kernel():
            return [decode_gemm_group(xe[i], [w3[i], w1[i]])
                    + decode_gemm_group(act[i], [w2[i]]) for i in range(e)]

        def plain():
            return [decode_gemm_group_plain(xe[i], [w3[i], w1[i]], ad)
                    + decode_gemm_group_plain(act[i], [w2[i]], ad)
                    for i in range(e)]

        def library():
            return torch.bmm(xe, w3), torch.bmm(xe, w1), torch.bmm(act, w2)

        product_err = max(check_close(f"expert {i} product {j}", g, p)
                          for i, (gs, ps) in enumerate(zip(kernel(), plain()))
                          for j, (g, p) in enumerate(zip(gs, ps)))
        # 16 and 24 wrapped launches take the host longer to enqueue than
        # the flush takes the card: a spin of ~2 ms hides the enqueue.
        ms, plain_ms, library_ms = (
            time_ms(fn, flush, spin_cycles=MOE_SPIN_CYCLES)
            for fn in (kernel, plain, library))
    nbytes = 2 * (3 * e * d * f + e * c * (d + f) + e * c * (2 * f + d))
    flops = 2 * 3 * e * c * d * f
    bound_ms = max(nbytes / peaks[0], flops / peaks[1]) * 1e3
    print(f"mixtral: MoE serve layer (layer 0, cf {cfg.capacity_factor}): "
          f"rows at M {list(MOE_ROWS[:-1])} differing from M "
          f"{MOE_ROWS[-1]}: {differing} (router gates alone: "
          f"{gates_differing}); max abs err vs moe_layer {errs} (bound "
          f"{ATOL} + {RTOL} |plain|)", flush=True)
    print(f"mixtral: expert products of a decode tick (E {e}, C {c}, D {d}, "
          f"F {f}; 2 E = {2 * e} decode_gemm launches): {ms:.4f} ms, plain "
          f"(torch.mm each in turn) {plain_ms:.4f} ms, torch.bmm "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes {nbytes}; "
          f"share {bound_ms / ms:.4f}), max abs err vs plain {product_err} "
          f"[{card}]", flush=True)
    if differing or gates_differing:
        raise AssertionError(f"MoE serve layer: rows at M {differing} (gates "
                             f"at {gates_differing}) are not bitwise the "
                             f"rows at M {MOE_ROWS[-1]}")
    return dict(rows=list(MOE_ROWS), rows_differing=differing,
                gates_rows_differing=gates_differing,
                max_abs_err_vs_plain={str(m): v for m, v in errs.items()},
                expert_products=dict(
                    experts=e, slots=c, launches=2 * e, ms=ms,
                    plain_ms=plain_ms, bmm_ms=library_ms, bound_ms=bound_ms,
                    bound_by="bytes" if nbytes / peaks[0] > flops / peaks[1]
                    else "operations", bytes=nbytes, max_abs_err=product_err))


def first_token_check(model, cfg, paged, probe):
    """A prompt's first-token logits through its prefill windows, the
    kernels against the plain attention path, with the kernels' expert
    choices replayed in the plain path (``routing``): asserted within
    LOGITS_REL_L2 and LOGITS_REL_MAX. An ulp of attention can move a token
    across a top-2 boundary at some layer, and a moved choice sends that
    token through another expert: a discrete change no bound on the
    kernels can hold. So the plain path routing for itself is reported
    beside it, with the choices that moved, and so are two plain paths
    (the whole-prompt prefill against the windows), which differ the same
    way."""
    choices, own = [], []
    with routing("record", choices):
        lk = first_token_logits(model, cfg, probe.tokens, None, paged)
    with routing("replay", choices):
        ld = first_token_logits(model, cfg, probe.tokens, "dense", paged)
    with routing("record", own):
        lo = first_token_logits(model, cfg, probe.tokens, "dense", paged)
    moved = sum(int((a != b).any(dim=1).sum()) for a, b in zip(choices, own))
    n = len(probe.tokens)
    width = -(-n // BS) * BS
    cache = paged.init_paged_cache(cfg, width // BS + 1, BS,
                                   device=SERVE_DEVICE)
    with torch.inference_mode():
        lw = paged.paged_prefill(
            model, torch.tensor([probe.tokens + [0] * (width - n)],
                                dtype=torch.int32, device=SERVE_DEVICE),
            n, cfg, cache, torch.arange(1, width // BS + 1, dtype=torch.int32,
                                        device=SERVE_DEVICE))
    del cache
    out = dict(rel_l2=rel_l2(lk, ld),
               max_abs_diff=float((lk - ld).abs().max()),
               max_abs=float(ld.abs().max()),
               same_argmax=int(lk.argmax()) == int(ld.argmax()),
               own_routing_rel_l2=rel_l2(lk, lo), choices_moved=moved,
               rows_routed=sum(int(c.shape[0]) for c in choices),
               plain_paths_rel_l2=rel_l2(lw, lo))
    print(f"mixtral: {probe.request_id} ({n} tokens) first-token logits, "
          f"kernels vs plain attention on the kernels' expert choices: "
          f"relative L2 {out['rel_l2']:.5f} (bound {LOGITS_REL_L2}), max abs "
          f"diff {out['max_abs_diff']:.5f} (max |logit| {out['max_abs']:.4f})"
          f", same argmax {out['same_argmax']}; the plain path routing for "
          f"itself: relative L2 {out['own_routing_rel_l2']:.5f}, {moved} of "
          f"{out['rows_routed']} token routings moved; two plain paths "
          f"(whole prompt vs windows, each routing for itself) "
          f"{out['plain_paths_rel_l2']:.5f}", flush=True)
    if (not bool(torch.isfinite(lk).all()) or out["rel_l2"] > LOGITS_REL_L2
            or out["max_abs_diff"] > LOGITS_REL_MAX * out["max_abs"]):
        raise AssertionError(f"mixtral first-token logits, kernels vs plain "
                             f"on the same expert choices: {out}")
    return out


def mixtral_serve(card):
    """Mixtral-8x7B cut to MIXTRAL_SERVE_LAYERS layers, served: the MoE
    rows check, verify rows against decode, the 12 requests on bf16 pages
    at spec_k 0 and 3 (spec-on tokens equal to spec-off; every kernel's
    launches per tick -- ``serve_run`` asserts the attention's, one a
    layer, and the decode GEMM's -- and the experts' 2 E a layer, the
    router's one), the first-token logits against the plain attention
    path (``first_token_check``), F2 and a profiled prefill window and
    decode tick."""
    from triton_kubernetes_tpu_torch.models import get_config, init_params
    from triton_kubernetes_tpu_torch.models import paged
    from triton_kubernetes_tpu_torch.serve import Request, ServeEngine

    cfg = get_config(MIXTRAL_MODEL, num_layers=MIXTRAL_SERVE_LAYERS,
                     capacity_factor=MIXTRAL_CF)
    _, peaks = card_peaks(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=SERVE_DEVICE)
    torch.cuda.synchronize()
    weight_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9
    print(f"mixtral: {MIXTRAL_MODEL} cut to {cfg.num_layers} layers (width "
          f"{cfg.embed_dim}, mlp {cfg.mlp_dim}, {cfg.num_experts} experts, "
          f"top {cfg.num_selected}, vocab {cfg.vocab_size}, capacity factor "
          f"{cfg.capacity_factor}): {cfg.num_params() / 1e9:.3f}B params, "
          f"{weight_gb:.2f} GB, initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8,
                        device=SERVE_DEVICE)
    rows = moe_rows_check(model, cfg, flush, peaks, card)
    del flush
    with counting_moe_gemms():
        rows_check = verify_rows_check(model, cfg, paged)
        requests = make_requests(cfg, Request)
        reqs = requests + repetitive_requests(cfg, Request)
        runs = []
        for spec_k in (0, SPEC_K):
            run = serve_run(model, cfg, "bf16", spec_k, reqs, SPEC_ARRIVALS)
            run["moe_gemms"] = dict(MOE_GEMMS)
            units = (run["decode_steps"] + run["verify_steps"]
                     + run["prefill_windows"])
            want = {"router": units * cfg.num_layers,
                    "experts": units * 2 * cfg.num_experts * cfg.num_layers}
            if run["moe_gemms"] != want:
                raise AssertionError(f"mixtral spec_k={spec_k}: MoE GEMM "
                                     f"launches {run['moe_gemms']} != {want}")
            run["launches_per_decode_tick"] = {
                "paged_decode": (run["launches"]["paged_decode"]
                                 / max(run["decode_steps"], 1)),
                "moe_experts": 2 * cfg.num_experts * cfg.num_layers,
                "moe_router": cfg.num_layers,
                "decode_gemm": (3 + 2 * cfg.num_experts) * cfg.num_layers + 1}
            agree = ""
            if spec_k:
                same, first = tokens_equal(run, runs[0], reqs)
                run["tokens_equal_to_spec_off"] = same
                agree = (f"; {same}/{run['generated_tokens']} tokens equal "
                         f"to spec_k=0, first differences {first}")
                if same != run["generated_tokens"]:
                    raise AssertionError(f"mixtral spec_k={spec_k}: greedy "
                                         f"tokens must equal spec_k=0's"
                                         + agree)
            runs.append(run)
            print_serve_run("mixtral bf16 pages", run, reqs,
                            run["kv_pool_bytes"], card, agree)
            print(f"mixtral[spec_k={spec_k}]: MoE GEMM launches "
                  f"{run['moe_gemms']} over {units} ticks and windows; per "
                  f"decode tick {run['launches_per_decode_tick']}",
                  flush=True)

        logits = first_token_check(model, cfg, paged, requests[4])
        f2 = window_invariance_check(model, cfg, paged,
                                     "mixtral bf16 weights, bf16 pages")
        if f2["pages_differing"]:
            raise AssertionError(f"mixtral F2: {f2['pages_differing']} full "
                                 f"pages differ between prefill_chunk "
                                 f"{F2_CHUNKS}")
        engine = ServeEngine(model, cfg, device=SERVE_DEVICE,
                             **SERVE_ENGINE_KW)
        engine.submit(Request("warmup", list(range(1, 65)), 2))
        engine.run_until_idle()
        engine.release_prefix_cache()
        pprof = complete_profile(
            engine, lambda: profile_prefill(engine, cfg, Request))
        prof = complete_profile(
            engine, lambda: profile_decode(engine, cfg, Request))
    del engine
    print_tick_profile(f"mixtral prefill window ({PREFILL_CHUNK} tokens at "
                       f"offset {2 * PREFILL_CHUNK}, one sequence)", pprof,
                       card)
    print_tick_profile("mixtral decode tick (8 x ~600-token contexts)", prof,
                       card)
    tick = prof["row_launches_per_tick"]
    want_tick = {"moe_experts": 2 * cfg.num_experts * cfg.num_layers,
                 "moe_router": cfg.num_layers,
                 "decode_gemm": (3 + 2 * cfg.num_experts) * cfg.num_layers
                 + 1}
    if any(tick[k] != v for k, v in want_tick.items()):
        raise AssertionError(f"mixtral profiled decode tick: launches "
                             f"{tick} != {want_tick}")
    peak = torch.cuda.max_memory_allocated()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, capacity_factor=cfg.capacity_factor,
                weight_gb=weight_gb, moe_rows=rows,
                verify_rows_vs_decode=rows_check, runs=runs,
                first_token_logits=logits, window_invariance=f2,
                prefill_window_profile=pprof, decode_tick_profile=prof,
                peak_memory_bytes=peak)


@contextlib.contextmanager
def routing(mode, log):
    """Record (``mode`` "record") every ``ops.moe._top_k`` call's expert
    choices into ``log``, or replay them in order ("replay"): the same
    experts, their probabilities gathered from this run's softmax. Two
    runs of one step then route alike, whatever ulps their attention
    differs by."""
    from triton_kubernetes_tpu_torch.ops import moe

    real = moe._top_k
    replay = iter(list(log))

    def top_k(probs, k):
        if mode == "record":
            vals, idx = real(probs, k)
            log.append(idx)
            return vals, idx
        idx = next(replay)
        return probs.gather(-1, idx), idx

    moe._top_k = top_k
    try:
        yield log
    finally:
        moe._top_k = real


def mixtral_train(card, out_dir: Path):
    """``python -m triton_kubernetes_tpu_torch.train --model mixtral-8x7b
    --expert 1`` on the MIXTRAL_TRAIN_LAYERS-layer cut, B TRAIN_BATCH x
    TRAIN_SEQ: finite losses, aux losses in range, the dispatch ``auto``
    chose, flash launches 4/2/2 a step, step times, tokens/s, MFU over
    active parameters and peak memory; then one step against plain flash
    on a fresh model (``step_cross_check``)."""
    from triton_kubernetes_tpu_torch.models import get_config, llama
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa
    from triton_kubernetes_tpu_torch.train import apply_policy
    from triton_kubernetes_tpu_torch.train import __main__ as train_main

    report_path = out_dir / "mixtral_train_report.json"
    fa.reset_launch_counts()
    rc = train_main.main(MIXTRAL_TRAIN_ARGV
                         + ["--report-json", str(report_path)])
    launches = dict(fa.flash_attention.launches)
    if rc != 0:
        raise AssertionError(f"mixtral trainer exited {rc}")
    rep = json.loads(report_path.read_text())
    layers = MIXTRAL_TRAIN_LAYERS
    experts = get_config(MIXTRAL_MODEL).num_experts
    vals = rep["losses"] + rep["grad_norms"] + rep["aux_losses"]
    if rep["steps"] != MIXTRAL_TRAIN_STEPS or not all(np.isfinite(vals)):
        raise AssertionError(f"mixtral trainer: {rep['steps']} steps, "
                             f"losses {rep['losses']}, grad norms "
                             f"{rep['grad_norms']}, aux {rep['aux_losses']}")
    if not all(AUX_PER_LAYER * layers <= a <= experts * layers
               for a in rep["aux_losses"]):
        raise AssertionError(f"mixtral aux losses {rep['aux_losses']} "
                             f"outside [{AUX_PER_LAYER * layers}, "
                             f"{experts * layers}]")
    if rep["moe_dispatch"] != "sort":
        raise AssertionError(f"mixtral: auto dispatch chose "
                             f"{rep['moe_dispatch']} at T "
                             f"{TRAIN_BATCH * TRAIN_SEQ}")
    want = {k: n * layers * MIXTRAL_TRAIN_STEPS
            for k, n in FLASH_PER_LAYER.items()}
    if launches != want:
        raise AssertionError(f"mixtral flash launches {launches} != {want}")
    steady = rep["windows"][1:]  # the first window carries the first step
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tps = tokens * sum(n for n, _ in steady) / sum(dt for _, dt in steady)
    mfu = tps * rep["flops_per_token"] / (rep["peak_bf16_tflops"] * 1e12)
    step_ms = [dt / n * 1e3 for n, dt in rep["windows"]]
    peak_gb = (rep["peak_memory_bytes"] or 0) / 1e9
    print(f"mixtral train: {MIXTRAL_MODEL} cut to {layers} layers "
          f"({rep['num_params'] / 1e9:.3f}B params, "
          f"{rep['active_params'] / 1e9:.3f}B active, f32 masters, bf16 "
          f"compute, remat {rep['remat']}, fused CE, flash), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {rep['steps']} steps synced every "
          f"{MIXTRAL_TRAIN_SYNC}, dispatch {rep['moe_dispatch']}; losses "
          f"{[round(x, 5) for x in rep['losses']]}, aux "
          f"{[round(x, 5) for x in rep['aux_losses']]}; step ms by window "
          f"{[round(x, 3) for x in step_ms]}, steady {tps:.1f} tokens/s, "
          f"MFU {mfu:.4f} over active parameters "
          f"({rep['flops_per_token'] / 1e9:.3f} GFLOP/token against "
          f"{rep['peak_bf16_tflops']:.0f} TFLOP/s), peak memory "
          f"{peak_gb:.2f} GB, flash launches {launches} [{card}]",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = apply_policy(get_config(
        MIXTRAL_MODEL, num_layers=layers, fused_ce=True, attention="flash",
        remat=True, remat_policy="full"), "bf16")
    model = llama.init_params(cfg, seed=1, device=TRAIN_DEVICE,
                              trainable=True)
    check = step_cross_check(model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"mixtral train: step at B 1, S {TRAIN_SEQ}, kernels vs plain "
          f"flash on the same expert choices: loss rel diff "
          f"{check['loss_rel_diff']:.3g} (bound {STEP_LOSS_REL}), worst "
          f"gradient leaf rel L2 {check['grad_max_rel_l2']:.4g} (bound "
          f"{STEP_GRAD_REL_L2}); dense vs plain flash "
          f"{check['floor_loss_rel_diff']:.3g} / "
          f"{check['floor_grad_max_rel_l2']:.4g}; plain flash routing for "
          f"itself moves {check['own_routing_tokens_moved']} token choices "
          f"of {check['routing_calls']} routing calls, giving "
          f"{check['own_routing_loss_rel_diff']:.3g} / "
          f"{check['own_routing_grad_max_rel_l2']:.4g} [{card}]",
          flush=True)
    return launches, dict(report=rep, steady_tokens_per_sec=tps, mfu=mfu,
                          step_ms=step_ms, peak_memory_gb=peak_gb,
                          launches=launches, cross_check=check)


def mixtral_phase(card, out_dir: Path):
    """Phase 4b: serve, then train, the Mixtral family. Returns (each
    kernel's launches on the Mixtral path, the record)."""
    serve = mixtral_serve(card)
    train_launches, train = mixtral_train(card, out_dir)
    launches = {k: sum(run["launches"][k] for run in serve["runs"])
                for k in serve["runs"][0]["launches"]}
    launches.update(train_launches)
    used = ("paged_decode", "paged_verify", "paged_prefill", "decode_gemm",
            "decode_gemm_wgmma", "rms_norm", "add_rms_norm",
            *FLASH_PER_LAYER)
    idle = [k for k in used if not launches.get(k)]
    if idle:
        raise AssertionError(f"mixtral: kernels launched no time: {idle}")
    return launches, dict(serve=serve, train=train, launches=launches)


def flash_check(tag, q, k, v, do, errs):
    """Kernels 1-3 on one set of bf16 operands against their plain
    versions (the plain forward at the key tile of the kernel that runs);
    updates the worst errors in ``errs`` and returns (lse, dvec)."""
    from triton_kubernetes_tpu_torch.ops import _kernels
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa

    out, lse = _kernels.flash_fwd(q, k, v)
    want_out, want_lse = fa._flash_forward_plain(
        q, k, v, fa.kernel_block_k(q.dtype, q.shape[-1]))
    dvec = fa._row_dot(do, out)
    dq = _kernels.flash_bwd_dq(q, k, v, do, lse, dvec)
    dk, dv = _kernels.flash_bwd_dkv(q, k, v, do, lse, dvec)
    want_dq, want_dk, want_dv = fa._flash_backward_plain(q, k, v, do, lse,
                                                         dvec)
    torch.cuda.synchronize()
    errs["flash_fwd"] = max(errs["flash_fwd"], check_close(
        f"flash_fwd out {tag}", out, want_out))
    worst_lse = float((lse - want_lse).abs().max())
    if not worst_lse <= LSE_ATOL:
        raise AssertionError(f"flash_fwd lse {tag}: max abs err "
                             f"{worst_lse} > {LSE_ATOL}")
    errs["lse"] = max(errs["lse"], worst_lse)
    errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], check_close(
        f"flash_bwd_dq {tag}", dq, want_dq))
    errs["flash_bwd_dkv"] = max(
        errs["flash_bwd_dkv"],
        check_close(f"flash_bwd_dkv dk {tag}", dk, want_dk),
        check_close(f"flash_bwd_dkv dv {tag}", dv, want_dv))
    return lse, dvec


def flash_kernel_phase(device, flush, peaks):
    """Kernels 1-3 against their plain versions at Llama-3-8B heads, and
    one case per other design of ``_kernels.flash_variant``; timed at the
    training shape (B 4, S 2048). Returns their records."""
    from triton_kubernetes_tpu_torch.ops import _kernels
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa

    bw, flops_peak = peaks
    gen = torch.Generator(device=device).manual_seed(4321)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    errs = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                          "lse"), 0.0)
    timed = {}

    def rnd(b, s, h, d):
        return torch.randn((b, s, h, d), generator=gen, device=device
                           ).to(torch.bfloat16)

    for b, s, hq, hkv, d in FLASH_VARIANT_CASES:
        name = _kernels.flash_variant(torch.bfloat16, d)
        flash_check(f"B={b},S={s},Hq={hq},Hkv={hkv},D={d} ({name})",
                    rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d),
                    rnd(b, s, hq, d), errs)
    variants = {_kernels.flash_variant(torch.bfloat16, case[-1])
                for case in FLASH_VARIANT_CASES}
    variant = _kernels.flash_variant(torch.bfloat16, D)
    if variants | {variant} != set(_kernels.FLASH_VARIANTS):
        raise AssertionError(f"flash designs checked {variants | {variant}} "
                             f"!= {set(_kernels.FLASH_VARIANTS)}")
    for b, s in FLASH_SHAPES:
        q, k, v, do = (rnd(b, s, HQ, D), rnd(b, s, HKV, D),
                       rnd(b, s, HKV, D), rnd(b, s, HQ, D))
        lse, dvec = flash_check(f"B={b},S={s}", q, k, v, do, errs)
        if (b, s) != (TRAIN_BATCH, TRAIN_SEQ):
            continue
        # Timing at the training shape. The plain versions materialise
        # [B, Hq, S, S] f32 scores: median of 5 runs for them.
        block_k = fa.kernel_block_k(q.dtype, D)
        timed["flash_fwd"] = (
            time_ms(lambda: _kernels.flash_fwd(q, k, v), flush),
            time_ms(lambda: fa._flash_forward_plain(q, k, v, block_k),
                    flush, runs=5, warmup=1))
        timed["flash_bwd_dq"] = (
            time_ms(lambda: _kernels.flash_bwd_dq(q, k, v, do, lse, dvec),
                    flush),
            None)
        timed["flash_bwd_dkv"] = (
            time_ms(lambda: _kernels.flash_bwd_dkv(q, k, v, do, lse, dvec),
                    flush),
            time_ms(lambda: fa._flash_backward_plain(q, k, v, do, lse,
                                                     dvec),
                    flush, runs=5, warmup=1))
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        lib_fwd = time_ms(lambda: sdpa(qs, ks, vs, is_causal=True,
                                       enable_gqa=True), flush)
        o = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
        dos = do.transpose(1, 2)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), dos, retain_graph=True), flush)
        del o, qs, ks, vs

    b, s = TRAIN_BATCH, TRAIN_SEQ
    pairs = b * HQ * s * (s + 1) // 2  # (query, visible key) per head
    io = b * s * D * 2  # bytes of one [B, S, 1, D] bf16 head slice
    rows = b * HQ * s * 4  # one f32 row statistic
    work = {  # name: (FLOPs, bytes moved at least)
        "flash_fwd": (4 * D * pairs, io * (HQ + 2 * HKV + HQ) + rows),
        "flash_bwd_dq": (6 * D * pairs, io * (3 * HQ + 2 * HKV) + 2 * rows),
        "flash_bwd_dkv": (8 * D * pairs, io * (2 * HQ + 4 * HKV) + 2 * rows),
    }
    lines = {"flash_fwd": 75, "flash_bwd_dq": 196, "flash_bwd_dkv": 230}
    design = dict.fromkeys(work, variant)
    records = []
    for name, (flops, nbytes) in work.items():
        kms, pms = timed[name]
        bound_ms = max(flops / flops_peak, nbytes / bw) * 1e3
        records.append(dict(
            name=name, route="cuda",
            source=f"triton_kubernetes_tpu_torch/csrc/{name}.cu",
            replaces=f"triton_kubernetes_tpu/ops/flash_attention.py:"
                     f"{lines[name]}",
            variant=design[name],
            max_abs_err=errs[name],
            tolerance=f"{ATOL} + {RTOL} * |plain|",
            ms=kms, plain_ms=pms,
            library_ms=lib_fwd if name == "flash_fwd" else lib_bwd,
            library_call=("scaled_dot_product_attention(is_causal, "
                          "enable_gqa) forward" if name == "flash_fwd" else
                          "the same call's backward (dq, dk and dv "
                          "together)"),
            bound_ms=bound_ms,
            bound_by="operations" if flops / flops_peak >= nbytes / bw
            else "bytes",
            bound_share=bound_ms / kms,
            achieved_tflops=flops / (kms * 1e-3) / 1e12,
            flops=flops, bytes=nbytes,
            shape=dict(B=b, S=s, Hq=HQ, Hkv=HKV, D=D,
                       checked_at=FLASH_SHAPES,
                       variant_cases=FLASH_VARIANT_CASES)))
    records[0]["lse_max_abs_err"] = errs["lse"]
    # The plain backward computes dq, dk and dv in one pass: its time is
    # recorded once, on the dK/dV row, and the dQ row shares it.
    records[1]["plain_ms"] = records[2]["plain_ms"]
    records[1]["plain_note"] = "one plain pass computes dq, dk and dv"
    records[2]["plain_note"] = records[1]["plain_note"]
    for r in records:
        print(f"kernel {r['name']} ({r['variant']}; B={b}, S={s}): "
              f"max_abs_err={r['max_abs_err']:.6g} (tolerance "
              f"{r['tolerance']}) kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} bound_ms="
              f"{r['bound_ms']:.5f} ({r['bound_by']}; share "
              f"{r['bound_share']:.4f}), {r['achieved_tflops']:.1f} "
              f"TFLOP/s", flush=True)
    print(f"kernel flash_fwd: lse max abs err {errs['lse']:.3g} (bound "
          f"{LSE_ATOL})", flush=True)
    return records


def profile_train_step(step_fn, state, batch):
    """Device time of one training step by kernel class, with the step's
    wall time and the device's idle share (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class = {"flash kernels": 0.0, "GEMM (cuBLAS)": 0.0,
                "other kernels": 0.0}
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        if "flash_" in e.name and "kernel" in e.name:
            by_class["flash kernels"] += us
        elif e.name.startswith(("nvjet", "sm90_xmma", "cutlass")) \
                or "gemm" in e.name.lower():
            by_class["GEMM (cuBLAS)"] += us
        else:
            by_class["other kernels"] += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    by_class = {k: v / 1e3 for k, v in by_class.items()}
    busy = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                device_idle_share=(1 - busy / wall_ms) if busy else None,
                device_ms_by_class=by_class,
                top_kernels_ms=[(n[:90], us / 1e3) for n, us in top])


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def step_cross_check(model, cfg):
    """One step's loss and gradients at B 1, S TRAIN_SEQ on the same
    weights and batch: flash kernels, plain flash versions, dense
    attention. An MoE model's expert choices are the kernels' in every
    arm (the kernels' run records them, the others replay them:
    ``routing``): an ulp of attention can move a token across a top-2
    boundary, which changes an expert's gradient by that token's whole
    share. For an MoE model, plain flash routing for itself is reported
    too, with the choices it moved."""
    from triton_kubernetes_tpu_torch.models import llama
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa
    from triton_kubernetes_tpu_torch.train import loss_fn, synthetic_batches

    params = list(model.parameters())
    tokens = torch.from_numpy(next(synthetic_batches(
        cfg.vocab_size, 1, TRAIN_SEQ, seed=99))["tokens"]).to(model.device)

    def plain_flash(q, k, v, pos):
        return fa.flash_attention_plain(q, k, v)

    def step(attn, mode, log):
        for p in params:
            p.grad = None
        with routing(mode, log):
            total, metrics = loss_fn(model, tokens, cfg, attn)
            total.backward()
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        return float(metrics["loss"]), grads

    def compare(a, b):
        (la, ga), (lb, gb) = a, b
        return abs(la - lb) / abs(lb), max(rel_l2(x, y)
                                           for x, y in zip(ga, gb))

    choices = []
    kern = step(llama.resolve_attention(cfg, model.device), "record",
                choices)
    plain = step(plain_flash, "replay", choices)
    dense = step(llama._dense_attention, "replay", choices)
    loss_rel, grad_rel = compare(kern, plain)
    floor_loss, floor_grad = compare(dense, plain)
    out = dict(loss_kernels=kern[0], loss_plain_flash=plain[0],
               loss_dense=dense[0], loss_rel_diff=loss_rel,
               grad_max_rel_l2=grad_rel, floor_loss_rel_diff=floor_loss,
               floor_grad_max_rel_l2=floor_grad)
    del plain, dense
    if cfg.is_moe:
        own_choices = []
        own = step(plain_flash, "record", own_choices)
        out.update(
            zip(("own_routing_loss_rel_diff", "own_routing_grad_max_rel_l2"),
                compare(kern, own)),
            own_routing_tokens_moved=sum(
                int((a != b).any(dim=1).sum())
                for a, b in zip(choices, own_choices)),
            routing_calls=len(choices))
        del own
    del kern
    torch.cuda.synchronize()
    if not (loss_rel <= STEP_LOSS_REL and grad_rel <= STEP_GRAD_REL_L2):
        raise AssertionError(
            f"train step, kernels vs plain flash: loss rel diff {loss_rel} "
            f"(bound {STEP_LOSS_REL}), worst gradient leaf rel L2 "
            f"{grad_rel} (bound {STEP_GRAD_REL_L2})")
    return out


def train_phase(card, out_dir: Path):
    """The port's trainer entry point on the 4-layer full-width cut."""
    from triton_kubernetes_tpu_torch.models import get_config
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa
    from triton_kubernetes_tpu_torch.train import (
        apply_policy, init_state, make_optimizer, make_train_step,
        synthetic_batches)
    from triton_kubernetes_tpu_torch.train import __main__ as train_main
    from triton_kubernetes_tpu_torch.utils import trace

    report_path = out_dir / "train_report.json"
    trace_path = out_dir / "train_trace.jsonl"
    fa.reset_launch_counts()
    rc = train_main.main(TRAIN_ARGV + ["--report-json", str(report_path),
                                       "--trace-jsonl", str(trace_path)])
    launches = dict(fa.flash_attention.launches)
    if rc != 0:
        raise AssertionError(f"trainer exited {rc}")
    rep = json.loads(report_path.read_text())
    # The goodput ledger of the traced run: the five categories of this
    # loop must partition its recorded wall time.
    problems = trace.validate_goodput_trace([str(trace_path)])
    (ledger,) = trace.summarize_goodput([str(trace_path)])["processes"]
    cats = ("step", "compile", "host_sync", "data_wait", "idle")
    if problems or set(ledger["seconds"]) - set(cats) or abs(
            sum(ledger["seconds"].values()) - ledger["wall_s"]) > 1e-6:
        raise AssertionError(f"trainer goodput: {problems}, {ledger}")
    print(f"train: goodput ledger (--trace-jsonl) "
          + ", ".join(f"{c} {ledger['seconds'].get(c, 0.0):.4f} s"
                      for c in cats)
          + f" = wall {ledger['wall_s']:.4f} s, useful share "
          f"{ledger['useful_fraction']:.4f} [{card}]", flush=True)
    vals = rep["losses"] + rep["grad_norms"]
    if rep["steps"] != TRAIN_STEPS or not all(np.isfinite(vals)):
        raise AssertionError(f"trainer: {rep['steps']} steps, losses "
                             f"{rep['losses']}, grad norms "
                             f"{rep['grad_norms']}")
    want = {k: n * TRAIN_LAYERS * TRAIN_STEPS
            for k, n in FLASH_PER_LAYER.items()}
    if launches != want:
        raise AssertionError(f"flash launch counts {launches} != {want} "
                             f"(remat full: forward twice a layer)")
    step_s = [dt / n for n, dt in rep["windows"]]
    steady = step_s[TRAIN_WARMUP:]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tps = tokens * len(steady) / sum(steady)
    mfu = tps * rep["flops_per_token"] / (rep["peak_bf16_tflops"] * 1e12)
    peak_gb = (rep["peak_memory_bytes"] or 0) / 1e9
    print(f"train: llama3-8b cut to {TRAIN_LAYERS} layers (width "
          f"{rep['embed_dim']}, vocab {rep['vocab_size']}, "
          f"{rep['num_params'] / 1e9:.3f}B params, f32 masters, bf16 "
          f"compute, remat {rep['remat']}, fused CE, flash attention), "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps "
          f"({TRAIN_WARMUP} warm-up), init {rep['init_seconds']:.2f} s",
          flush=True)
    print(f"train: losses {[round(x, 5) for x in rep['losses']]}, grad "
          f"norms {[round(x, 5) for x in rep['grad_norms']]}", flush=True)
    print(f"train: step ms {[round(x * 1e3, 3) for x in step_s]}; steady "
          f"median {statistics.median(steady) * 1e3:.3f} ms, {tps:.1f} "
          f"tokens/s, MFU {mfu:.4f} (reference formula, "
          f"{rep['flops_per_token'] / 1e9:.3f} GFLOP/token against "
          f"{rep['peak_bf16_tflops']:.0f} TFLOP/s), peak memory "
          f"{peak_gb:.2f} GB, flash launches "
          f"{launches} [{card}]", flush=True)

    # A profiled step and the cross-check, on a fresh state of the same
    # config (the entry point's state is gone with its call).
    gc.collect()
    torch.cuda.empty_cache()
    cfg = apply_policy(get_config(
        TRAIN_MODEL, num_layers=TRAIN_LAYERS, fused_ce=True,
        attention="flash", remat=True, remat_policy="full"), "bf16")
    opt = make_optimizer(learning_rate=3e-4, warmup_steps=1,
                         decay_steps=TRAIN_STEPS)
    state = init_state(cfg, opt, seed=1, device=TRAIN_DEVICE)
    step_fn = make_train_step(cfg, opt)
    batch = next(synthetic_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ))
    for _ in range(2):
        step_fn(state, batch)
    prof = profile_train_step(step_fn, state, batch)
    classes = ", ".join(f"{k} {v:.3f} ms"
                        for k, v in prof["device_ms_by_class"].items())
    print(f"train: profiled step: wall {prof['wall_ms']:.3f} ms, device "
          f"busy {prof['device_busy_ms']:.3f} ms (idle share "
          f"{prof['device_idle_share']}); {classes} [{card}]", flush=True)
    for kname, ms in prof["top_kernels_ms"]:
        print(f"train: profiled step: {ms:9.3f} ms  {kname}", flush=True)
    state.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    check = step_cross_check(state.model, cfg)
    print(f"train: step at B 1, S {TRAIN_SEQ}, kernels vs plain flash: "
          f"loss {check['loss_kernels']:.6f} vs "
          f"{check['loss_plain_flash']:.6f} (rel diff "
          f"{check['loss_rel_diff']:.3g}, bound {STEP_LOSS_REL}), worst "
          f"gradient leaf rel L2 {check['grad_max_rel_l2']:.4g} (bound "
          f"{STEP_GRAD_REL_L2}); two plain paths (dense vs plain flash) "
          f"differ by {check['floor_loss_rel_diff']:.3g} in loss and "
          f"{check['floor_grad_max_rel_l2']:.4g} in the worst leaf",
          flush=True)
    return launches, dict(report=rep, goodput=ledger, step_seconds=step_s,
                          steady_tokens_per_sec=tps, mfu=mfu,
                          launches=launches, profile=prof,
                          cross_check=check)



# Phase 5's kill and resume: subprocesses of the entry point, so SIGTERM
# is a real signal. A runs DURABLE_STEPS uninterrupted; B checkpoints
# every DURABLE_CKPT_EVERY and is sent SIGTERM once it logs step
# DURABLE_KILL_AT (past its first checkpoint, step 4); C resumes from the
# emergency directory; D resumes over a
# copy of both directories whose newest step has one leaf corrupted.
# Checkpoints go to DURABLE_DIR in the checkout, deleted at the end.
#
# The script keeps its disk writes under 40 GB (hosts that run it cap a
# run's writes near 45 GiB), and a full-width checkpoint is 12.6 GB of
# embedding and head (f32 masters and two moments) plus 2.6 GB a layer:
# at phase 5's 4 layers B's two saves alone write 46 GB. So the arms cut
# depth to DURABLE_LAYERS (15.2 GB a checkpoint, 30.4 GB for B's two; the
# embedding and the head are most of it, so depth checks nothing more
# here and one layer costs the least disk time) and only B writes: C and
# D restore and save nothing (C is given no scheduled directory, D stops
# at the step it restores).
DURABLE_LAYERS = 1
DURABLE_STEPS, DURABLE_SYNC, DURABLE_CKPT_EVERY, DURABLE_KILL_AT = 12, 2, 4, 6
DURABLE_DIR = Path(__file__).resolve().parent / "_durable"
DURABLE_ARM_TIMEOUT_S = 420
DURABLE_CHECKPOINTS_ON_DISK = 2  # B's scheduled and emergency steps
# What shares the card with each arm (A beside B, then C beside D; in the
# full run phase 6 beside B once A ends): every time an arm prints is
# taken beside the other work, not alone.
DURABLE_BESIDE = {"A": "beside arm B", "B": "beside arm A, then phase 6",
                  "C": "beside arm D", "D": "beside arm C"}


def durable_argv():
    """The arms' command line: phase 5's cut at DURABLE_LAYERS,
    DURABLE_STEPS steps synced every DURABLE_SYNC, the trainer's default
    DevicePrefetch, JSON logs."""
    head = TRAIN_ARGV[:TRAIN_ARGV.index("--steps")]
    head[head.index(f"num_layers={TRAIN_LAYERS}")] = \
        f"num_layers={DURABLE_LAYERS}"
    return head + [
        "--steps", str(DURABLE_STEPS), "--batch-size", str(TRAIN_BATCH),
        "--seq-len", str(TRAIN_SEQ), "--learning-rate", "3e-4",
        "--warmup-steps", "1", "--sync-every", str(DURABLE_SYNC),
        "--log-every", str(DURABLE_SYNC), "--device", TRAIN_DEVICE,
        "--json-logs"]


def jobset_launch(name, argv):
    """The worker command and env of the GPU JobSet rendered for a trainer
    run with ``argv`` on a one-H100 pool (``modules/gcp_gpu.py``), as
    this host runs them: verbatim but for the coordinator's cluster-DNS
    host, which becomes 127.0.0.1, and the completion-index fieldRef,
    which becomes 0. Returns (command, env, the substitutions)."""
    from triton_kubernetes_tpu_torch.modules.gcp_gpu import \
        jobset_container, render_gpu_jobset

    rendered = render_gpu_jobset({
        "job_name": name, "cluster_id": "chip-smoke",
        "gpu_accelerator": f"h100-{torch.cuda.device_count()}",
        "slice_id": "chip-smoke-pool",
        "command": ["python", "-m", "triton_kubernetes_tpu_torch.train",
                    *argv]})
    container = jobset_container(rendered)
    env, subs = {}, []
    for e in container["env"]:
        if "value" in e:
            env[e["name"]] = e["value"]
        else:
            env[e["name"]] = "0"
            subs.append(f"{e['name']}: fieldRef "
                        f"{e['valueFrom']['fieldRef']['fieldPath']} -> 0")
    host, _, port = env["JAX_COORDINATOR_ADDRESS"].rpartition(":")
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    subs.append(f"JAX_COORDINATOR_ADDRESS: host {host} -> 127.0.0.1")
    return verbatim(container["command"], "jobset", subs), env, subs


def run_arm(name, extra, out_dir, kill_at=None, jobset=False):
    """One trainer subprocess: (exit code, its JSON log records, report,
    seconds from SIGTERM to exit or None). With ``kill_at`` it is sent
    SIGTERM once it logs that step; with ``jobset`` it runs the rendered
    GPU JobSet's command and env (``jobset_launch``)."""
    import os
    import signal
    import threading

    report = out_dir / f"train_arm_{name}.json"
    trace_path = out_dir / f"train_arm_{name}.jsonl"
    trace_path.unlink(missing_ok=True)
    argv = [*durable_argv(), "--report-json", str(report), "--trace-jsonl",
            str(trace_path), *extra]
    cmd, env = [sys.executable, "-m", "triton_kubernetes_tpu_torch.train",
                *argv], None
    if jobset:
        cmd, job_env, subs = jobset_launch(f"durable-{name.lower()}", argv)
        env = dict(os.environ, **job_env)
        print(f"train: durability: arm {name} runs the rendered GPU JobSet "
              f"(h100-{torch.cuda.device_count()}): command {cmd!r}, env "
              f"{job_env}; substituted: {'; '.join(subs)}", flush=True)
    # A session of its own: the JobSet's command is the host launcher
    # and its rank, and a kill takes both.
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)

    def kill():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    watchdog = threading.Timer(DURABLE_ARM_TIMEOUT_S, kill)
    watchdog.start()
    lines, t_kill = [], None
    try:
        for line in proc.stderr:
            lines.append(line)
            if kill_at is None or t_kill is not None \
                    or not line.startswith("{"):
                continue
            rec = json.loads(line)
            if rec.get("msg") == "train" and rec["step"] >= kill_at:
                t_kill = time.perf_counter()
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait()
        t_exit = time.perf_counter()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            kill()
            proc.wait()
    records = [json.loads(l) for l in lines if l.startswith("{")]
    if not report.exists():
        raise AssertionError(f"train arm {name}: exit {rc}, no report; "
                             f"stderr tail:\n{''.join(lines[-30:])}")
    return (rc, records, json.loads(report.read_text()), trace_path,
            None if t_kill is None else t_exit - t_kill, lines)


def arm_goodput(name, trace_path, must_book):
    """The arm's goodput ledger: partition-checked, the categories it must
    have booked present."""
    from triton_kubernetes_tpu_torch.utils import trace

    problems = trace.validate_goodput_trace([str(trace_path)])
    (ledger,) = trace.summarize_goodput([str(trace_path)])["processes"]
    secs = ledger["seconds"]
    if problems or abs(sum(secs.values()) - ledger["wall_s"]) > 1e-6 or [
            c for c in must_book if secs.get(c, 0.0) <= 0.0]:
        raise AssertionError(f"train arm {name} goodput: {problems}, "
                             f"{ledger} (must book {must_book})")
    return ledger


def corrupt_copy(src_dirs, copy_root, torn):
    """A copy of each checkpoint directory in ``src_dirs`` under
    ``copy_root`` (hard links: no bytes written), in which the step
    directory ``torn`` (a path under one of ``src_dirs``) has its smallest
    tensor leaf, a norm weight, replaced by a copy with one byte flipped;
    returns the copies and that file's name."""
    import os
    import shutil

    shutil.rmtree(copy_root, ignore_errors=True)
    copies = []
    for src in src_dirs:
        dst = copy_root / src.name
        copies.append(dst)
        for d in src.iterdir():
            if d.name.isdigit():
                (dst / d.name).mkdir(parents=True)
                for f in d.iterdir():
                    os.link(f, dst / d.name / f.name)
    step_dir = copy_root / torn.parent.name / torn.name
    victim = min((f for f in step_dir.iterdir()
                  if f.name != "manifest.json" and f.stat().st_size > 8),
                 key=lambda f: (f.stat().st_size, f.name))
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF
    victim.unlink()  # breaks the link: the original stays intact
    victim.write_bytes(bytes(data))
    return copies, victim.name


def durability_phase(card, out_dir: Path, beside_b=None):
    """Phase 5's kill and resume (module constants above): A, B, C and the
    torn copy D, each a trainer subprocess on the DURABLE_LAYERS cut, A
    beside B and C beside D; checks
    exit codes, the emergency save, the restore and the fallback, the
    losses, every arm's flash launches and goodput ledger. ``beside_b``
    (a callable) runs in this process once A has ended, while B, which
    then mostly waits on the disk, still holds its share of the card (a
    1-layer trainer, ~29 GB); its result is returned under "beside"."""
    import shutil

    from triton_kubernetes_tpu_torch.models import get_config
    from triton_kubernetes_tpu_torch.ops import _kernels

    gc.collect()
    torch.cuda.empty_cache()
    print(f"train: durability: before the arms this process holds "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB of the card "
          f"(memory_reserved)", flush=True)
    cfg = get_config(TRAIN_MODEL, num_layers=DURABLE_LAYERS)
    ckpt_bytes = 12 * cfg.num_params()  # f32 masters and two moments
    DURABLE_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(DURABLE_DIR).free
    need = DURABLE_CHECKPOINTS_ON_DISK * ckpt_bytes
    print(f"train: durability: a checkpoint is {ckpt_bytes / 1e9:.2f} GB; "
          f"the arms need {need / 1e9:.2f} GB of disk, "
          f"{free / 1e9:.2f} GB free at {DURABLE_DIR}", flush=True)
    if free < need:
        raise AssertionError(
            f"durability arms need {need} bytes of disk at {DURABLE_DIR} "
            f"({DURABLE_CHECKPOINTS_ON_DISK} checkpoints of {ckpt_bytes}), "
            f"{free} free")
    built = sorted(p.name for p in _kernels.BUILD_DIR.glob("*.so"))
    sched, emerg = DURABLE_DIR / "ckpt", DURABLE_DIR / "emergency"
    ckpt_args = ["--checkpoint-dir", str(sched), "--checkpoint-every",
                 str(DURABLE_CKPT_EVERY), "--emergency-dir", str(emerg)]
    per_step = {k: n * DURABLE_LAYERS for k, n in FLASH_PER_LAYER.items()}

    def check_launches(name, rep):
        want = {k: n * rep["steps"] for k, n in per_step.items()}
        if rep["kernel_launches"] != want or not rep["steps"]:
            raise AssertionError(f"train arm {name}: flash launches "
                                 f"{rep['kernel_launches']} != {want}")

    # A and B run side by side on the card, then C and D (each pair is
    # independent: A writes nothing, and D restores a copy); every check
    # is the same as run one after another. Once A ends, ``beside_b``
    # runs here while B goes on.
    arms, beside = {}, None
    side = concurrent.futures.ThreadPoolExecutor(2)
    arm_a = side.submit(timed, run_arm, "A", [], out_dir, jobset=True)
    arm_b = side.submit(timed, run_arm, "B", ckpt_args, out_dir,
                        kill_at=DURABLE_KILL_AT)
    try:
        try:
            (rc_a, a_recs, a, a_trace, _, lines_a), a_s = arm_a.result()
            if beside_b is not None:
                beside = beside_b()
        finally:
            (rc, recs, b, b_trace, kill_s, lines), b_s = arm_b.result()
        if rc_a != 0 or a["steps"] != DURABLE_STEPS or not all(
                np.isfinite(a["losses"])):
            raise AssertionError(f"arm A: exit {rc_a}, report {a}\n"
                                 + "".join(lines_a[-20:]))
        check_launches("A", a)
        # The JobSet's env put A in a world of one: the host launcher
        # started one rank, LOCAL_RANK 0, whose parse_distributed_env read
        # world 1, rank 0.
        joined = [r for r in a_recs if r.get("msg") == "distributed init"]
        if not (len(joined) == 1 and joined[0].get("process_id") == 0
                and joined[0].get("num_processes") == 1
                and joined[0].get("local_rank") == 0):
            raise AssertionError(f"arm A under the rendered JobSet: "
                                 f"distributed init {joined}")
        print(f"train: durability: arm A's log: {json.dumps(joined[0])}",
              flush=True)
        arms["A"] = dict(report=a, seconds=a_s)

        em = b["emergency_step"]
        msgs = [r["msg"] for r in recs]
        if (rc != 75 or b["outcome"] != "preempted" or em is None
                or em < DURABLE_KILL_AT
                or "emergency checkpoint saved" not in msgs):
            raise AssertionError(f"arm B: exit {rc} (want 75), emergency "
                                 f"step {em}, outcome {b['outcome']}\n"
                                 + "".join(lines[-30:]))
        manifest = json.loads((emerg / str(em) / "manifest.json")
                              .read_text())
        if manifest["kind"] != "emergency":
            raise AssertionError(f"arm B: step {em} manifest {manifest}")
        check_launches("B", b)
        b_ledger = arm_goodput("B", b_trace, ("checkpoint",
                                              "preempted_lost"))
        arms["B"] = dict(report=b, seconds=b_s,
                         sigterm_to_exit_s=kill_s, goodput=b_ledger)

        # D: the torn step. A copy of both directories whose newest step,
        # B's emergency step, has one leaf flipped: the restore across the
        # two must quarantine it and fall back to B's scheduled step (D
        # asks for no more steps than that, so it saves nothing).
        scheduled = max(int(p.name) for p in sched.iterdir()
                        if p.name.isdigit())
        (copy_sched, copy_emerg), victim = corrupt_copy(
            [sched, emerg], DURABLE_DIR / "torn", emerg / str(em))
        arm_c = side.submit(timed, run_arm, "C", [
            "--emergency-dir", str(emerg), "--resume"], out_dir)
        try:
            (rc, recs, d, _, _, lines), d_s = timed(run_arm, "D", [
                "--checkpoint-dir", str(copy_sched), "--emergency-dir",
                str(copy_emerg), "--resume", "--steps", str(scheduled)],
                out_dir)
        finally:
            (rc_c, c_recs, c, c_trace, _, lines_c), c_s = arm_c.result()
        quarantined = sorted(p.name for p in
                             (copy_emerg / "quarantine").iterdir())
        resumed = [r for r in recs if r["msg"] == "resumed"]
        if (rc != 0 or quarantined != [f"{em}-checksum-mismatch"]
                or not resumed or resumed[0]["step"] != scheduled
                or resumed[0]["emergency"] is not False):
            raise AssertionError(f"arm D (torn step {em}, {victim}): "
                                 f"exit {rc}, quarantined {quarantined}, "
                                 f"resumed {resumed}\n"
                                 + "".join(lines[-30:]))

        rc, recs, lines = rc_c, c_recs, lines_c
        resumed = [r for r in recs if r["msg"] == "resumed"]
        if (rc != 0 or not resumed or resumed[0]["step"] != em
                or resumed[0]["emergency"] is not True
                or c["start_step"] != em
                or c["steps"] != DURABLE_STEPS - em):
            raise AssertionError(f"arm C: exit {rc}, resumed {resumed}, "
                                 f"report start {c['start_step']} steps "
                                 f"{c['steps']}\n" + "".join(lines[-30:]))
        check_launches("C", c)
        c_ledger = arm_goodput("C", c_trace, ("rollback_replay",))
        arms["C"] = dict(report=c, seconds=c_s, goodput=c_ledger)
        arms["D"] = dict(report=d, seconds=d_s, torn_step=em,
                         torn_file=victim, quarantined=quarantined,
                         fell_back_to=scheduled)

        # Losses: B before the kill against A, then C after the restore.
        ref = a["losses"]
        b_diff = max(abs(x - y) / abs(y) for x, y in
                     zip(b["losses"], ref))
        c_diff = max(abs(x - y) / abs(y) for x, y in
                     zip(c["losses"], ref[em:]))
        bitwise = b["losses"] == ref[:len(b["losses"])]
        if bitwise:
            ok = c["losses"] == ref[em:]
            bound = "bitwise"
        else:
            # A step that is not deterministic on the card: C may differ
            # from A by what two runs of the same steps differ by (B vs A),
            # grown by the steps after the restore, at most 2x.
            bound = 2 * b_diff
            ok = c_diff <= bound
        if not ok:
            raise AssertionError(
                f"arm C's losses after the restore vs A's (bound {bound}): "
                f"{c['losses']} vs {ref[em:]}; B vs A {b_diff}")

        rebuilt = sorted(p.name for p in _kernels.BUILD_DIR.glob("*.so"))
        if rebuilt != built:
            raise AssertionError(f"the arms rebuilt kernels: {built} -> "
                                 f"{rebuilt}")
    finally:
        side.shutdown()
        shutil.rmtree(DURABLE_DIR, ignore_errors=True)

    # What it prints: the saves and restores, split; the emergency
    # latency; the prefetch wait; the ledgers; A's rate. Every time is
    # taken beside the arm that shares the card (DURABLE_BESIDE).
    gb = 1e9
    for arm in ("B", "C"):
        for s in arms[arm]["report"]["checkpoints"]:
            print(f"train: durability: arm {arm} ({DURABLE_BESIDE[arm]}) "
                  f"{s['kind']} save of step "
                  f"{s['step']}: {s['bytes'] / gb:.3f} GB; pin "
                  f"{s['pin_s']:.3f} s, wait for the staging "
                  f"{s['stage_wait_s']:.3f} s, device-to-host "
                  f"{s['d2h_s']:.3f} s ({s['bytes'] / gb / max(s['d2h_s'], 1e-9):.2f} "
                  f"GB/s), save() returned after {s['save_call_s']:.3f} s; "
                  f"write {s['write_s']:.3f} s "
                  f"({s['bytes'] / gb / max(s['write_s'], 1e-9):.3f} GB/s), "
                  f"sha256 {s['sha256_s']:.3f} s of hashing threads "
                  f"({s['bytes'] / gb / max(s['sha256_s'], 1e-9):.3f} GB/s), "
                  f"writer {s['writer_s']:.3f} s, committed after "
                  f"{s['commit_s']:.3f} s [{card}]", flush=True)
    for arm in ("C", "D"):
        r = arms[arm]["report"]["resumed"]
        print(f"train: durability: arm {arm} ({DURABLE_BESIDE[arm]}) "
              f"restore of step {r['step']}: "
              f"{r['bytes'] / gb:.3f} GB; verify (read + sha256) "
              f"{r['verify_s']:.3f} s "
              f"({r['bytes'] / gb / max(r['verify_s'], 1e-9):.3f} GB/s), "
              f"read {r['read_s']:.3f} s "
              f"({r['bytes'] / gb / max(r['read_s'], 1e-9):.3f} GB/s), "
              f"waits on host-to-device copies {r['h2d_wait_s']:.3f} s, "
              f"load {r['seconds']:.3f} s [{card}]", flush=True)
    print(f"train: durability: arm B ({DURABLE_BESIDE['B']}) SIGTERM after "
          f"step {DURABLE_KILL_AT} "
          f"logged -> emergency save of step {em} -> exit 75 in "
          f"{arms['B']['sigterm_to_exit_s']:.3f} s [{card}]", flush=True)
    waits = a["prefetch_wait_seconds"]
    per_window = [w1 - w0 for w0, w1 in zip([0.0] + waits[:-1], waits)]
    print(f"train: durability: arm A DevicePrefetch wait per window (s) "
          f"{[round(w, 6) for w in per_window]}", flush=True)
    for arm in ("B", "C"):
        ledger = arms[arm]["goodput"]
        print(f"train: durability: arm {arm} goodput "
              + ", ".join(f"{k} {v:.4f} s" for k, v in
                          sorted(ledger["seconds"].items()))
              + f" = wall {ledger['wall_s']:.4f} s (partition check "
              f"passed), useful share {ledger['useful_fraction']:.4f} "
              f"[{card}]", flush=True)
    step_s = [dt / n for n, dt in a["windows"]]
    steady = step_s[1:]
    tps = TRAIN_BATCH * TRAIN_SEQ * len(steady) / sum(steady)
    a_mfu = (tps * a["flops_per_token"] / (a["peak_bf16_tflops"] * 1e12)
             if a["peak_bf16_tflops"] else float("nan"))
    print(f"train: durability: arm A ({DURABLE_BESIDE['A']}; "
          f"{DURABLE_LAYERS} layers, prefetch "
          f"2, sync every {DURABLE_SYNC}) step ms by window "
          f"{[round(x * 1e3, 3) for x in step_s]}; steady "
          f"{statistics.median(steady) * 1e3:.3f} ms, {tps:.1f} tokens/s, "
          f"MFU {a_mfu:.4f}; memory_stats temp "
          f"{(a['memory'] or {}).get('temp_bytes', 0) / gb:.2f} GB, peak "
          f"{(a['memory'] or {}).get('peak_bytes', 0) / gb:.2f} GB "
          f"[{card}]", flush=True)
    print(f"train: durability: losses, B (before the kill) vs A: "
          f"{'bitwise' if bitwise else f'max rel diff {b_diff:.3g}'}; "
          f"C (after the restore of step {em}) vs A: "
          f"{'bitwise' if c['losses'] == ref[em:] else f'max rel diff {c_diff:.3g}'}"
          f" (bound {bound}); D quarantined {arms['D']['quarantined']} "
          f"(one byte of {arms['D']['torn_file']} flipped) and restored "
          f"the scheduled step {arms['D']['fell_back_to']}; arms took "
          + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in arms.items()),
          flush=True)
    return dict(checkpoint_bytes=ckpt_bytes, arms={
        k: {kk: vv for kk, vv in v.items()} for k, v in arms.items()},
        losses_bitwise=bitwise, b_vs_a_max_rel=b_diff,
        c_vs_a_max_rel=c_diff, bound=bound,
        prefetch_wait_per_window=per_window, a_steady_tokens_per_sec=tps,
        a_mfu=a_mfu, launches={k: {kk: arms[k]["report"]["kernel_launches"]
                                   [kk] for kk in per_step}
                               for k in ("A", "B", "C")}, beside=beside)


# Phase 6: distributed training on one card. Full width at phase 5's cut
# (llama3-8b, 4 layers, bf16 policy, full remat, batch 4 x 2048): GPipe
# with every stage on the card, the ring at n = 1 and the entry point
# under a one-rank NCCL world as subprocesses of the trainer, blockwise
# attention against the flash kernels, and the fused exchange against the
# sharded step. It writes no checkpoint.
DIST_DEVICE = "cuda"
DIST_STAGES, DIST_MICROBATCHES = 2, 4
DIST_TIMED_STEPS = 2
# The ring and the entry-point arms run the trainer this many steps of
# phase 5's: the learning rate of the updates before step 3 does not
# depend on the step count (warm-up 1), so their losses are phase 5's
# first three.
DIST_ARM_STEPS = 3
DIST_ARM_TIMEOUT_S = 300
BLOCKWISE_SHAPE = (1, 4096)
# Blockwise keeps p and dS in f32 where the flash kernels round them to
# bf16 (the reference's XLA twin keeps them in f32 too), so its gradients
# sit two roundings from the kernels'. The forward (out, lse) is held to
# phase 3's bounds as they are; dQ, dK and dV to twice phase 3's ATOL +
# RTOL |kernel|. blockwise_check prints what that bound sits between: the
# kernels' and blockwise's own errors against f32 dense attention (in
# units of the single bound), and a control the doubled bound must still
# refuse -- blockwise with its last key block's values zeroed.
BLOCKWISE_GRAD_FACTOR = 2
FUSED_STEPS = 2


def dist_config():
    from triton_kubernetes_tpu_torch.models import get_config
    from triton_kubernetes_tpu_torch.train import apply_policy

    return apply_policy(get_config(
        TRAIN_MODEL, num_layers=TRAIN_LAYERS, fused_ce=True,
        attention="flash", remat=True, remat_policy="full"), "bf16")


def gpipe_check(card):
    """GPipe (2 stages, 4 microbatches, every stage on the card) against
    the sequential step on the same weights and batch: loss and every
    gradient leaf within phase 5's kernels-vs-plain bounds, flash launches
    exact for the schedule, and both steps' times."""
    from triton_kubernetes_tpu_torch.models import llama
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa
    from triton_kubernetes_tpu_torch.train import (
        init_state, loss_fn, make_optimizer, synthetic_batches)

    cfg = dist_config()
    opt = make_optimizer(learning_rate=3e-4, warmup_steps=1,
                         decay_steps=TRAIN_STEPS)
    state = init_state(cfg, opt, seed=2, device=DIST_DEVICE)
    model = state.model
    params = list(model.parameters())
    tokens = torch.from_numpy(next(synthetic_batches(
        cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=98))["tokens"]).to(
        DIST_DEVICE)
    attn = llama.resolve_attention(cfg, DIST_DEVICE)

    def stages_of(pipelined):
        return ((DIST_STAGES, DIST_MICROBATCHES) if pipelined else (1, 1))

    def grads(pipelined):
        for p in params:
            p.grad = None
        fa.reset_launch_counts()
        total, metrics = loss_fn(model, tokens, cfg, attn,
                                 *stages_of(pipelined))
        total.backward()
        torch.cuda.synchronize()
        launches = dict(fa.flash_attention.launches)
        out = [p.grad for p in params]
        for p in params:
            p.grad = None
        return float(metrics["loss"]), out, launches

    seq_loss, seq_grads, seq_launches = grads(False)
    pipe_loss, pipe_grads, pipe_launches = grads(True)
    loss_rel = abs(pipe_loss - seq_loss) / abs(seq_loss)
    grad_rel = max(rel_l2(a, b) for a, b in zip(pipe_grads, seq_grads))
    del seq_grads, pipe_grads
    # The schedule runs each layer once a microbatch (bubbles skipped),
    # the forward twice under full remat.
    want = {k: n * TRAIN_LAYERS * DIST_MICROBATCHES
            for k, n in FLASH_PER_LAYER.items()}
    want_seq = {k: n * TRAIN_LAYERS for k, n in FLASH_PER_LAYER.items()}
    if pipe_launches != want or seq_launches != want_seq:
        raise AssertionError(f"flash launches: pipelined {pipe_launches} "
                             f"!= {want}, sequential {seq_launches} != "
                             f"{want_seq}")
    if not (loss_rel <= STEP_LOSS_REL and grad_rel <= STEP_GRAD_REL_L2):
        raise AssertionError(
            f"GPipe vs sequential: loss rel diff {loss_rel} (bound "
            f"{STEP_LOSS_REL}), worst gradient leaf rel L2 {grad_rel} "
            f"(bound {STEP_GRAD_REL_L2})")

    def step(pipelined):
        for p in params:
            p.grad = None
        total, _ = loss_fn(model, tokens, cfg, attn, *stages_of(pipelined))
        total.backward()
        opt.update(params, [p.grad for p in params], state.opt_state)

    times = {}
    for pipelined in (False, True):
        step(pipelined)  # warm-up
        torch.cuda.synchronize()
        ms = []
        for _ in range(DIST_TIMED_STEPS):
            t0 = time.perf_counter()
            step(pipelined)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        times["pipelined" if pipelined else "sequential"] = ms
    for p in params:
        p.grad = None
    del state, model, params
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(loss_sequential=seq_loss, loss_pipelined=pipe_loss,
               loss_rel_diff=loss_rel, grad_max_rel_l2=grad_rel,
               launches=pipe_launches, launches_sequential=seq_launches,
               step_ms=times,
               step_ms_median={k: statistics.median(v)
                               for k, v in times.items()})
    print(f"distributed: GPipe (stages {DIST_STAGES}, microbatches "
          f"{DIST_MICROBATCHES}, all on the card) vs the sequential step: "
          f"loss {pipe_loss:.6f} vs {seq_loss:.6f} (rel diff "
          f"{loss_rel:.3g}, bound {STEP_LOSS_REL}), worst gradient leaf "
          f"rel L2 {grad_rel:.4g} (bound {STEP_GRAD_REL_L2}); flash "
          f"launches a pipelined step {pipe_launches} (sequential "
          f"{seq_launches}); step ms pipelined "
          f"{[round(x, 3) for x in times['pipelined']]} vs sequential "
          f"{[round(x, 3) for x in times['sequential']]} [{card}]",
          flush=True)
    return out


def blockwise_check(card, flush):
    """Blockwise attention against the flash kernels at (1, 4096), 8B
    heads, bf16: forward and backward, with both times."""
    from triton_kubernetes_tpu_torch.ops import blockwise_attention as bw
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa

    b, s = BLOCKWISE_SHAPE
    gen = torch.Generator(device=DIST_DEVICE).manual_seed(6)
    q, k, v, do = (torch.randn((b, s, h, D), generator=gen, device=DIST_DEVICE
                               ).to(torch.bfloat16)
                   for h in (HQ, HKV, HKV, HQ))

    from triton_kubernetes_tpu_torch.ops.attention import causal_attention

    def run(fn, inputs=(q, k, v), grad_out=do):
        ts = [t.detach().requires_grad_(True) for t in inputs]
        o = fn(*ts)
        o.backward(grad_out)
        return [o.detach()] + [t.grad for t in ts]

    names = ("out", "dq", "dk", "dv")
    factors = (1,) + (BLOCKWISE_GRAD_FACTOR,) * 3

    def ratios(got, want, units):
        """max |got - want| / (unit x (ATOL + RTOL |want|)) of each."""
        return {n: float(((a.float() - w.float()).abs()
                          / (u * (ATOL + RTOL * w.float().abs()))).max())
                for n, a, w, u in zip(names, got, want, units)}

    got = run(bw.blockwise_attention)
    want = run(fa.flash_attention)
    errs = {}
    for name, a, w, factor in zip(names, got, want, factors):
        err = (a.float() - w.float()).abs()
        ratio = float((err / (factor * (ATOL + RTOL * w.float().abs())))
                      .max())
        errs[name] = dict(max_abs_err=float(err.max()), bound_ratio=ratio)
        if not ratio <= 1:
            raise AssertionError(
                f"blockwise {name} vs the flash kernels: {ratio:.4g} of "
                f"{factor} x (ATOL + RTOL |kernel|)")
    # What the doubled bound sits between, in units of the single bound:
    # each against f32 dense attention on the same (bf16-valued) inputs.
    pos = torch.arange(s, device=DIST_DEVICE).expand(b, s)
    truth = run(lambda q_, k_, v_: causal_attention(q_, k_, v_, pos, pos),
                [t.float() for t in (q, k, v)], do.float())
    del pos
    spread = dict(kernels_vs_blockwise=ratios(want, got, (1,) * 4),
                  kernels_vs_f32=ratios(want, truth, (1,) * 4),
                  blockwise_vs_f32=ratios(got, truth, (1,) * 4))
    del truth
    # The control: the last key block's values zeroed, which the bound
    # (as the check above applies it) must refuse.
    v_drop = v.clone()
    v_drop[:, -bw.DEFAULT_BLOCK_K:] = 0
    control = ratios(run(bw.blockwise_attention, (q, k, v_drop)), want,
                     factors)
    del v_drop
    if not max(control.values()) > 1:
        raise AssertionError(f"blockwise control (last key block's values "
                             f"zeroed) passes the bound: {control}")
    spread["control_dropped_block"] = control
    # How fine the bound is: a softmax scale 2^-6 off (q scaled),
    # reported only.
    spread["control_scale_off_2^-6"] = ratios(
        run(bw.blockwise_attention, ((q.float() * (1 + 2.0 ** -6)).to(
            q.dtype), k, v)), want, factors)
    _, lse = bw._forward(q, k, v, None, bw.DEFAULT_BLOCK_K)
    from triton_kubernetes_tpu_torch.ops import _kernels

    _, klse = _kernels.flash_fwd(q, k, v)
    lse_err = float((lse.reshape(klse.shape) - klse).abs().max())
    if not lse_err <= LSE_ATOL:
        raise AssertionError(f"blockwise lse vs flash_fwd: {lse_err} > "
                             f"{LSE_ATOL}")
    errs["lse"] = dict(max_abs_err=lse_err)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))

    def fwd_bwd(fn):
        def go():
            o = fn(qs, ks, vs)
            torch.autograd.grad(o, (qs, ks, vs), do)
        return go

    with torch.no_grad():
        times = dict(
            blockwise_fwd=time_ms(lambda: bw.blockwise_attention(q, k, v),
                                  flush, runs=5, warmup=1),
            flash_fwd=time_ms(lambda: fa.flash_attention(q, k, v), flush,
                              runs=5, warmup=1))
    times["blockwise_fwd_bwd"] = time_ms(fwd_bwd(bw.blockwise_attention),
                                         flush, runs=5, warmup=1)
    times["flash_fwd_bwd"] = time_ms(fwd_bwd(fa.flash_attention), flush,
                                     runs=5, warmup=1)
    del got, want, q, k, v, do, qs, ks, vs
    torch.cuda.empty_cache()
    print(f"distributed: blockwise attention (B, S) = {BLOCKWISE_SHAPE}, "
          f"Hq {HQ}, Hkv {HKV}, D {D}, bf16, block {bw.DEFAULT_BLOCK_K} vs "
          f"the flash kernels: "
          + ", ".join(f"{n} max abs err {e['max_abs_err']:.4g}"
                      + (f" ({e['bound_ratio']:.3f} of its bound)"
                         if "bound_ratio" in e else "")
                      for n, e in errs.items())
          + f"; forward ms blockwise {times['blockwise_fwd']:.4f} vs flash "
          f"{times['flash_fwd']:.4f}, forward + backward ms blockwise "
          f"{times['blockwise_fwd_bwd']:.4f} vs flash "
          f"{times['flash_fwd_bwd']:.4f} [{card}]", flush=True)
    print("distributed: blockwise bound spread (out, dq, dk, dv; the "
          "controls in units of the bound as applied, the rest of the "
          "single bound): " + "; ".join(
              f"{k} " + ", ".join(f"{r:.4g}" for r in v.values())
              for k, v in spread.items()), flush=True)
    return dict(errors=errs, ms=times, bound_spread=spread)


def train_arm(name, argv, out_dir, env=None):
    """The trainer entry point as a subprocess (phase 5's flags plus
    ``argv``): its report, its log tail."""
    import os

    report = out_dir / f"train_dist_{name}.json"
    report.unlink(missing_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", "triton_kubernetes_tpu_torch.train",
         *TRAIN_ARGV, "--report-json", str(report), *argv],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=DIST_ARM_TIMEOUT_S, env=dict(os.environ, **(env or {})))
    if proc.returncode != 0 or not report.exists():
        raise AssertionError(f"trainer arm {name}: exit {proc.returncode}; "
                             f"stderr tail:\n{proc.stderr[-3000:]}")
    return json.loads(report.read_text()), proc.stderr


def steady_ms(rep):
    step_s = [dt / n for n, dt in rep["windows"]]
    return statistics.median(step_s[TRAIN_WARMUP:]) * 1e3


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def fused_check(card):
    """``make_fused_dcn_step`` against the sharded (XLA-path) step on a
    one-rank mesh, FUSED_STEPS steps from the same init: losses, grad
    norms and every parameter bitwise."""
    from triton_kubernetes_tpu_torch.parallel import MeshConfig, create_mesh
    from triton_kubernetes_tpu_torch.parallel.multihost import \
        make_fused_dcn_step
    from triton_kubernetes_tpu_torch.train import (
        init_state, make_optimizer, make_train_step, synthetic_batches)

    cfg = dist_config()
    mesh = create_mesh(MeshConfig(fsdp=1), world=1, device_type=DIST_DEVICE)
    runs = {}
    for name in ("fused", "xla"):
        opt = make_optimizer(learning_rate=3e-4, warmup_steps=1,
                             decay_steps=TRAIN_STEPS)
        if name == "fused":
            state = init_state(cfg, opt, seed=3, device=DIST_DEVICE)
            step = make_fused_dcn_step(cfg, mesh, opt)
        else:
            state = init_state(cfg, opt, seed=3, device=DIST_DEVICE, mesh=mesh)
            step = make_train_step(cfg, opt, mesh=mesh)
        metrics = []
        batches = synthetic_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                    seed=97)
        for _ in range(FUSED_STEPS):
            state, m = step(state, next(batches))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[name] = (metrics, [p.detach().cpu()
                                for p in state.model.parameters()])
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    (fm, fp), (xm, xp) = runs["fused"], runs["xla"]
    same = sum(torch.equal(a, b) for a, b in zip(fp, xp))
    if fm != xm or same != len(fp):
        raise AssertionError(f"fused vs sharded step: metrics {fm} vs {xm},"
                             f" {same}/{len(fp)} leaves bitwise")
    print(f"distributed: fused exchange vs the sharded step, {FUSED_STEPS} "
          f"steps on a one-rank mesh: (loss, grad norm) {fm} both, "
          f"{same}/{len(fp)} parameters bitwise [{card}]", flush=True)
    return dict(metrics=fm, leaves_bitwise=same, leaves=len(fp))


def distributed_phase(card, out_dir: Path, flash_report=None, fused=True):
    """Phase 6. ``flash_report`` is phase 5's run report (the flash
    baseline); without it the phase runs phase 5's trainer itself. With
    ``fused`` False the fused exchange's check is left to the caller
    (:func:`fused_check`: two full 4-layer states, ~53 GB, which do not
    fit beside a durability arm)."""
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa
    from triton_kubernetes_tpu_torch.train import __main__ as train_main

    t0 = time.perf_counter()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=DIST_DEVICE)
    if flash_report is None:
        path = out_dir / "train_dist_flash.json"
        fa.reset_launch_counts()
        if train_main.main(TRAIN_ARGV + ["--report-json", str(path)]) != 0:
            raise AssertionError("phase 5's trainer run failed")
        flash_report = json.loads(path.read_text())
        gc.collect()
        torch.cuda.empty_cache()
    out = dict(flash_losses=flash_report["losses"],
               flash_steady_ms=steady_ms(flash_report))
    out["blockwise"] = blockwise_check(card, flush)
    del flush
    # The main path: GPipe in this process, counted from zero.
    fa.reset_launch_counts()
    out["gpipe"] = gpipe_check(card)
    launches = dict(out["gpipe"]["launches"])

    # The ring at n = 1 through the entry point.
    arm_steps = ["--steps", str(DIST_ARM_STEPS)]
    ring, _ = train_arm("ring", ["--ring-attention", *arm_steps], out_dir)
    ring_rel = max(abs(a - b) / abs(b) for a, b in zip(
        ring["losses"], flash_report["losses"]))
    if (len(ring["losses"]) != DIST_ARM_STEPS
            or not all(np.isfinite(ring["losses"] + ring["grad_norms"]))
            or not ring_rel <= STEP_LOSS_REL):
        raise AssertionError(f"ring at n = 1: losses {ring['losses']} vs "
                             f"flash {flash_report['losses']} (worst rel "
                             f"diff {ring_rel}, bound {STEP_LOSS_REL})")
    if any(ring["kernel_launches"].values()):
        raise AssertionError(f"ring run launched flash kernels: "
                             f"{ring['kernel_launches']}")
    out["ring"] = dict(losses=ring["losses"], max_loss_rel_diff=ring_rel,
                       steady_ms=steady_ms(ring), report=ring)
    print(f"distributed: ring attention at n = 1 (--ring-attention, "
          f"{DIST_ARM_STEPS} steps): losses {[round(x, 5) for x in ring['losses']]}"
          f", worst rel diff to the flash run {ring_rel:.3g} (bound "
          f"{STEP_LOSS_REL}); steady step ms ring {steady_ms(ring):.3f} vs "
          f"flash {out['flash_steady_ms']:.3f} [{card}]", flush=True)

    # The entry point under a one-rank NCCL world: bitwise phase 5.
    env = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
           "NUM_TPU_WORKERS": "1", "TPU_WORKER_ID": "0"}
    entry, log = train_arm("entry", ["--distributed", "on", *arm_steps],
                           out_dir, env)
    from triton_kubernetes_tpu_torch.parallel.multihost import backend_for

    if f"backend={backend_for(DIST_DEVICE)}" not in log:
        raise AssertionError(f"the entry point joined no "
                             f"{backend_for(DIST_DEVICE)} world:\n"
                             f"{log[-2000:]}")
    same = (entry["losses"] == flash_report["losses"][:DIST_ARM_STEPS]
            and entry["grad_norms"]
            == flash_report["grad_norms"][:DIST_ARM_STEPS])
    want = {k: n * TRAIN_LAYERS * DIST_ARM_STEPS
            for k, n in FLASH_PER_LAYER.items()}
    if not same or entry["kernel_launches"] != want:
        raise AssertionError(
            f"--distributed on (NCCL, world 1): losses {entry['losses']} "
            f"vs phase 5's {flash_report['losses']}, grad norms "
            f"{entry['grad_norms']} vs {flash_report['grad_norms']}; "
            f"launches {entry['kernel_launches']} (want {want})")
    for k, n in entry["kernel_launches"].items():
        launches[k] = launches.get(k, 0) + n
    out["entry"] = dict(mesh=entry["mesh"], dcn_sync=entry["dcn_sync"],
                        n_processes=entry["n_processes"],
                        losses_bitwise=same, steady_ms=steady_ms(entry),
                        launches=entry["kernel_launches"], report=entry)
    print(f"distributed: --distributed on under NCCL, world 1 "
          f"({DIST_ARM_STEPS} steps): report mesh {entry['mesh']}, dcn_sync "
          f"{entry['dcn_sync']}, n_processes {entry['n_processes']}; "
          f"losses and grad norms bitwise phase 5's: {same}; steady step ms "
          f"{steady_ms(entry):.3f} vs {out['flash_steady_ms']:.3f}; flash "
          f"launches {entry['kernel_launches']} [{card}]", flush=True)

    if fused:
        out["fused"] = fused_check(card)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print(f"distributed: phase 6 took {out['seconds']:.1f} s", flush=True)
    return out



# Phase 7: expert parallelism on one card. Mixtral-8x7B at full width, cut
# to EXPERT_LAYERS layers (a rank of expert 2 holds 1.75B parameters:
# 28 GB of f32 masters, gradients and moments; two ranks 56 GB, the
# expert-1 run alone 50.6 GB, each before activations), batch 1 x 2048,
# bf16 policy, full remat, fused CE, flash; capacity factor 1.25 (the
# model's), so tokens drop. NCCL refuses two ranks on one device, so the
# world is gloo over two processes on cuda:0 (the port's API, as the CPU
# tests' workers join theirs); the expert layer needs only all_reduce
# (and, under batch-split axes, all_gather) on CUDA tensors, which the
# workers probe first. No checkpoint is written: elastic restart and the
# goodput harness are checked in gloo worlds on the CPU.
EXPERT_DEVICE = "cuda"
EXPERT_DEGREE = 2
EXPERT_LAYERS = 2
EXPERT_SEED = 11
EXPERT_STEPS = 3  # the first held to the expert-1 step, the rest timed
EXPERT_WORLD_TIMEOUT_S = 600
# The first step's loss against the expert-1 step's: bitwise, or within
# this relative bound (the experts' batched products run on E / expert
# experts, which cuBLAS may tile otherwise).
EXPERT_LOSS_REL = 1e-6


def expert_config():
    from triton_kubernetes_tpu_torch.models import get_config
    from triton_kubernetes_tpu_torch.train import apply_policy

    return apply_policy(get_config(
        MIXTRAL_MODEL, num_layers=EXPERT_LAYERS, fused_ce=True,
        attention="flash", remat=True, remat_policy="full"), "bf16")


def expert_batch():
    """Phase 7's batch, on the host (the step stages it)."""
    from triton_kubernetes_tpu_torch.train import synthetic_batches

    return next(synthetic_batches(expert_config().vocab_size, 1, TRAIN_SEQ,
                                  seed=98))


def expert_leaves(rank, held):
    """(name, index) of the gradient leaves phase 7 compares on ``rank``:
    both routers, layer 0's wq, and layer 0's w1 and w2 of the rank's first
    expert (global index ``rank * held``)."""
    out = [(f"layers.{i}.router", None) for i in range(EXPERT_LAYERS)]
    out.append(("layers.0.wq", None))
    out += [(f"layers.0.{w}", rank * held) for w in ("moe_w1", "moe_w2")]
    return out


def expert_reference(card, out_dir: Path):
    """The expert-1 step on one device, in this process: its loss, its
    expert choices (recorded), flash launches, and the compared gradient
    leaves, saved to ``out_dir`` for the world's ranks; then freed."""
    from triton_kubernetes_tpu_torch.models import llama
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa
    from triton_kubernetes_tpu_torch.train import (make_optimizer,
                                                   make_train_step,
                                                   state_for)

    cfg = expert_config()
    torch.cuda.reset_peak_memory_stats()
    model = llama.init_params(cfg, seed=EXPERT_SEED, device=EXPERT_DEVICE,
                              trainable=True)
    opt = make_optimizer(learning_rate=3e-4, warmup_steps=1,
                         decay_steps=EXPERT_STEPS)
    state = state_for(model, opt)
    step = make_train_step(cfg, opt)
    batch = expert_batch()
    choices = []
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with routing("record", choices):
        state, m = step(state, batch)
    loss = float(m["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fa.flash_attention.launches)
    held = cfg.num_experts // EXPERT_DEGREE
    grads = {}
    for rank in range(EXPERT_DEGREE):
        for name, e in expert_leaves(rank, held):
            g = model.get_parameter(name).grad
            grads[(name, e)] = (g if e is None else g[e]).detach().cpu()
    saved = dict(loss=loss, aux=float(m["aux_loss"]),
                 choices=[c.cpu() for c in choices], grads=grads)
    step_ms = []
    for _ in range(EXPERT_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    del state, model, step, m, grads
    gc.collect()
    torch.cuda.empty_cache()
    # Written once the card is free: the ranks build their blocks on it.
    save_reference(saved, out_dir / "expert_reference.pt")
    want = {k: n * EXPERT_LAYERS for k, n in FLASH_PER_LAYER.items()}
    if launches != want:
        raise AssertionError(f"expert 1 step: flash launches {launches} "
                             f"!= {want}")
    print(f"expert: {MIXTRAL_MODEL} cut to {EXPERT_LAYERS} layers, expert 1 "
          f"on one device, B 1 x {TRAIN_SEQ}: first step loss {loss!r}, "
          f"{ms:.1f} ms (the first step of the process), then step ms "
          f"{[round(x, 1) for x in step_ms]}; peak memory "
          f"{peak / 1e9:.2f} GB, flash launches {launches} [{card}]",
          flush=True)
    return dict(loss=loss, first_step_ms=ms, step_ms=step_ms,
                peak_memory_bytes=peak, launches=launches)


def expert_worker(rank: int, port: int, out_dir: Path) -> None:
    """One rank of phase 7's world (``chip_smoke.py --expert-worker RANK
    PORT DIR``): gloo over ``EXPERT_DEGREE`` processes, every one on
    cuda:0. Probes gloo's all_reduce and all_gather on CUDA tensors, builds
    its blocks of the expert-1 model (the same seed: the same values),
    routes the first step on the recorded expert choices and holds its
    loss and gradients to the expert-1 step's, counts how many choices
    move when it routes for itself, then times the remaining steps.
    Writes ``expert_rank{RANK}.json``."""
    import torch.distributed as dist

    from triton_kubernetes_tpu_torch.models import llama
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa
    from triton_kubernetes_tpu_torch.parallel import MeshConfig, create_mesh
    from triton_kubernetes_tpu_torch.parallel.multihost import \
        make_batch_placer
    from triton_kubernetes_tpu_torch.train import (loss_fn, make_optimizer,
                                                   make_train_step,
                                                   state_for)

    if EXPERT_DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=EXPERT_DEGREE)
    try:
        # Gloo on CUDA tensors: refused means the phase fails.
        x = torch.full((4,), float(rank + 1), device=EXPERT_DEVICE)
        dist.all_reduce(x)
        gathered = torch.empty(4 * EXPERT_DEGREE, device=EXPERT_DEVICE)
        dist.all_gather_into_tensor(gathered, torch.full(
            (4,), float(rank), device=EXPERT_DEVICE))
        want_sum = EXPERT_DEGREE * (EXPERT_DEGREE + 1) / 2
        probe = bool(torch.all(x == want_sum)) and gathered.tolist() == [
            float(r) for r in range(EXPERT_DEGREE) for _ in range(4)]
        if not probe:
            raise AssertionError(f"gloo on CUDA tensors: all_reduce "
                                 f"{x.tolist()}, all_gather "
                                 f"{gathered.tolist()}")
        ref = await_reference(out_dir / "expert_reference.pt")
        cfg = expert_config()
        mesh = create_mesh(MeshConfig(expert=EXPERT_DEGREE, fsdp=1),
                           device_type=EXPERT_DEVICE)
        torch.cuda.reset_peak_memory_stats()
        model = llama.init_params(cfg, seed=EXPERT_SEED, device=EXPERT_DEVICE,
                                  trainable=True, mesh=mesh)
        held = model.layers[0].moe_w1.shape[0]
        opt = make_optimizer(learning_rate=3e-4, warmup_steps=1,
                             decay_steps=EXPERT_STEPS)
        state = state_for(model, opt)
        step = make_train_step(cfg, opt, mesh=mesh)
        batch = make_batch_placer(mesh)(expert_batch())
        choices = [c.to(EXPERT_DEVICE) for c in ref["choices"]]
        # Routing for itself, forward only: the choices that move.
        own = []
        with torch.no_grad(), routing("record", own):
            _, own_m = loss_fn(model, torch.as_tensor(
                batch["tokens"], device=EXPERT_DEVICE), cfg,
                step.attention_fn)
        moved = sum(int((a != b).any(dim=1).sum())
                    for a, b in zip(choices, own))
        # The compared step, on the expert-1 run's choices, counted from 0.
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with routing("replay", choices):
            state, m = step(state, batch)
        loss = float(m["loss"])
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(fa.flash_attention.launches)
        grads = {}
        for name, e in expert_leaves(rank, held):
            g = model.get_parameter(name).grad
            got = g if e is None else g[e - rank * held]
            want = ref["grads"][(name, e)].to(EXPERT_DEVICE)
            grads[f"{name}[{e}]" if e is not None else name] = dict(
                rel_l2=rel_l2(got, want),
                max_abs=float((got.float() - want.float()).abs().max()),
                bitwise=bool(torch.equal(got, want)))
        step_ms = []
        for _ in range(EXPERT_STEPS - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m2 = step(state, batch)
            float(m2["loss"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
        out = dict(rank=rank, held=held, gloo_cuda_probe=probe,
                   loss=loss, aux=float(m["aux_loss"]),
                   loss_bitwise=loss == ref["loss"],
                   loss_rel_diff=abs(loss - ref["loss"]) / abs(ref["loss"]),
                   own_routing_loss=float(own_m["loss"]),
                   own_routing_moved=moved, routing_calls=len(own),
                   grads=grads, first_step_ms=first_ms, step_ms=step_ms,
                   later_losses=[float(m2["loss"])],
                   launches=launches,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   mesh=repr(mesh.shape))
        (out_dir / f"expert_rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def expert_phase(card, out_dir: Path):
    """Phase 7: the expert-1 step in this process, then a gloo world of
    ``EXPERT_DEGREE`` ranks on cuda:0 at ``--expert`` EXPERT_DEGREE (the
    experts split over the mesh's expert axis), each rank held to it.
    The reference gradients and the ranks' records pass through a
    temporary directory (they are large); the ranks' records are copied
    to ``out_dir``. Returns (flash launches summed over the ranks'
    compared steps, the record)."""
    with tempfile.TemporaryDirectory() as tmp:
        launches, out = _expert_phase(card, Path(tmp))
        names = [f"expert_rank{r}.json" for r in range(EXPERT_DEGREE)] + [
            f"gpipe_moe_rank{r}.json" for r in range(GPIPE_MOE_RANKS)]
        for name in names:
            (out_dir / name).write_text((Path(tmp) / name).read_text())
    return launches, out


def _expert_phase(card, out_dir: Path):
    t0 = time.perf_counter()
    ref = run_world("--expert-worker", EXPERT_DEGREE, out_dir, "expert",
                    lambda: expert_reference(card, out_dir))
    ranks = [json.loads((out_dir / f"expert_rank{r}.json").read_text())
             for r in range(EXPERT_DEGREE)]
    want = {k: n * EXPERT_LAYERS for k, n in FLASH_PER_LAYER.items()}
    cfg = expert_config()
    for r in ranks:
        grad_rel = max(g["rel_l2"] for g in r["grads"].values())
        problems = []
        if r["held"] != cfg.num_experts // EXPERT_DEGREE:
            problems.append(f"holds {r['held']} experts")
        if not (r["loss_bitwise"] or r["loss_rel_diff"] <= EXPERT_LOSS_REL):
            problems.append(f"loss {r['loss']!r} vs {ref['loss']!r}")
        if not grad_rel <= STEP_GRAD_REL_L2:
            problems.append(f"worst gradient rel L2 {grad_rel}")
        if r["launches"] != want:
            problems.append(f"flash launches {r['launches']} != {want}")
        if not all(np.isfinite([r["loss"], r["aux"]] + r["later_losses"])):
            problems.append("non-finite loss")
        if problems:
            raise AssertionError(f"expert rank {r['rank']}: "
                                 + "; ".join(problems))
        print(f"expert: rank {r['rank']} of {EXPERT_DEGREE} (gloo on cuda:0, "
              f"mesh {r['mesh']}, experts {r['rank'] * r['held']}.."
              f"{(r['rank'] + 1) * r['held'] - 1}): first step loss "
              f"{r['loss']!r} vs expert 1 {ref['loss']!r}: "
              f"{'bitwise' if r['loss_bitwise'] else 'rel diff %.3g (bound %g)' % (r['loss_rel_diff'], EXPERT_LOSS_REL)}"
              f"; gradients on the replayed choices (rel L2, bound "
              f"{STEP_GRAD_REL_L2}; bitwise): "
              f"{ {k: (round(g['rel_l2'], 9), g['bitwise']) for k, g in r['grads'].items()} }"
              f"; routing for itself moves {r['own_routing_moved']} token "
              f"choices of the forward's {r['routing_calls']} routing calls "
              f"(loss "
              f"{r['own_routing_loss']!r}); flash launches {r['launches']}; "
              f"step ms {[round(x, 1) for x in r['step_ms']]} (both ranks "
              f"share the card), first step {r['first_step_ms']:.1f} ms; "
              f"peak memory {r['peak_memory_bytes'] / 1e9:.2f} GB [{card}]",
              flush=True)
    launches = {k: sum(r["launches"][k] for r in ranks) for k in want}
    print(f"expert: the expert-2 world took {time.perf_counter() - t0:.1f} "
          f"s [{card}]", flush=True)
    gpipe_launches, gpipe = gpipe_moe_world(card, out_dir)
    seconds = time.perf_counter() - t0
    print(f"expert: phase 7 took {seconds:.1f} s [{card}]", flush=True)
    return ({k: n + gpipe_launches[k] for k, n in launches.items()},
            dict(reference=ref, ranks=ranks, launches=launches,
                 gpipe_moe=gpipe, seconds=seconds))


# Phase 7, second world: an MoE model under GPipe with its rows split,
# ``stage`` 2 x ``data`` 2 in a gloo world of four processes on cuda:0.
# Mixtral-8x7B at full width cut to 2 layers, one a stage, B 4 x 512
# tokens, 2 microbatches (each rank holds one row of each: its share of the
# global microbatch, as the batch placer gives it), capacity factor 1.25
# (the model's: tokens drop), flash attention, bf16 policy, full remat.
# The bytes: a stage holds ~1.58B parameters (one layer of 1.45B and the
# embedding or the head): 6.3 GB of f32 masters and as much of
# gradients; a rank peaks at 17.6-18.1 GB with the backward's transients
# (the one-process run of both stages at 29.8 GB; H100 80GB HBM3, 700 W,
# PERF.md); AdamW's moments would
# add 12.6 GB a rank, past 80 GB for four, so the world is held to the
# one-process GPipe run on its first forward and backward, as the
# expert-2 world's first step is, with no update. Rows split over
# ``fsdp`` instead would gather each rank's half of the f32 layer in
# every forward, recompute and backward, ~34 GB a rank through gloo's
# host path: 99.7 s for one forward and backward (H100 80GB HBM3, 700 W;
# PERF.md), past the script's budget; the CPU tests hold stage x fsdp to
# the JAX package. The shift along ``stage`` is ``collectives.ppermute``:
# gloo's send and receive do not take CUDA tensors
# (``scripts/gloo_cuda_probe.py``), so over gloo it goes through the host
# (``collectives._through_host``); every compute stays on the card.
GPIPE_MOE_MESH = dict(stage=2, data=2)
GPIPE_MOE_RANKS = 4
GPIPE_MOE_BATCH, GPIPE_MOE_SEQ = 4, 512
GPIPE_MOE_MICRO = 2
# The rows a microbatch splits over (data x fsdp), data-major.
GPIPE_MOE_ROW_AXES = ("data", "fsdp")
# A rank's loss against the one-process run's: phase 5's bound of two
# valid paths. Unlike the expert-2 world's ranks, which run the expert-1
# step's rows, a rank here runs half of each microbatch's rows through
# every bf16 product (cuBLAS picks its kernel by the row count), so its
# activations and logits are not bitwise the one-process run's; measured
# 5.6e-6 relative on rank 0 (H100 80GB HBM3, 700 W; PERF.md). The aux
# loss (f32 router probabilities over the same choices) keeps
# EXPERT_LOSS_REL.
GPIPE_MOE_LOSS_REL = STEP_LOSS_REL


def gpipe_moe_batch():
    """The four-rank world's global batch, on the host."""
    from triton_kubernetes_tpu_torch.train import synthetic_batches

    return next(synthetic_batches(expert_config().vocab_size,
                                  GPIPE_MOE_BATCH, GPIPE_MOE_SEQ, seed=99))


def gpipe_moe_leaves(stage):
    """(global name, expert index) of the gradient leaves held to the
    one-process run on a rank of ``stage``: its layer's router and wq,
    and the first expert's w1 and w2 (every rank holds all eight
    experts)."""
    return [(f"layers.{stage}.router", None), (f"layers.{stage}.wq", None),
            (f"layers.{stage}.moe_w1", 0), (f"layers.{stage}.moe_w2", 0)]


@contextlib.contextmanager
def routing_by_probs(mode, log, share=(1, 0)):
    """Record every ``ops.moe._top_k`` call's probabilities and choices
    into ``log`` ("record"), or replay them by content ("replay"): a call
    takes the choices of the recorded call whose probabilities, cut to this
    rank's share of the tokens (``share``: the row shards and this rank's
    index among them; a rank's microbatch rows are its share of the global
    one, data-major), lie closest to its own. Under GPipe a rank makes its
    calls in another order than one process does, and remat repeats them,
    so order cannot pair them. Yields a one-item list: the largest
    distance of a replayed pairing."""
    from triton_kubernetes_tpu_torch.ops import moe

    real = moe._top_k
    n, r = share
    worst = [0.0]

    def top_k(probs, k):
        if mode == "record":
            vals, idx = real(probs, k)
            log.append((probs.detach().clone(), idx))
            return vals, idx
        best = None
        for p_full, i_full in log:
            p = p_full.reshape(n, -1, p_full.shape[-1])[r]
            if p.shape != probs.shape:
                continue
            d = float((p - probs.detach()).abs().max())
            if best is None or d < best[0]:
                best = (d, i_full.reshape(n, -1, k)[r])
        worst[0] = max(worst[0], best[0])
        return probs.gather(-1, best[1]), best[1]

    moe._top_k = top_k
    try:
        yield worst
    finally:
        moe._top_k = real


@contextlib.contextmanager
def counting_drops(cls, cfg, counts):
    """Each seating by ``cls`` (``ops.moe.Routing`` on one device,
    ``parallel.placement.MeshRouting`` on a mesh) appends how many of its
    assignments sit at or past the capacity: the dropped ones."""
    from triton_kubernetes_tpu_torch.ops import moe

    real = cls.positions

    def positions(self, top_i):
        pos = real(self, top_i)
        b, s, k = top_i.shape
        cap = moe._capacity(cfg.capacity_factor, k, self.tokens(b * s),
                            cfg.num_experts)
        counts.append(int((pos >= cap).sum()))
        return pos

    cls.positions = positions
    try:
        yield counts
    finally:
        cls.positions = real


def gpipe_moe_reference(card, out_dir: Path):
    """The one-process GPipe run (no mesh, every stage here, the same
    microbatches, seed and batch): its first forward and backward's loss,
    aux loss, dropped assignments, routing calls (recorded) and the
    compared gradient leaves, saved to ``out_dir`` for the world's ranks;
    then freed."""
    from triton_kubernetes_tpu_torch.models import llama
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa
    from triton_kubernetes_tpu_torch.ops import moe
    from triton_kubernetes_tpu_torch.train import loss_fn

    cfg = expert_config()
    stages = GPIPE_MOE_MESH["stage"]
    torch.cuda.reset_peak_memory_stats()
    model = llama.init_params(cfg, seed=EXPERT_SEED, device=EXPERT_DEVICE,
                              trainable=True)
    tokens = torch.as_tensor(gpipe_moe_batch()["tokens"],
                             device=EXPERT_DEVICE)
    attn = llama.resolve_attention(cfg, model.device)
    calls, drops = [], []
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with routing_by_probs("record", calls), \
            counting_drops(moe.Routing, cfg, drops):
        total, m = loss_fn(model, tokens, cfg, attn, stages, GPIPE_MOE_MICRO)
        total.backward()
    loss, aux = float(m["loss"]), float(m["aux_loss"])
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fa.flash_attention.launches)
    # The forward's seatings: a layer a microbatch (remat repeats them).
    dropped = sum(drops[:GPIPE_MOE_MICRO * cfg.num_layers])
    grads = {}
    for s in range(stages):
        for name, e in gpipe_moe_leaves(s):
            g = model.get_parameter(name).grad
            grads[name] = (g if e is None else g[e:e + 1]).detach().cpu()
    saved = dict(loss=loss, aux=aux, dropped=dropped,
                 calls=[(p.cpu(), i.cpu()) for p, i in calls], grads=grads)
    peak = torch.cuda.max_memory_allocated()
    del model, total, m, grads, calls
    gc.collect()
    torch.cuda.empty_cache()
    # Written once the card is free: the ranks build their blocks on it.
    save_reference(saved, out_dir / "gpipe_moe_reference.pt")
    want = {k: n * GPIPE_MOE_MICRO * cfg.num_layers
            for k, n in FLASH_PER_LAYER.items()}
    if launches != want:
        raise AssertionError(f"one-process GPipe: flash launches {launches} "
                             f"!= {want}")
    print(f"expert[gpipe]: {MIXTRAL_MODEL} cut to {cfg.num_layers} layers, "
          f"one process, {stages} stages x {GPIPE_MOE_MICRO} microbatches, "
          f"B {GPIPE_MOE_BATCH} x {GPIPE_MOE_SEQ}, cf "
          f"{cfg.capacity_factor}: loss {loss!r}, aux {aux!r}, "
          f"{dropped} assignments dropped, forward and backward "
          f"{ms:.1f} ms, peak memory {peak / 1e9:.2f} GB, flash launches "
          f"{launches} [{card}]", flush=True)
    return dict(loss=loss, aux=aux, dropped=dropped, ms=ms,
                peak_memory_bytes=peak, launches=launches)


def gpipe_moe_worker(rank: int, port: int, out_dir: Path) -> None:
    """One rank of phase 7's second world (``chip_smoke.py
    --gpipe-moe-worker RANK PORT DIR``): gloo over ``GPIPE_MOE_RANKS``
    processes on cuda:0 at ``GPIPE_MOE_MESH``. Probes the collectives the
    step issues on CUDA tensors (all_reduce, all_gather, reduce_scatter,
    and the stage shift through ``collectives.ppermute``), builds its
    blocks of the one-process model (the same seed: the same values),
    takes its rows of every microbatch through the batch placer, runs one
    forward and backward on the recorded routing, and holds its loss, aux
    loss and gradient blocks to the one-process run's. Writes
    ``gpipe_moe_rank{RANK}.json``."""
    import torch.distributed as dist

    from triton_kubernetes_tpu_torch.models import llama
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa
    from triton_kubernetes_tpu_torch.parallel import (MeshConfig,
                                                      collectives,
                                                      create_mesh, placement)
    from triton_kubernetes_tpu_torch.parallel.collectives import \
        all_reduce_sum
    from triton_kubernetes_tpu_torch.parallel.multihost import \
        make_batch_placer
    from triton_kubernetes_tpu_torch.parallel.sharding import local_slices
    from triton_kubernetes_tpu_torch.train import loss_fn

    t_start = time.perf_counter()
    marks = {}
    if EXPERT_DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=GPIPE_MOE_RANKS)
    try:
        marks["joined"] = time.perf_counter() - t_start
        cfg = expert_config()
        mesh = create_mesh(MeshConfig(**GPIPE_MOE_MESH),
                           device_type=EXPERT_DEVICE)
        n = GPIPE_MOE_RANKS
        dev = EXPERT_DEVICE
        # The step's collectives on CUDA tensors, then the stage shift.
        x = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        gathered = torch.empty(4 * n, device=dev)
        dist.all_gather_into_tensor(gathered, torch.full(
            (4,), float(rank), device=dev))
        scattered = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(scattered, torch.arange(
            2 * n, dtype=torch.float32, device=dev))
        stage = mesh.coordinate()["stage"]
        shifted = collectives.ppermute(
            torch.full((3,), float(stage + 1), device=dev), mesh, "stage",
            [(0, 1), (1, 0)])
        probe = dict(
            all_reduce=bool(torch.all(x == n * (n + 1) / 2)),
            all_gather=gathered.tolist() == [float(r) for r in range(n)
                                             for _ in range(4)],
            reduce_scatter=scattered.tolist() == [
                float(n * v) for v in (2 * rank, 2 * rank + 1)],
            ppermute=shifted.device.type == torch.device(dev).type
            and shifted.tolist() == [float(2 - stage)] * 3,
            ppermute_through_host=collectives._through_host(
                shifted, mesh.group(["stage"])))
        if not all(probe.values()):
            raise AssertionError(f"gloo on {dev} tensors: {probe}")
        marks["probed"] = time.perf_counter() - t_start
        ref = await_reference(out_dir / "gpipe_moe_reference.pt")
        torch.cuda.reset_peak_memory_stats()
        model = llama.init_params(cfg, seed=EXPERT_SEED, device=dev,
                                  trainable=True, mesh=mesh)
        # The init drew every leaf whole: hand those blocks back, since
        # three more ranks share the card.
        torch.cuda.empty_cache()
        batch = make_batch_placer(mesh, microbatches=GPIPE_MOE_MICRO)(
            gpipe_moe_batch())
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        attn = llama.resolve_attention(cfg, model.device)
        share = (mesh.axes_size(GPIPE_MOE_ROW_AXES),
                 mesh.axes_index(GPIPE_MOE_ROW_AXES))
        calls = [(p.to(dev), i.to(dev)) for p, i in ref["calls"]]
        drops = []
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks["built"] = t0 - t_start
        with routing_by_probs("replay", calls, share) as worst, \
                counting_drops(placement.MeshRouting, cfg, drops):
            total, m = loss_fn(model, tokens, cfg, attn, mesh.shape["stage"],
                               GPIPE_MOE_MICRO)
            torch.cuda.synchronize()
            marks["forward"] = time.perf_counter() - t_start
            total.backward()
        loss, aux = float(m["loss"]), float(m["aux_loss"])
        ms = (time.perf_counter() - t0) * 1e3
        marks["backward"] = time.perf_counter() - t_start
        launches = dict(fa.flash_attention.launches)
        peak = torch.cuda.max_memory_allocated()
        layers_here = len(model.layers)
        by_name = {model.layout[name][0]: (name, p)
                   for name, p in model.named_parameters()}
        blocks = []
        for glob, e in gpipe_moe_leaves(stage):
            name, p = by_name[glob]
            _, shape, spec = model.layout[name]
            sl = local_slices(shape, spec, mesh)
            want = ref["grads"][glob]
            if e is None:
                got, want = p.grad, want[sl]
            else:
                got = p.grad[e - sl[0].start]
                want = want[(slice(0, 1),) + sl[1:]][0]
            blocks.append((glob, e, got.clone(), want))
        # Only the compared blocks are kept: the rest of the gradient and
        # the graph's buffers go back before the sums.
        for p in model.parameters():
            p.grad = None
        del total, m
        gc.collect()
        torch.cuda.empty_cache()
        grads = {}
        for glob, e, got, want in blocks:
            # Summed over data, along which every block is replicated, as
            # the step's sync_grads sums it (here only the compared
            # blocks; fsdp's reduce-scatter already summed its split).
            got = all_reduce_sum(got, mesh, ("data",))
            want = want.to(dev)
            grads[glob if e is None else f"{glob}[{e}]"] = dict(
                rel_l2=rel_l2(got, want),
                max_abs=float((got.float() - want.float()).abs().max()),
                bitwise=bool(torch.equal(got, want)),
                block=list(got.shape))
        out = dict(rank=rank, mesh=repr(mesh.shape), coordinate=dict(
                       stage=stage, row_shard=share[1]),
                   probe=probe, rows=batch["tokens"].shape[0],
                   loss=loss, aux=aux,
                   loss_bitwise=loss == ref["loss"],
                   loss_rel_diff=abs(loss - ref["loss"]) / abs(ref["loss"]),
                   aux_bitwise=aux == ref["aux"],
                   aux_rel_diff=abs(aux - ref["aux"]) / abs(ref["aux"]),
                   replay_worst_distance=worst[0],
                   dropped=sum(drops[:GPIPE_MOE_MICRO * layers_here]),
                   grads=grads, ms=ms, launches=launches,
                   layers=layers_here, peak_memory_bytes=peak,
                   marks={k: round(v, 2) for k, v in marks.items()})
        (out_dir / f"gpipe_moe_rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(flag, n, out_dir: Path, what, reference):
    """``n`` processes of ``chip_smoke.py FLAG RANK PORT DIR`` on this
    card, started before ``reference()`` runs here: while it computes
    what they are held to (and writes it for them, :func:`save_reference`),
    they start, join their world, probe it and import what their first
    step would (:func:`await_reference`). Returns ``reference()``'s
    result; raises with the failed ranks' log tails. Their caching
    allocators grow by expandable segments, so that blocks one rank
    caches past its need do not crowd out the others."""
    import os

    port = free_port()
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag, str(r),
         str(port), str(out_dir)],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(n)]
    logs = []
    try:
        ref = reference()
        deadline = time.monotonic() + EXPERT_WORLD_TIMEOUT_S
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:])
           for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    if bad:
        raise AssertionError(f"{what} world: ranks failed: {bad}")
    return ref


def save_reference(obj, path: Path) -> None:
    """Write a world's reference whole before its ranks can see it."""
    tmp = path.with_suffix(".tmp")
    torch.save(obj, tmp)
    tmp.replace(path)


def await_reference(path: Path):
    """A rank's reference, once the parent has written it. Before waiting
    the rank imports ``torch._dynamo``, which the first call of a
    rematerialized block (``torch.utils.checkpoint``) would import inside
    the timed step: 7.9-8.2 s a rank with four starting at once (H100
    80GB HBM3, 700 W host; PERF.md)."""
    import torch._dynamo  # noqa: F401

    deadline = time.monotonic() + EXPERT_WORLD_TIMEOUT_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise AssertionError(f"no reference at {path}")
        time.sleep(0.2)
    return torch.load(path, mmap=True)


def gpipe_moe_world(card, out_dir: Path):
    """The one-process GPipe run, then the four-rank world held to it.
    Returns (flash launches summed over the ranks, the record)."""
    t0 = time.perf_counter()

    def reference():
        ref = gpipe_moe_reference(card, out_dir)
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"expert[gpipe]: after the one-process run this process "
              f"holds {torch.cuda.memory_reserved() / 1e9:.2f} GB of the "
              f"card (memory_reserved); {free / 1e9:.2f} of "
              f"{total / 1e9:.2f} GB free", flush=True)
        return ref

    ref = run_world("--gpipe-moe-worker", GPIPE_MOE_RANKS, out_dir,
                    "gpipe moe", reference)
    ranks = [json.loads((out_dir / f"gpipe_moe_rank{r}.json").read_text())
             for r in range(GPIPE_MOE_RANKS)]
    problems = []
    for r in ranks:
        want = {k: v * GPIPE_MOE_MICRO * r["layers"]
                for k, v in FLASH_PER_LAYER.items()}
        grad_rel = max(g["rel_l2"] for g in r["grads"].values())
        bad = []
        for what, bound in (("loss", GPIPE_MOE_LOSS_REL),
                            ("aux", EXPERT_LOSS_REL)):
            if not (r[f"{what}_bitwise"] or r[f"{what}_rel_diff"] <= bound):
                bad.append(f"{what} {r[what]!r} vs {ref[what]!r} (bound "
                           f"{bound})")
        if not grad_rel <= STEP_GRAD_REL_L2:
            bad.append(f"worst gradient rel L2 {grad_rel}")
        if r["launches"] != want:
            bad.append(f"flash launches {r['launches']} != {want}")
        if r["rows"] != GPIPE_MOE_BATCH // (
                GPIPE_MOE_MESH.get("data", 1) * GPIPE_MOE_MESH.get("fsdp", 1)):
            bad.append(f"holds {r['rows']} rows")
        problems += [f"rank {r['rank']}: {b}" for b in bad]
        print(f"expert[gpipe]: rank {r['rank']} of {GPIPE_MOE_RANKS} (gloo "
              f"on cuda:0, stage {r['coordinate']['stage']}, row shard "
              f"{r['coordinate']['row_shard']}, {r['rows']} rows: one of each "
              f"microbatch): loss {r['loss']!r} "
              f"{'bitwise' if r['loss_bitwise'] else 'rel diff %.3g' % r['loss_rel_diff']}"
              f" (bound {GPIPE_MOE_LOSS_REL}), aux {r['aux']!r} "
              f"{'bitwise' if r['aux_bitwise'] else 'rel diff %.3g' % r['aux_rel_diff']}"
              f" (bound {EXPERT_LOSS_REL}); gradient blocks (rel L2, bound "
              f"{STEP_GRAD_REL_L2}; bitwise): "
              f"{ {k: (round(g['rel_l2'], 9), g['bitwise']) for k, g in r['grads'].items()} }"
              f"; routing replayed (worst pairing distance "
              f"{r['replay_worst_distance']:.3g}); {r['dropped']} of its "
              f"assignments dropped; collectives on CUDA {r['probe']}; "
              f"flash launches {r['launches']}; forward and backward "
              f"{r['ms']:.1f} ms (four ranks share the card; from its start "
              f"the rank's seconds at each mark {r['marks']}); peak memory "
              f"{r['peak_memory_bytes'] / 1e9:.2f} GB [{card}]", flush=True)
    dropped = sum(r["dropped"] for r in ranks)
    if dropped != ref["dropped"] or not dropped:
        problems.append(f"the ranks dropped {dropped} assignments, the "
                        f"one-process run {ref['dropped']} (must be equal, "
                        f"and above 0)")
    if problems:
        raise AssertionError("gpipe moe: " + "; ".join(problems))
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in FLASH_PER_LAYER}
    seconds = time.perf_counter() - t0
    print(f"expert[gpipe]: {dropped} assignments dropped over the ranks, as "
          f"one process; world of {GPIPE_MOE_RANKS} took {seconds:.1f} s "
          f"[{card}]", flush=True)
    return launches, dict(reference=ref, ranks=ranks, launches=launches,
                          dropped=dropped, seconds=seconds)


# Phase 8: the workload chaos arms (``triton_kubernetes_tpu_torch/chaos``)
# on the card. Every engine of every arm serves one model: Llama-3-8B at
# full width and depth, random bf16 weights from seed 0, in the arms' own
# tiny pools (block size 4: the paged kernels' CUDA-core designs).
CHAOS_MODEL, CHAOS_DEVICE = "llama3-8b", "cuda"
CHAOS_CORPUS = Path(__file__).resolve().parent / "tests" / "chaos_corpus"
# The committed corpus entries one card hosts, each replayed to its pinned
# verdict, and the train arms, whose two NCCL ranks one card cannot host:
# they must report the typed skip.
CHAOS_REPLAYS = (
    "workload-prefill-gap", "workload-preempt-abort-flush",
    "mutation-leaked-pages", "mutation-swallowed-abort",
    "workload-replica-death", "mutation-dropped-reland",
    "workload-kv-migration-torn", "workload-torn-checkpoint",
    "workload-reshard-torn-checkpoint", "mutation-adopt-torn-step",
    "workload-sigterm-flush")
CHAOS_TRAIN_SKIPS = ("workload-rank-death", "workload-coordinator-loss")
# The arms that run engines, and must launch the paged kernels.
CHAOS_ENGINE_KINDS = ("engine-preempt", "replica-death", "kv-migration-torn")
# The spec_k 3 arm's drafter proposes from the sequence's own history (the
# arm's prompts are tokens 0-28): with random weights the 8B model's greedy
# tokens never repeat one of those, so its verify never runs (drafts
# proposed are recorded). The arm, its spec unchanged, runs again on a
# stand-in whose greedy tokens follow their history: the F9 card test's
# model (tests/test_torch_cuda.py F9_CONFIG, weights from seed 9) --
# llama-test at the 8B's head width D 128 and GQA group 4, 512 wide, 2
# layers, its 256-token vocabulary, in bf16, so the same bs-4 CUDA-core
# designs. It must launch paged_verify under preemption and accept at
# least one draft there: accepted drafts become kept tokens of a request
# that is preempted and recomputed.
CHAOS_DRAFT_MODEL = ("llama-test", dict(
    dtype="bfloat16", embed_dim=512, num_heads=4, num_kv_heads=1,
    head_dim=128, mlp_dim=1024, max_seq_len=256), 9)
# The world-of-one crash and resume: the train arms' trainer (llama-test,
# B 8, S 32, 4 steps, a checkpoint every step), rank 0 killed at step 2.
CHAOS_TRAIN_STEPS, CHAOS_CRASH_STEP = 4, 2
# Fault F9's probe: (block size, prefill chunk) of the chaos pools (the
# CUDA-core designs) and of a tensor-core pool (the main serve path's
# designs), each held bitwise; the lengths whose last row is compared,
# the last six across the decode walk's first 256-key span.
RECOMPUTE_DESIGNS = ((4, 8), (16, 16))
RECOMPUTE_LENGTHS = (*range(2, 26), 250, 255, 256, 257, 258, 262)
# The engine-preempt arm once more on the 8B in a pool of 16-token pages
# (``block_size`` 16: the paged kernels' tensor-core designs) tight
# enough to preempt: 4 usable pages, 48-token prompts (6 windows of the
# arm's 8 tokens) whose first decode token needs a fourth page. Its
# tokens must equal the solo runs' and it must preempt.
CHAOS_TC_WORKLOAD = {"kind": "engine-preempt", "long_windows": 6,
                     "requests": 3, "block_size": 16}
# Fault F11's check: the reshard-torn-checkpoint arm at least this many
# times beside forks (more while the world of one still runs). The arena
# before the repair went stale in 197 and 193 of 200 runs beside forks
# (H100 80GB HBM3, 700 W; PERF.md), so 10 runs catch it all but surely.
CHAOS_FORK_RUNS = 10


# The paged kernels at the chaos arms' shapes (phase 8): the 8B's heads in
# the arms' pools, block size 4, so the CUDA-core designs. Decode: the
# replicas' max_batch 4 at lengths across the 64-token table; verify: the
# preempt pool's 3 sequences at spec_k 3; prefill: one 8-token window at
# offsets 0, 16 and 40 of the preempt pool's 48-token table.
CHAOS_BS = 4
CHAOS_DECODE_LENGTHS = [1, 7, 30, 64]
CHAOS_VERIFY_LENGTHS = [1, 17, 45]
CHAOS_PREFILL_CHUNK, CHAOS_PREFILL_OFFSETS = 8, [0, 16, 40]


def chaos_pool(gen, n_pages, lengths_tables, device, bs=CHAOS_BS):
    """bf16 pools of ``bs``-token pages (the 8B's heads), POISON outside
    the slots each sequence has written."""
    pools = []
    for _ in range(2):
        pool = torch.full((n_pages, HKV, bs, D), POISON, dtype=torch.bfloat16,
                          device=device)
        for length, table in lengths_tables:
            for t in range(-(-length // bs)):
                n = min(bs, length - t * bs)
                pool[table[t], :, :n] = torch.randn(
                    (HKV, n, D), generator=gen, device=device
                ).to(torch.bfloat16)
        pools.append(pool)
    return pools


def chaos_kernel_phase(pa, device, flush, peaks):
    """Decode, verify and prefill at the chaos arms' shapes (CHAOS_*: bs 4,
    the CUDA-core designs) against their plain versions, timed beside them
    and one ``scaled_dot_product_attention`` call; verify rows bitwise
    the decode kernel's. Records named ``<kernel>_bs4``."""
    from triton_kubernetes_tpu_torch.ops import _kernels

    gen = torch.Generator(device=device).manual_seed(4321)
    bs, group, records = CHAOS_BS, HQ // HKV, []
    if _kernels.paged_variant(torch.bfloat16, torch.bfloat16, bs,
                              D) != "cuda_core":
        raise AssertionError("the chaos pools' shapes must take the "
                             "CUDA-core designs")

    def record(name, source, replaces, err, fn, plain, lib, pages_read,
               extra, keys, shape, **more):
        kms, pms = time_ms(fn, flush), time_ms(plain, flush)
        lms = time_ms(lib, flush)
        nbytes = pages_read * bs * HKV * D * 2 * 2 + extra
        rec = kernel_record(name, "bf16", source, replaces, err, kms, pms,
                            lms, nbytes, 4 * D * HQ * keys, peaks,
                            "scaled_dot_product_attention over the gathered "
                            "pages with the rows' masks", shape,
                            variant="cuda_core", **more)
        records.append(rec)
        return rec

    def gathered(pool, tables):
        return (pool[tables.long()].permute(0, 2, 1, 3, 4)
                .flatten(2, 3).repeat_interleave(group, dim=1))

    # Decode.
    tw = 64 // bs
    b = len(CHAOS_DECODE_LENGTHS)
    tables_cpu = (torch.randperm(b * tw, generator=torch.Generator()
                                 .manual_seed(4)).reshape(b, tw) + 1
                  ).to(torch.int32)
    kp, vp = chaos_pool(gen, 1 + b * tw, [
        (n, tables_cpu[i].tolist()) for i, n in
        enumerate(CHAOS_DECODE_LENGTHS)], device)
    tables = tables_cpu.to(device)
    lens = torch.tensor(CHAOS_DECODE_LENGTHS, dtype=torch.int32,
                        device=device)
    q = torch.randn((b, 1, HQ, D), generator=gen, device=device
                    ).to(torch.bfloat16)
    got = pa.ragged_paged_attention(q, kp, vp, tables, lens, impl="cuda")
    err = check_close("paged_decode at bs 4", got, pa.ragged_paged_attention(
        q, kp, vp, tables, lens, impl="dense"))
    kk, vv = gathered(kp, tables), gathered(vp, tables)
    mask = (torch.arange(tw * bs, device=device)[None, :]
            < lens[:, None])[:, None, None, :]
    record("paged_decode_bs4", "paged_decode.cu",
           "triton_kubernetes_tpu/ops/paged_attention.py:461", err,
           lambda: pa.ragged_paged_attention(q, kp, vp, tables, lens,
                                             impl="cuda"),
           lambda: pa.ragged_paged_attention(q, kp, vp, tables, lens,
                                             impl="dense"),
           lambda: sdpa(q.transpose(1, 2), kk, vv, mask),
           sum(-(-n // bs) for n in CHAOS_DECODE_LENGTHS),
           2 * q.numel() * 2 + tables.numel() * 4 + b * 4,
           sum(CHAOS_DECODE_LENGTHS),
           dict(B=b, Hq=HQ, Hkv=HKV, D=D, bs=bs, T=tw,
                lengths=CHAOS_DECODE_LENGTHS))

    # Verify, rows bitwise the decode kernel's.
    tw, s = 48 // bs, SPEC_K + 1
    b = len(CHAOS_VERIFY_LENGTHS)
    tables_cpu = (torch.randperm(b * tw, generator=torch.Generator()
                                 .manual_seed(5)).reshape(b, tw) + 1
                  ).to(torch.int32)
    kp, vp = chaos_pool(gen, 1 + b * tw, [
        (n + s - 1, tables_cpu[i].tolist()) for i, n in
        enumerate(CHAOS_VERIFY_LENGTHS)], device)
    tables = tables_cpu.to(device)
    lens = torch.tensor(CHAOS_VERIFY_LENGTHS, dtype=torch.int32,
                        device=device)
    q = torch.randn((b, s, HQ, D), generator=gen, device=device
                    ).to(torch.bfloat16)
    got = pa.ragged_verify_attention(q, kp, vp, tables, lens, impl="cuda")
    err = check_close("paged_verify at bs 4", got, pa.ragged_verify_attention(
        q, kp, vp, tables, lens, impl="dense"))
    for j in range(s):
        row = pa.ragged_paged_attention(q[:, j:j + 1].contiguous(), kp, vp,
                                        tables, lens + j, impl="cuda")
        if not torch.equal(got[:, j:j + 1], row):
            raise AssertionError(f"paged_verify at bs 4: row {j} differs "
                                 f"from paged_decode at lengths + {j}")
    kk, vv = gathered(kp, tables), gathered(vp, tables)
    row_len = lens[:, None] + torch.arange(s, device=device)[None]
    mask = (torch.arange(tw * bs, device=device)[None, None, :]
            < row_len[:, :, None])[:, None]
    record("paged_verify_bs4", "paged_verify.cu",
           "triton_kubernetes_tpu/ops/paged_attention.py:756", err,
           lambda: pa.ragged_verify_attention(q, kp, vp, tables, lens,
                                              impl="cuda"),
           lambda: pa.ragged_verify_attention(q, kp, vp, tables, lens,
                                              impl="dense"),
           lambda: sdpa(q.transpose(1, 2), kk, vv, mask),
           sum(-(-(n + s - 1) // bs) for n in CHAOS_VERIFY_LENGTHS),
           2 * q.numel() * 2 + tables.numel() * 4 + b * 4,
           int(row_len.sum()),
           dict(B=b, S=s, Hq=HQ, Hkv=HKV, D=D, bs=bs, T=tw,
                lengths=CHAOS_VERIFY_LENGTHS),
           rows_bitwise_equal_to_decode=True)

    # Prefill: one window at each offset, summed; rows bitwise the decode
    # kernel's at their lengths (fault F9).
    tw, c = 48 // bs, CHAOS_PREFILL_CHUNK
    table_cpu = (torch.randperm(tw, generator=torch.Generator()
                                .manual_seed(6)) + 1).to(torch.int32)
    kp, vp = chaos_pool(gen, 1 + tw, [(tw * bs, table_cpu.tolist())],
                        device)
    table = table_cpu.to(device)
    kk, vv = gathered(kp, table[None]), gathered(vp, table[None])
    cases = []
    for off in CHAOS_PREFILL_OFFSETS:
        q = torch.randn((1, c, HQ, D), generator=gen, device=device
                        ).to(torch.bfloat16)
        got = pa.paged_prefill_attention(q, kp, vp, table, off, impl="cuda")
        err = check_close(f"paged_prefill@{off} at bs 4", got,
                          pa.paged_prefill_attention(q, kp, vp, table, off,
                                                     impl="dense"))
        rows = pa.ragged_paged_attention(
            q[0][:, None].contiguous(), kp, vp,
            table[None].expand(c, tw).contiguous(),
            torch.arange(off + 1, off + c + 1, dtype=torch.int32,
                         device=device), impl="cuda")
        if not torch.equal(got[0], rows[:, 0]):
            raise AssertionError(f"paged_prefill@{off} at bs 4: a row "
                                 f"differs from paged_decode at its length "
                                 f"(fault F9)")
        qpos = off + torch.arange(c, device=device)
        mask = (torch.arange(tw * bs, device=device)[None, :]
                <= qpos[:, None])[None, None]
        keys = sum(off + i + 1 for i in range(c))
        pages = -(-(off + c) // bs)
        cases.append(dict(
            offset=off, max_abs_err=err,
            ms=time_ms(lambda: pa.paged_prefill_attention(
                q, kp, vp, table, off, impl="cuda"), flush),
            plain_ms=time_ms(lambda: pa.paged_prefill_attention(
                q, kp, vp, table, off, impl="dense"), flush),
            library_ms=time_ms(lambda: sdpa(q.transpose(1, 2), kk, vv,
                                            mask), flush),
            flops=4 * D * HQ * keys,
            bytes=pages * bs * HKV * D * 2 * 2 + 2 * q.numel() * 2
            + table.numel() * 4))
        cases[-1]["bound_ms"] = max(cases[-1]["flops"] / peaks[1],
                                    cases[-1]["bytes"] / peaks[0]) * 1e3
    rec = kernel_record(
        "paged_prefill_bs4", "bf16", "paged_prefill.cu",
        "triton_kubernetes_tpu/ops/paged_attention.py:633",
        max(x["max_abs_err"] for x in cases), sum(x["ms"] for x in cases),
        sum(x["plain_ms"] for x in cases),
        sum(x["library_ms"] for x in cases),
        sum(x["bytes"] for x in cases), sum(x["flops"] for x in cases),
        peaks, "scaled_dot_product_attention over the gathered pages with "
        "a causal mask at the window's offset",
        dict(C=c, Hq=HQ, Hkv=HKV, D=D, bs=bs, T=tw,
             offsets=CHAOS_PREFILL_OFFSETS, summed_over="offsets"),
        variant="cuda_core", cases=cases, rows_bitwise_equal_to_decode=True)
    rec["bound_ms"] = sum(x["bound_ms"] for x in cases)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    records.append(rec)
    for r in records:
        print(f"kernel {r['name']} ({r['variant']}, the chaos pools): "
              f"max_abs_err={r['max_abs_err']:.6g} (tolerance "
              f"{r['tolerance']}) kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}); rows == "
              f"paged_decode bitwise", flush=True)
    return records


def recompute_probe(model, cfg, card, designs=RECOMPUTE_DESIGNS,
                    lengths=RECOMPUTE_LENGTHS, device=CHAOS_DEVICE):
    """Fault F9: a preempted sequence recomputes its history in prefill
    windows and samples its next token from a window's last row, where its
    solo run sampled it from a decode tick. For each (bs, chunk) and each
    length n of a seeded sequence: the last row's logits of the windows
    over its first n tokens on a fresh pool, against one decode step at
    length n - 1 after windows over n - 1 tokens -- rows torch.equal,
    greedy tokens equal, the worst difference, and the written pages
    torch.equal. Returns a record a design."""
    from triton_kubernetes_tpu_torch.models import paged
    from triton_kubernetes_tpu_torch.ops import _kernels

    seq = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                            max(lengths)).tolist()
    dtype = getattr(torch, cfg.dtype)
    out = []
    for bs, chunk in designs:
        per = -(-max(lengths) // chunk) * chunk // bs
        table = torch.arange(1, per + 1, dtype=torch.int32, device=device)

        def window(cache, off, n):
            """The window at ``off`` of a sequence's first n tokens."""
            clen = min(chunk, n - off)
            toks = seq[off:off + clen] + [0] * (chunk - clen)
            return paged.paged_prefill_chunk(
                model, torch.tensor([toks], dtype=torch.int32,
                                    device=device), off, clen, cfg, cache,
                table)

        # The windows over n - 1 tokens and over n begin with the same
        # full windows, as do those of every longer length: a base pool
        # keeps the full windows written so far (n - 1, then n, lengths in
        # increasing order), and each pool starts from a copy of it, which
        # holds the bytes a fresh pool holds after those windows.
        base = paged.init_paged_cache(cfg, per + 1, bs, device=device)
        base_windows = 0

        def windows(n):
            """(the last window's logits, the pool) of the windows over the
            first n tokens, on a pool that was fresh before them."""
            nonlocal base_windows
            shared = (n - 1) // chunk
            while base_windows < shared:
                window(base, base_windows * chunk, n)
                base_windows += 1
            cache = dataclasses.replace(base, k=base.k.clone(),
                                        v=base.v.clone())
            logits = None
            for off in range(shared * chunk, n, chunk):
                logits = window(cache, off, n)
            return logits, cache

        def written(cache, n):
            pages = table[:-(-n // bs)].long()
            return [x[:, pages].transpose(1, 2).flatten(2, 3)[:, :, :n]
                    for x in (cache.k, cache.v)]

        rec = dict(bs=bs, chunk=chunk, lengths=len(lengths),
                   design=_kernels.paged_variant(dtype, dtype, bs,
                                                 cfg.head_dim),
                   rows_equal=0, greedy_equal=0, pages_equal=0,
                   max_abs_diff=0.0)
        with torch.inference_mode():
            for n in sorted(lengths):
                _, cache = windows(n - 1)
                want, wcache = windows(n)
                got = paged.paged_decode_step(
                    model, torch.tensor([seq[n - 1]], dtype=torch.int32,
                                        device=device), cfg, cache,
                    table[None], torch.tensor([n - 1], dtype=torch.int32,
                                              device=device))[0]
                rec["rows_equal"] += bool(torch.equal(got, want))
                rec["greedy_equal"] += int(got.argmax()) == int(want.argmax())
                rec["pages_equal"] += all(
                    bool(torch.equal(a, b))
                    for a, b in zip(written(cache, n), written(wcache, n)))
                rec["max_abs_diff"] = max(rec["max_abs_diff"],
                                          float((got - want).abs().max()))
        print(f"chaos: F9 probe, {cfg.num_layers} layers, bs {bs}, chunk "
              f"{chunk} ({rec['design']} designs): the last window row vs "
              f"the decode row at {len(lengths)} lengths "
              f"{list(lengths)}: {rec['rows_equal']} "
              f"torch.equal, {rec['greedy_equal']} greedy tokens equal, "
              f"max abs diff {rec['max_abs_diff']!r}, pages torch.equal "
              f"{rec['pages_equal']} [{card}]", flush=True)
        out.append(rec)
    return out


def chaos_launches(cfg, launches, block_size):
    """The serving kernels' launches of one arm, by kernel and design: the
    paged kernels' by the design pools of ``block_size`` take, the GEMM's
    mma.sync (at most 64 rows) and wgmma launches apart."""
    from triton_kubernetes_tpu_torch.ops import _kernels

    dtype = getattr(torch, cfg.dtype)
    design = _kernels.paged_variant(dtype, dtype, block_size, cfg.head_dim)
    out = {k: {design: launches[k]} for k in _kernels.PAGED_KERNELS
           if launches[k]}
    if launches["decode_gemm"]:
        out["decode_gemm"] = {
            "mma_sync": launches["decode_gemm"]
            - launches["decode_gemm_wgmma"],
            "wgmma": launches["decode_gemm_wgmma"]}
    out.update({k: n for k, n in launches.items()
                if n and k not in out and k != "decode_gemm_wgmma"})
    return out


def chaos_cases(entries):
    """(label, spec, expected verdict, invariant, model) of every chaos
    run: the corpus replays, the specs built here, the train arms' skips
    (model None: the 8B; "draft": CHAOS_DRAFT_MODEL)."""
    import copy

    cases = [(name, entries[name]["spec"], entries[name]["expect"],
              entries[name].get("invariant"), None)
             for name in CHAOS_REPLAYS]
    base = copy.deepcopy(entries["workload-prefill-gap"]["spec"])
    spec3 = dict(base, workload={
        "kind": "engine-preempt", "long_windows": 5, "requests": 3,
        "prefix_cache": True, "spec_k": 3})
    cases.append(("preempt-prefix-spec3", spec3, "pass", None, None))
    for corruption in ("truncate", "bitflip", "torn-manifest"):
        cases.append((f"torn-checkpoint-{corruption}", dict(base, workload={
            "kind": "torn-checkpoint", "corruption": corruption}),
            "pass", None, None))
    mig = copy.deepcopy(entries["workload-kv-migration-torn"]["spec"])
    cases.append(("mutation-accepted-torn", dict(mig, mutation="accepted-torn"),
                  "violated", "migration-integrity", None))
    cases.append(("engine-preempt-bs16", dict(base, workload=dict(
        CHAOS_TC_WORKLOAD)), "pass", None, None))
    cases += [(name, entries[name]["spec"], "skipped", None, None)
              for name in CHAOS_TRAIN_SKIPS]
    cases.append(("preempt-prefix-spec3-draft", spec3, "pass", None,
                  "draft"))
    return cases


def world_of_one():
    """The train arms' crash and resume as a world of one on the card
    (trainer processes of llama-test) and its seconds."""
    from triton_kubernetes_tpu_torch.chaos import workload as wl

    return timed(wl.train_crash_resume, CHAOS_TRAIN_STEPS, CHAOS_CRASH_STEP,
                 0, device=CHAOS_DEVICE, n_processes=1)


def fork_check(spec, run_scenario, wl, world, card):
    """Fault F11's check: the reshard-torn-checkpoint arm over and over
    beside ``wl.forking_beside`` (forks holding this process's pages
    copy-on-write) until the world of one is done, CHAOS_FORK_RUNS times
    at least; every run must restore its step's values."""
    import copy as copy_

    bad, runs, t0 = [], 0, time.perf_counter()
    with wl.forking_beside() as forks:
        while runs < CHAOS_FORK_RUNS or not world.done():
            res = run_scenario(copy_.deepcopy(spec), ns=f"f11-{runs}",
                               device=CHAOS_DEVICE)
            runs += 1
            if not res.passed:
                bad.append([v["detail"] for v in res.violations])
    torch.cuda.synchronize()
    print(f"chaos: F11 check: workload-reshard-torn-checkpoint {runs} times "
          f"beside {forks[0]} forks holding the pages "
          f"{wl.FORK_HOLD_S} s (and the world of one): {len(bad)} "
          f"violated, {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    if bad or not forks[0]:
        raise AssertionError(f"F11: {len(bad)} of {runs} restores beside "
                             f"{forks[0]} forks were stale: {bad[:3]}")
    return dict(runs=runs, forks=forks[0], violated=len(bad))


def chaos_phase(card):
    """Phase 8: the workload chaos arms on the card (see CHAOS_*), with
    the train arms' crash and resume as a world of one (trainer
    processes, forked beside the in-process arms: F11's configuration)
    running beside them, then F11's check (:func:`fork_check`) while the
    world of one finishes. Returns the launches summed over the arms and
    the record."""
    from triton_kubernetes_tpu_torch.chaos import corpus
    from triton_kubernetes_tpu_torch.chaos import workload as wl
    from triton_kubernetes_tpu_torch.chaos.runner import run_scenario
    from triton_kubernetes_tpu_torch.models import get_config, init_params
    from triton_kubernetes_tpu_torch.ops import _kernels
    from triton_kubernetes_tpu_torch.parallel.multihost import \
        REASON_RANKS_SHARE_CARD
    from triton_kubernetes_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    cfg = get_config(CHAOS_MODEL)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=CHAOS_DEVICE)
    torch.cuda.synchronize()
    print(f"chaos: {CHAOS_MODEL} {cfg.num_layers} layers, width "
          f"{cfg.embed_dim}, {cfg.num_params() / 1e9:.3f}B bf16 params in "
          f"{time.perf_counter() - t0:.1f} s; pools {wl.preempt_pool()}, "
          f"{wl.preempt_pool(16)} and {wl._REPLICA_KW}", flush=True)
    probe = recompute_probe(model, cfg, card)
    for rec in probe:
        if (rec["rows_equal"] != rec["lengths"]
                or rec["pages_equal"] != rec["lengths"]):
            raise AssertionError(f"F9: a recomputed row differs from the "
                                 f"decode row on the {rec['design']} "
                                 f"designs: {rec}")
    entries = {e["name"]: e for _, e in corpus.load_entries(CHAOS_CORPUS)}
    runs, total = [], {}
    models = {None: (cfg, model)}
    wl.use_model(cfg, model)
    side = concurrent.futures.ThreadPoolExecutor(1)
    world = side.submit(world_of_one)
    try:
        for label, spec, expect, invariant, which in chaos_cases(entries):
            if which not in models:
                # The 8B's weights go first: one model on the card at once.
                wl.use_model()
                models.clear()
                model = None
                gc.collect()
                torch.cuda.empty_cache()
                name, over, seed = CHAOS_DRAFT_MODEL
                dcfg = get_config(name, **over)
                model = init_params(dcfg, seed=seed, device=CHAOS_DEVICE)
                models[which] = (dcfg, model)
                wl.use_model(dcfg, model)
            rcfg = models[which][0]
            tc_pool = label == "engine-preempt-bs16"
            pool = wl.preempt_pool(spec["workload"].get("block_size", 4))
            reset_counts()
            t0 = time.perf_counter()
            res = run_scenario(spec, ns=label, device=CHAOS_DEVICE)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            kind = spec["workload"]["kind"]
            launches = launch_counts()
            served = {k: metrics.counter(f"tk8s_serve_{k}_total").value()
                      for k in ("prefix_hit_tokens", "spec_proposed_tokens",
                                "spec_accepted_tokens")}
            # The bs-4 kernel records' launches are the arms' in bs-4
            # pools; the bs-16 run's stay in its own record.
            for k, n in launches.items():
                total[k] = total.get(k, 0) + (0 if tc_pool else n)
            violated = [v["invariant"] for v in res.violations]
            skipped = res.stats.get("workload_skipped")
            verdict = ("skipped" if skipped else
                       "pass" if res.passed else "violated")
            run = dict(name=label, kind=kind, verdict=verdict,
                       want=expect, checked=res.checked, violated=violated,
                       skipped=skipped,
                       model=f"{rcfg.name} {rcfg.num_layers} layers, "
                             f"width {rcfg.embed_dim}, vocab "
                             f"{rcfg.vocab_size}",
                       workload_preemptions=res.stats.get(
                           "workload_preemptions"),
                       simulated_seconds=res.stats["simulated_seconds"],
                       seconds=seconds, served=served,
                       pool=pool if kind == "engine-preempt" else None,
                       launches=chaos_launches(rcfg, launches,
                                               pool["block_size"]))
            runs.append(run)
            print(f"chaos: {label} ({kind}; {run['model']}): {verdict} "
                  f"(want {expect}"
                  f"{' on ' + invariant if invariant else ''}), checked "
                  f"{res.checked}, violated {violated}, preemptions "
                  f"{run['workload_preemptions']}, {seconds:.2f} s, "
                  f"served {served}, launches {run['launches']} [{card}]",
                  flush=True)
            problems = []
            if verdict != expect:
                problems.append(f"verdict {verdict}, want {expect}")
            if expect == "violated" and violated != [invariant]:
                problems.append(f"violated {violated}, want [{invariant}]")
            if expect == "skipped" and (skipped != REASON_RANKS_SHARE_CARD
                                        or res.checked):
                problems.append(f"skip reason {skipped!r}, checked "
                                f"{res.checked}")
            if kind in CHAOS_ENGINE_KINDS:
                need = ["paged_decode", "paged_prefill"]
                if spec["workload"].get("spec_k") and which == "draft":
                    need.append("paged_verify")
                    if served["spec_accepted_tokens"] < 1:
                        problems.append("no draft accepted")
                problems += [f"no {k} launch" for k in need
                             if not launches[k]]
            if tc_pool:
                design = _kernels.paged_variant(
                    getattr(torch, rcfg.dtype), getattr(torch, rcfg.dtype),
                    pool["block_size"], rcfg.head_dim)
                if design != "tensor_core":
                    problems.append(f"the pool's design is {design}")
                if not res.stats.get("workload_preemptions"):
                    problems.append("no preemption")
            if spec["workload"].get("prefix_cache") and expect == "pass":
                if not served["prefix_hit_tokens"]:
                    problems.append("no prefix-cache hit")
                if not res.stats.get("workload_preemptions"):
                    problems.append("no preemption")
            if problems:
                raise AssertionError(f"chaos {label}: " + "; ".join(problems)
                                     + f" ({res.violations})")
        preempts = [r for r in runs if r["kind"] == "engine-preempt"
                    and r["verdict"] == "pass"]
        if not any(r["workload_preemptions"] for r in preempts):
            raise AssertionError("chaos: no engine-preempt arm preempted")
        f11 = fork_check(entries["workload-reshard-torn-checkpoint"]["spec"],
                         run_scenario, wl, world, card)
        world, seconds = world.result()
    finally:
        side.shutdown()
        wl.use_model()
        models.clear()
        model = None
        gc.collect()
        torch.cuda.empty_cache()
    world["seconds"] = seconds
    flash = world["resume_launches"] or {}
    print(f"chaos: world of one (llama-test, --device {CHAOS_DEVICE}): rank 0 "
          f"killed at step {CHAOS_CRASH_STEP}: rcs {world['rcs']}, resumed "
          f"final loss {world['final']!r} vs uninterrupted "
          f"{world['reference']!r} (tolerance {wl.TRAIN_LOSS_TOL}; "
          f"{'bitwise' if world['final'] == world['reference'] else 'not bitwise'}"
          f"), {world['traces']} rank traces, goodput problems "
          f"{world['trace_problems']}, resumed run's flash launches {flash}, "
          f"{world['seconds']:.1f} s [{card}]", flush=True)
    if not (world["died"] and world["rcs"] == [3] and world["ok"]
            and world["traces"] == 2 and not world["trace_problems"]
            and all(flash.get(k) for k in FLASH_PER_LAYER)):
        raise AssertionError(f"chaos: world-of-one crash and resume: "
                             f"{world}")
    seconds = time.perf_counter() - t_phase
    print(f"chaos: phase 8 took {seconds:.1f} s [{card}]", flush=True)
    line = {"chaos": {
        "model": f"{CHAOS_MODEL} {cfg.num_layers} layers",
        "seconds": round(seconds, 1), "f9_probe": probe, "f11_check": f11,
        "runs": [{k: r[k] for k in ("name", "model", "verdict", "checked",
                                    "workload_preemptions", "seconds",
                                    "served", "launches", "skipped",
                                    "pool")}
                 for r in runs],
        "world_of_one": {k: world[k] for k in (
            "rcs", "final", "reference", "resume_launches", "seconds")}}}
    print(json.dumps(line, default=str), flush=True)
    return total, dict(line["chaos"], runs=runs, world_of_one=world)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None,
                        help="directory for chip_smoke.json")
    parser.add_argument("--flash-only", action="store_true",
                        help="build the three flash kernels, hold them "
                             "against their plain versions, time them and "
                             "stop: the short first run after a change to "
                             "one of them (prints no device line)")
    parser.add_argument("--gemm-only", action="store_true",
                        help="build the decode GEMM, the norm and the "
                             "quantizer, run the bit probe and hold the "
                             "GEMMs (mma.sync and wgmma) and the norms "
                             "against their plain versions, time them and "
                             "stop: the short first run after a change to "
                             "the GEMM (prints no device line)")
    parser.add_argument("--migration-only", action="store_true",
                        help="build every kernel, run the six serve runs "
                             "of the 12 requests on the 8B model, then the "
                             "traced and the migration runs against them, "
                             "and stop: the short first run after a change "
                             "to tracing or migration (prints no device "
                             "line)")
    parser.add_argument("--train-only", action="store_true",
                        help="build the three flash kernels, hold them "
                             "against their plain versions, then run phase "
                             "5 with its kill and resume arms, and stop: "
                             "the short run after a change to the train "
                             "path (DIR/chip_smoke_train.json with --out; "
                             "prints no device line)")
    parser.add_argument("--http-only", action="store_true",
                        help="build every kernel, run the six serve runs "
                             "of the 12 requests on the 8B model, then the "
                             "HTTP phase against them (an in-process fleet "
                             "behind the router, disaggregated prefill -> "
                             "decode, the serve and route entry points), "
                             "and stop: the short first run after a change "
                             "to the HTTP layer (prints no device line)")
    parser.add_argument("--distributed-only", action="store_true",
                        help="build the three flash kernels, hold them "
                             "against their plain versions, then run phase "
                             "6 (GPipe, the ring at n = 1, blockwise "
                             "attention, the entry point under a one-rank "
                             "NCCL world, the fused exchange; it runs phase "
                             "5's trainer once for its baseline) and stop "
                             "(DIR/chip_smoke_distributed.json with --out; "
                             "prints no device line)")
    parser.add_argument("--expert-only", action="store_true",
                        help="build the three flash kernels, hold them "
                             "against their plain versions, then run phase "
                             "7 (Mixtral-8x7B, 2 layers, the expert-1 step, "
                             "then a gloo world of two ranks on the card at "
                             "expert 2) and stop (DIR/chip_smoke_expert.json "
                             "with --out; prints no device line)")
    parser.add_argument("--chaos-only", action="store_true",
                        help="build every kernel, run phase 8 (the "
                             "workload chaos arms on llama3-8b at full "
                             "width: the corpus replays, the specs built "
                             "here, the train arms' typed skips, the F9 "
                             "probe and the world-of-one crash and resume) "
                             "and stop (DIR/chip_smoke_chaos.json with "
                             "--out; prints no device line)")
    parser.add_argument("--w8a8-only", action="store_true",
                        help="build every kernel and run the W8A8 check "
                             "of phase 4 on the 8B model (each layer fed "
                             "the plain path's input, int8 and fp8; the "
                             "full-depth first-token logits printed) "
                             "without the serve runs, and stop: the short "
                             "run after a change upstream of a quantizer "
                             "(DIR/chip_smoke_w8a8.json with --out; prints "
                             "no device line)")
    parser.add_argument("--expert-worker", nargs=3, default=None,
                        metavar=("RANK", "PORT", "DIR"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--gpipe-moe-worker", nargs=3, default=None,
                        metavar=("RANK", "PORT", "DIR"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--mixtral-only", action="store_true",
                        help="build every kernel, run the Mixtral phase "
                             "(serve 4 layers, train 2 through the entry "
                             "point) and stop: the short run after a change "
                             "to the MoE path (DIR/chip_smoke_mixtral.json "
                             "with --out; prints no device line)")
    args = parser.parse_args()
    if args.expert_worker is not None and torch.cuda.is_available():
        rank, port, out_dir = args.expert_worker
        expert_worker(int(rank), int(port), Path(out_dir))
        return 0
    if args.gpipe_moe_worker is not None and torch.cuda.is_available():
        rank, port, out_dir = args.gpipe_moe_worker
        gpipe_moe_worker(int(rank), int(port), Path(out_dir))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the "
              "card", file=sys.stderr)
        return 2
    try:
        from triton_kubernetes_tpu_torch.ops import _kernels
        from triton_kubernetes_tpu_torch.ops import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run this "
              f"script from the root of a checkout of the repository",
              file=sys.stderr)
        return 2

    # Phase 1: card.
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    peak_name, peaks = card_peaks(name)
    print(card, flush=True)
    print(f"card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; peaks of the {peak_name}: "
          f"{peaks[0] / 1e12} TB/s, {peaks[1] / 1e12:.0f} bf16 TFLOP/s)",
          flush=True)
    device = torch.device("cuda")
    full_run = not any((args.flash_only, args.gemm_only, args.w8a8_only,
                        args.migration_only,
                        args.train_only, args.http_only,
                        args.distributed_only, args.expert_only,
                        args.chaos_only, args.mixtral_only))
    # The rendered health probe (phase 2 checks it) runs beside the build.
    probes = start_health_probes() if full_run else []

    # Phase 2: build, every source at once.
    t_start = t0 = time.perf_counter()
    built = (tuple(k for k in _kernels.KERNELS if k.startswith("flash_"))
             if args.flash_only or args.train_only
             or args.distributed_only or args.expert_only else
             ("decode_gemm", "rms_norm", "quantize_rows") if args.gemm_only
             else _kernels.KERNELS)
    logs = _kernels.build(built)
    for kernel in built:
        _kernels.library(kernel)
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(built)} in {build_s:.1f} s", flush=True)
    health = health_probe_check(probes, card) if full_run else None
    phase_done("2 build (and the health probe)", t0)
    for kernel, log in logs.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or line.startswith("built ")
                    or "warning" in line.lower()):
                print(f"build: {kernel}: {line.strip()}", flush=True)
        # Which function each wgmma GEMM or probe line belongs to.
        fn = None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
            elif fn and ("wgmma" in fn or "probe" in fn) and (
                    "stack frame" in line or "registers" in line):
                print(f"build: {kernel}: {fn}: {line.strip()}", flush=True)

    if args.mixtral_only:
        with tempfile.TemporaryDirectory() as tmp:
            out_dir = args.out if args.out is not None else Path(tmp)
            out_dir.mkdir(parents=True, exist_ok=True)
            mixtral_launches, mixtral = mixtral_phase(card, out_dir)
        if args.out is not None:
            (args.out / "chip_smoke_mixtral.json").write_text(json.dumps(
                dict(card=card, device=name, mixtral=mixtral), indent=1,
                default=str))
        print(json.dumps({"mixtral_launches": mixtral_launches}))
        return 0

    if args.chaos_only:
        flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
        records = chaos_kernel_phase(pa, device, flush, peaks)
        del flush
        total, chaos = chaos_phase(card)
        for r in records:
            r["launches"] = total[r["name"].removesuffix("_bs4")]
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            (args.out / "chip_smoke_chaos.json").write_text(json.dumps(
                dict(card=card, device=name, kernels=records, chaos=chaos),
                indent=1, default=str))
        print(json.dumps({"kernels": [{k: r.get(k) for k in (
            "name", "variant", "launches", "max_abs_err", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")} for r in records]}))
        return 0

    if args.w8a8_only:
        t0 = time.perf_counter()
        w8a8 = w8a8_only(card)
        phase_done("4 serve: W8A8 check alone", t0)
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            (args.out / "chip_smoke_w8a8.json").write_text(json.dumps(
                dict(card=card, device=name, w8a8=w8a8), indent=1))
        print(json.dumps({"w8a8": {wd: {k: r[k] for k in (
            "per_layer_kernel_worst", "per_layer_control_best",
            "rel_l2_vs_plain", "plain_paths_rel_l2")}
            for wd, r in w8a8.items()}}))
        return 0

    if args.migration_only or args.http_only:
        serve = migration_only(card, http_only=args.http_only)
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            which = "http" if args.http_only else "migration"
            (args.out / f"chip_smoke_{which}.json").write_text(json.dumps(
                dict(card=card, device=name, **serve), indent=1))
        return 0

    # Phase 3: kernels against their plain versions.
    t0 = time.perf_counter()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    if args.flash_only:
        print(json.dumps({"kernels": flash_kernel_phase(device, flush,
                                                        peaks)}))
        return 0
    if args.distributed_only:
        records = flash_kernel_phase(device, flush, peaks)
        del flush
        with tempfile.TemporaryDirectory() as tmp:
            out_dir = args.out if args.out is not None else Path(tmp)
            out_dir.mkdir(parents=True, exist_ok=True)
            dist = distributed_phase(card, out_dir)
        if args.out is not None:
            (args.out / "chip_smoke_distributed.json").write_text(
                json.dumps(dict(card=card, device=name, kernels=records,
                                distributed=dist), indent=1, default=str))
        print(json.dumps({"distributed": {
            "launches": dist["launches"], "seconds": dist["seconds"],
            "entry": {k: dist["entry"][k] for k in (
                "mesh", "dcn_sync", "losses_bitwise")}}}))
        return 0
    if args.expert_only:
        records = flash_kernel_phase(device, flush, peaks)
        del flush
        with tempfile.TemporaryDirectory() as tmp:
            out_dir = args.out if args.out is not None else Path(tmp)
            out_dir.mkdir(parents=True, exist_ok=True)
            expert_launches, expert = expert_phase(card, out_dir)
        if args.out is not None:
            (args.out / "chip_smoke_expert.json").write_text(json.dumps(
                dict(card=card, device=name, kernels=records,
                     expert=expert), indent=1, default=str))
        print(json.dumps({"expert": {"launches": expert_launches,
                                     "seconds": expert["seconds"]}}))
        return 0
    if args.train_only:
        records = flash_kernel_phase(device, flush, peaks)
        del flush
        with tempfile.TemporaryDirectory() as tmp:
            out_dir = args.out if args.out is not None else Path(tmp)
            out_dir.mkdir(parents=True, exist_ok=True)
            train_launches, train = train_phase(card, out_dir)
            durable = durability_phase(card, out_dir)
        if args.out is not None:
            (args.out / "chip_smoke_train.json").write_text(json.dumps(dict(
                card=card, device=name, kernels=records, train=train,
                durability=durable), indent=1, default=str))
        print(json.dumps({"durability": {k: durable[k] for k in (
            "losses_bitwise", "b_vs_a_max_rel", "c_vs_a_max_rel",
            "launches")}}))
        return 0
    probe = gemm_probe_phase(device)
    print(json.dumps({"probe": probe}), flush=True)
    silu = silu_probe_phase(device)
    if args.gemm_only:
        records = rows_kernel_phase(device, flush, peaks)
        records += w8a8_kernel_phase(device, flush, peaks)
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            (args.out / "chip_smoke_gemm.json").write_text(json.dumps(dict(
                card=card, device=name, probe=probe, silu_probe=silu,
                kernels=records), indent=1))
        print(json.dumps({"kernels": [{k: r.get(k) for k in (
            "name", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_share", "max_abs_err")} for r in records]}))
        return 0
    records = kernel_phase(pa, device, flush, peaks)
    records += flash_kernel_phase(device, flush, peaks)
    records += rows_kernel_phase(device, flush, peaks)
    records += w8a8_kernel_phase(device, flush, peaks)
    records += chaos_kernel_phase(pa, device, flush, peaks)
    del flush
    phase_done("3 kernels (with the probes)", t0)

    # Phase 4: serve.
    t0 = time.perf_counter()
    launches, serve = serve_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("4 serve", t0)

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out if args.out is not None else Path(tmp)
        out_dir.mkdir(parents=True, exist_ok=True)
        # Phase 4b: the Mixtral family, served and trained.
        t0 = time.perf_counter()
        mixtral_launches, mixtral = mixtral_phase(card, out_dir)
        phase_done("4b mixtral", t0)
        # Phase 5: train.
        t0 = time.perf_counter()
        train_launches, train = train_phase(card, out_dir)
        phase_done("5 train", t0)
        # Phase 6, distributed training on one card, runs beside the
        # durability arm B once arm A has ended (B mostly waits on the
        # disk; the two fit the card together).
        t0 = time.perf_counter()

        def phase_6():
            t6 = time.perf_counter()
            out = distributed_phase(card, out_dir,
                                    flash_report=train["report"],
                                    fused=False)
            gc.collect()
            torch.cuda.empty_cache()
            phase_done("6 distributed (beside durability arm B)", t6)
            return out

        train["durability"] = durable = durability_phase(
            card, out_dir, beside_b=phase_6)
        train["distributed"] = dist = durable.pop("beside")
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("5 durability arms (and phase 6 beside arm B)", t0)
        # The fused exchange's check, whose two states do not fit beside
        # a durability arm.
        t0 = time.perf_counter()
        dist["fused"] = fused_check(card)
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("6 distributed: the fused exchange", t0)
        # Phase 7: expert parallelism, a world of two ranks on the card.
        t0 = time.perf_counter()
        expert_launches, train["expert"] = expert_phase(card, out_dir)
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("7 expert", t0)
    # Phase 8: the workload chaos arms.
    t0 = time.perf_counter()
    chaos_launches_total, chaos = chaos_phase(card)
    phase_done("8 chaos (the world of one beside the arms)", t0)
    # Each kernel's launches on the serve runs of its page kind (the first
    # serve run and the bf16 runs for bf16 pages) or on training, and per
    # unit of that path: a decode tick, a verify tick, a prefill window, a
    # training step.
    ticks = {"paged_decode": ("decode_steps", "decode tick"),
             "paged_verify": ("verify_steps", "verify tick"),
             "paged_prefill": ("prefill_windows", "prefill window")}
    count = {"paged_decode": [launches["paged_decode"],
                              serve["decode_ticks"]],
             "paged_prefill": [launches["paged_prefill"],
                               serve["prefill_windows"]]}
    for run in serve["spec_quant_runs"]:
        suffix = "" if run["kind"] == "bf16" else f"_{run['kind']}"
        for k, (field, _) in ticks.items():
            c = count.setdefault(k + suffix, [0, 0])
            c[0] += run["launches"][k]
            c[1] += run[field]
    # The row-invariant kernels, per decode or verify tick or prefill
    # window (the GEMM: 4 L + 1 a tick or window) of every serve run
    # that is not W8A8 (a W8A8 run launches them no time).
    runs = serve["spec_quant_runs"]
    bf16_runs = [run for run in runs
                 if run["weights"][1] not in ("int8", "fp8")]
    for k in ("decode_gemm", "rms_norm", "add_rms_norm"):
        ticks[k] = (None, "decode or verify tick or prefill window")
        count[k] = [launches[k] + sum(run["launches"][k] for run in runs),
                    serve["decode_ticks"] + serve["prefill_windows"] + sum(
                        run["decode_steps"] + run["verify_steps"]
                        + run["prefill_windows"] for run in bf16_runs)]
    # The W8A8 kernels, on the W8A8 serve runs of their dtype.
    for k in ("quantize_rows", "rms_norm_quant", "add_rms_norm_quant",
              "swiglu_quant", "decode_gemm_w8a8"):
        ticks[k] = (None, "decode or verify tick or prefill window")
        for suffix, wd in (("", "int8"), ("_fp8", "fp8")):
            mine = [run for run in runs if run["weights"][1] == wd]
            count[k + suffix] = [
                sum(run["launches"][k] for run in mine),
                sum(run["decode_steps"] + run["verify_steps"]
                    + run["prefill_windows"] for run in mine)]
    # The wgmma GEMMs: launches of more than 64 rows, a window's groups.
    for k, suffixes in (("decode_gemm_wgmma", (("", "auto"),)),
                        ("decode_gemm_w8a8_wgmma",
                         (("", "int8"), ("_fp8", "fp8")))):
        for suffix, wd in suffixes:
            dtype = {"auto": torch.bfloat16, "int8": torch.int8,
                     "fp8": torch.float8_e4m3fn}[wd]
            every_m = _kernels.gemm_wgmma(dtype, 1)
            ticks[k] = (None, "decode or verify tick or prefill window"
                        if every_m else "prefill window")
            mine = [run for run in runs if run["weights"][1] == wd]
            first = (launches[k], serve["prefill_windows"] + every_m
                     * serve["decode_ticks"]) if wd == "auto" else (0, 0)
            count[k + suffix] = [
                first[0] + sum(run["launches"][k] for run in mine),
                first[1] + sum(run["prefill_windows"] + every_m * (
                    run["decode_steps"] + run["verify_steps"])
                    for run in mine)]
    count.update({k: [n, TRAIN_STEPS] for k, n in train_launches.items()})
    # Launches on the HTTP arms, each counted from zero: the paged kernels
    # on their arm's page kind (bf16 in A and C, int8 in B), the rest on
    # every arm.
    http = serve["http"]
    arm_kind = {"A": "bf16", "B": "int8", "C": "bf16"}
    for r in records:
        base = r["name"].removesuffix("_int8").removesuffix("_fp8")
        kind = r["name"][len(base) + 1:] or "bf16"
        r["http_launches"] = sum(
            http[arm]["launches"].get(base, 0)
            for arm, k in arm_kind.items()
            if base not in _kernels.PAGED_KERNELS or k == kind)
    for r in records:
        base = r["name"].removesuffix("_int8").removesuffix("_fp8")
        if base == r["name"] or base not in _kernels.PAGED_KERNELS:
            r["mixtral_launches"] = mixtral_launches.get(base, 0)
    for r in records:
        if r["name"] in durable["launches"]["A"]:
            r["durability_launches"] = {
                arm: launches[r["name"]]
                for arm, launches in durable["launches"].items()}
    for r in records:
        if r["name"] in dist["launches"]:
            r["distributed_launches"] = dist["launches"][r["name"]]
        if r["name"] in expert_launches:
            # The expert-2 world's and the GPipe world's, over their ranks.
            r["expert_launches"] = expert_launches[r["name"]]
    # The paged kernels at the chaos pools' shapes: their launches are
    # phase 8's (every chaos engine runs block size 4), per engine run.
    engine_runs = sum(1 for run in chaos["runs"]
                      if run["launches"].get("paged_decode")
                      and run["name"] != "engine-preempt-bs16")
    for k in _kernels.PAGED_KERNELS:
        ticks[k + "_bs4"] = (None, "engine arm run of phase 8")
        count[k + "_bs4"] = [chaos_launches_total[k], engine_runs]
    for r in records:
        if chaos_launches_total.get(r["name"]):
            r["chaos_launches"] = chaos_launches_total[r["name"]]
    for r in records:
        n, per = count[r["name"]]
        if not n:
            raise AssertionError(f"{r['name']}: launched no time on the "
                                 f"main path")
        base = r["name"].removesuffix("_int8").removesuffix("_fp8")
        r["launches"], r["launches_per_unit"] = n, n / per
        r["launches_per"] = ticks.get(base, (None, "training step"))[1]

    phase_done("total", t_start)
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(dict(
            card=card, device=name, build_s=build_s,
            phase_seconds=PHASE_SECONDS, health_probe=health, probe=probe,
            silu_probe=silu, kernels=records,
            serve=serve, mixtral=mixtral, train=train, chaos=chaos),
            indent=1, default=str))
    keys = ("name", "route", "source", "replaces", "variant", "launches",
            "launches_per_unit", "launches_per", "http_launches",
            "durability_launches", "mixtral_launches", "distributed_launches",
            "expert_launches", "chaos_launches",
            "max_abs_err", "ms",
            "plain_ms", "plain_note", "bound_ms",
            "bound_by", "bound_share", "achieved_tflops", "library_ms",
            "library_call")
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys}
                                  for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
