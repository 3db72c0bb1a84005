#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (``triton_kubernetes_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and runs these phases in
order; any failure raises and the script exits non-zero without printing a
result:

1. card   -- requires CUDA; prints ``nvidia-smi``'s name and power limit;
2. build  -- compiles the five kernels of ``csrc/`` (paged decode and
   prefill, flash forward, dQ and dK/dV) with ``nvcc`` for ``sm_90a``, all
   at once, and prints the seconds and what ``ptxas`` reports;
3. kernels -- each kernel against its plain PyTorch version at Llama-3-8B
   shapes (Hq 32, Hkv 8, D 128, bf16; paged: bs 16, 128 pages per
   sequence; flash: (B, S) = (4, 2048), (1, 1000), (1, 1280)), with its
   time, the plain version's, one ``scaled_dot_product_attention`` call's
   as a yardstick (the port never calls it), and the card's bound for the
   same work;
4. serve  -- ``ServeEngine`` on ``llama3-8b`` at full width and depth
   (random bf16 weights from a seed), chunked prefill with the prefix
   cache, 8 requests; checks completions, pool drain, prefix hits and that
   both kernels' launch counters rose by exactly (windows x layers) and
   (decode ticks x layers); prints TTFT, TPOT, tokens/s and tick times;
   cross-checks one greedy request's first-token logits against the plain
   versions (and an engine forced onto them); profiles a few decode ticks
   (device busy time by kernel class, idle share, launches per tick);
5. train  -- ``python -m triton_kubernetes_tpu_torch.train``'s ``main`` on
   ``llama3-8b`` at full width cut to 4 layers (fused CE, flash attention,
   bf16 policy, remat full), batch 4 x 2048, 6 AdamW steps; checks finite
   losses and gradient norms and the flash launch counters (forward 2 x 4
   layers a step, each backward kernel 4 a step); prints step times,
   tokens/s, MFU (the reference's formula), peak memory and the losses;
   profiles one step (device time by kernel class); cross-checks one
   step's loss and gradients at B 1, S 2048, kernels vs the plain flash
   versions, beside the noise floor of two plain paths (dense vs plain
   flash).

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. With ``--out DIR`` everything measured,
the per-offset prefill cases included, is also written to
``DIR/chip_smoke.json``, and the trainer's report to
``DIR/train_report.json``.
"""

from __future__ import annotations

import argparse
import gc
import json
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
# masters, full remat; batch 4 x 2048, 6 steps (2 warm-up).
TRAIN_MODEL, TRAIN_DEVICE = "llama3-8b", "cuda"
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 4, 4, 2048, 6, 2
TRAIN_ARGV = [
    "--model", TRAIN_MODEL, "--model-opt", f"num_layers={TRAIN_LAYERS}",
    "--model-opt", "fused_ce=true", "--model-opt", "attention=flash",
    "--precision", "bf16", "--remat-policy", "full",
    "--steps", str(TRAIN_STEPS), "--batch-size", str(TRAIN_BATCH),
    "--seq-len", str(TRAIN_SEQ), "--learning-rate", "3e-4",
    "--warmup-steps", "1", "--log-every", "1", "--device", TRAIN_DEVICE]
FLASH_SHAPES = [(4, 2048), (1, 1000), (1, 1280)]
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
PREFILL_CHUNK = 256
PREFILL_OFFSETS = [0, 256, 1024]
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


def card_peaks(name: str):
    for key in ("H200", "H100 NVL", "H100 PCIe"):
        if all(part in name for part in key.split()):
            return key, PEAKS[key]
    return "H100 SXM", PEAKS["H100 SXM"]


def time_ms(fn, flush: torch.Tensor, runs: int = 30, warmup: int = 3):
    """Median of ``runs`` CUDA-event timings of ``fn``, the 50 MB L2
    flushed before each (the serving path reads every layer's pages
    cold)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        flush.zero_()
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


def kernel_phase(pa, device, flush, peaks):
    """Both kernels against their plain versions; returns their records."""
    bw, flops_peak = peaks
    gen = torch.Generator(device=device).manual_seed(1234)
    records = []

    # ---- decode: B = 8 sequences at ragged lengths, own pages each.
    b = len(DECODE_LENGTHS)
    perm = torch.randperm(b * T, generator=torch.Generator().manual_seed(0))
    tables_cpu = (perm.reshape(b, T) + 1).to(torch.int32)
    for i, n in enumerate(DECODE_LENGTHS):  # unused entries -> trash page
        tables_cpu[i, (n + BS - 1) // BS:] = pa.TRASH_PAGE
    kp, vp = make_pool(gen, 1 + b * T,
                       [(n, tables_cpu[i].tolist())
                        for i, n in enumerate(DECODE_LENGTHS)], device)
    tables = tables_cpu.to(device)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=device)
    q = torch.randn((b, 1, HQ, D), generator=gen, device=device
                    ).to(torch.bfloat16)
    got = pa.ragged_paged_attention(q, kp, vp, tables, lengths, impl="cuda")
    want = pa.ragged_paged_attention(q, kp, vp, tables, lengths,
                                     impl="dense")
    torch.cuda.synchronize()
    err = check_close("paged_decode", got, want)
    if bool(got[0].any()):
        raise AssertionError("paged_decode: a length-0 slot must give 0")
    kms = time_ms(lambda: pa.ragged_paged_attention(
        q, kp, vp, tables, lengths, impl="cuda"), flush)
    pms = time_ms(lambda: pa.ragged_paged_attention(
        q, kp, vp, tables, lengths, impl="dense"), flush)
    group = HQ // HKV
    kk = pa.gather_pages(kp, tables).transpose(1, 2).repeat_interleave(
        group, dim=1)
    vv = pa.gather_pages(vp, tables).transpose(1, 2).repeat_interleave(
        group, dim=1)
    mask = (torch.arange(T * BS, device=device)[None, :]
            < lengths[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)
    lms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kk, vv, attn_mask=mask), flush)
    pages_read = sum((n + BS - 1) // BS for n in DECODE_LENGTHS)
    nbytes = (pages_read * BS * HKV * D * 2 * 2 + 2 * q.numel() * 2
              + tables.numel() * 4 + lengths.numel() * 4)
    flops = 4 * D * HQ * sum(DECODE_LENGTHS)
    bound = max(nbytes / bw, flops / flops_peak) * 1e3
    records.append(dict(
        name="paged_decode", route="cuda",
        source="triton_kubernetes_tpu_torch/csrc/paged_decode.cu",
        replaces="triton_kubernetes_tpu/ops/paged_attention.py:461",
        max_abs_err=err, tolerance=f"{ATOL} + {RTOL} * |plain|",
        ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bound,
        library_call="scaled_dot_product_attention over the gathered "
                     "pages with a length mask",
        bound_by="bytes" if nbytes / bw >= flops / flops_peak
        else "operations",
        bytes=nbytes, flops=flops,
        shape=dict(B=b, Hq=HQ, Hkv=HKV, D=D, bs=BS, T=T,
                   lengths=DECODE_LENGTHS)))

    # ---- prefill: one C = 256 window at three offsets.
    cases = []
    for off in PREFILL_OFFSETS:
        total = off + PREFILL_CHUNK
        table_cpu = (torch.randperm(T, generator=torch.Generator()
                                    .manual_seed(off)) + 1).to(torch.int32)
        kp, vp = make_pool(gen, 1 + T, [(total, table_cpu.tolist())], device)
        table = table_cpu.to(device)
        q = torch.randn((1, PREFILL_CHUNK, HQ, D), generator=gen,
                        device=device).to(torch.bfloat16)
        got = pa.paged_prefill_attention(q, kp, vp, table, off, impl="cuda")
        want = pa.paged_prefill_attention(q, kp, vp, table, off,
                                          impl="dense")
        torch.cuda.synchronize()
        err = check_close(f"paged_prefill@{off}", got, want)
        kms = time_ms(lambda: pa.paged_prefill_attention(
            q, kp, vp, table, off, impl="cuda"), flush)
        pms = time_ms(lambda: pa.paged_prefill_attention(
            q, kp, vp, table, off, impl="dense"), flush)
        kk = pa.gather_pages(kp, table[None]).transpose(1, 2)
        vv = pa.gather_pages(vp, table[None]).transpose(1, 2)
        kk = kk.repeat_interleave(HQ // HKV, dim=1)
        vv = vv.repeat_interleave(HQ // HKV, dim=1)
        qpos = off + torch.arange(PREFILL_CHUNK, device=device)
        mask = (torch.arange(T * BS, device=device)[None, :]
                <= qpos[:, None])[None, None]
        qs = q.transpose(1, 2)
        lms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kk, vv, attn_mask=mask), flush)
        keys = sum(off + i + 1 for i in range(PREFILL_CHUNK))
        flops = 4 * D * HQ * keys
        nbytes = (((total + BS - 1) // BS) * BS * HKV * D * 2 * 2
                  + 2 * q.numel() * 2 + table.numel() * 4)
        cases.append(dict(offset=off, max_abs_err=err, ms=kms, plain_ms=pms,
                          library_ms=lms, flops=flops, bytes=nbytes,
                          bound_ms=max(flops / flops_peak, nbytes / bw) * 1e3))
    flops = sum(c["flops"] for c in cases)
    nbytes = sum(c["bytes"] for c in cases)
    records.append(dict(
        name="paged_prefill", route="cuda",
        source="triton_kubernetes_tpu_torch/csrc/paged_prefill.cu",
        replaces="triton_kubernetes_tpu/ops/paged_attention.py:633",
        max_abs_err=max(c["max_abs_err"] for c in cases),
        tolerance=f"{ATOL} + {RTOL} * |plain|",
        ms=sum(c["ms"] for c in cases),
        plain_ms=sum(c["plain_ms"] for c in cases),
        library_ms=sum(c["library_ms"] for c in cases),
        library_call="scaled_dot_product_attention over the gathered "
                     "pages with a causal mask at the window's offset",
        bound_ms=sum(c["bound_ms"] for c in cases),
        bound_by="operations" if flops / flops_peak >= nbytes / bw
        else "bytes",
        bytes=nbytes, flops=flops,
        shape=dict(C=PREFILL_CHUNK, Hq=HQ, Hkv=HKV, D=D, bs=BS, T=T,
                   offsets=PREFILL_OFFSETS, summed_over="offsets"),
        cases=cases))
    for r in records:
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.6g} "
              f"(tolerance {r['tolerance']}) kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})", flush=True)
    return records


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
        reqs.append(Request(f"r{i}", toks, 32, **sampled))
    return reqs


def first_token_logits(model, cfg, prompt, impl, paged):
    """Logits at a prompt's last token through all its prefill windows,
    on a fresh pool, with the given attention impl."""
    windows = -(-len(prompt) // PREFILL_CHUNK)
    pages = windows * PREFILL_CHUNK // BS
    cache = paged.init_paged_cache(cfg, pages + 1, BS, device="cuda")
    table = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        for off in range(0, len(prompt), PREFILL_CHUNK):
            clen = min(PREFILL_CHUNK, len(prompt) - off)
            toks = prompt[off:off + clen] + [0] * (PREFILL_CHUNK - clen)
            logits = paged.paged_prefill_chunk(
                model, torch.tensor([toks], dtype=torch.int32, device="cuda"),
                off, clen, cfg, cache, table, attention_impl=impl)
    return logits


def profile_decode(engine, cfg, Request, ticks=4):
    """Where a decode tick's time goes: 8 sequences of 600-token prompts
    decoding, ``ticks`` decode-only ticks under torch.profiler. Returns
    wall and device-busy milliseconds per tick, the device's idle share,
    kernel launches per tick, and device time by kernel class."""
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    engine.run_until_idle()
    events = prof.events()
    launches = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                              "cuLaunchKernelEx") for e in events)
    by_class = {"paged_decode kernel": 0.0, "GEMM (cuBLAS)": 0.0,
                "other kernels": 0.0}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        if "paged_decode_kernel" in e.name:
            by_class["paged_decode kernel"] += us
        elif e.name.startswith(("nvjet", "sm90_xmma", "cutlass")) \
                or "gemm" in e.name.lower():
            by_class["GEMM (cuBLAS)"] += us
        else:
            by_class["other kernels"] += us
    by_class = {k: v / 1e3 / ticks for k, v in by_class.items()}
    busy_ms = sum(by_class.values())
    return dict(wall_ms_per_tick=wall_ms, device_busy_ms_per_tick=busy_ms,
                device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
                launches_per_tick=launches / ticks,
                device_ms_per_tick_by_class=by_class)


def serve_phase(card):
    from triton_kubernetes_tpu_torch.models import get_config, init_params
    from triton_kubernetes_tpu_torch.models import paged
    from triton_kubernetes_tpu_torch.ops import paged_attention as pa
    from triton_kubernetes_tpu_torch.serve import Request, ServeEngine
    from triton_kubernetes_tpu_torch.utils import metrics

    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"serve: llama3-8b {cfg.num_layers} layers, width {cfg.embed_dim},"
          f" vocab {cfg.vocab_size}: {cfg.num_params() / 1e9:.3f}B bf16 "
          f"params initialised in {time.perf_counter() - t0:.1f} s", flush=True)
    engine_kw = dict(block_size=BS, num_blocks=2048, max_batch=8,
                     max_model_len=2048, prefill_chunk=PREFILL_CHUNK,
                     prefix_cache=True)
    engine = ServeEngine(model, cfg, **engine_kw)

    # Warm-up (cuBLAS handles, first launches), then a clean slate.
    engine.submit(Request("warmup", list(range(1, 65)), 2))
    engine.run_until_idle()
    engine.release_prefix_cache()
    metrics.configure()
    base = engine.stats()
    requests = make_requests(cfg, Request)
    arrivals = {0: [0, 4, 5], 5: [1, 2, 3], 6: [6, 7]}

    pa.reset_launch_counts()
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
    wall = time.perf_counter() - t0
    launches = {"paged_decode": pa.ragged_paged_attention.launches,
                "paged_prefill": pa.paged_prefill_attention.launches}
    stats = engine.stats()
    windows = stats["prefill_windows"] - base["prefill_windows"]
    ticks = stats["decode_steps"] - base["decode_steps"]

    for r in requests:
        d = done[r.request_id]
        if len(d.tokens) != 32 or d.finish_reason != "length":
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
            "paged_decode": ticks * cfg.num_layers}
    if launches != want or not all(launches.values()):
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
    dense.submit(Request(probe.request_id, list(probe.tokens), 32))
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
          f" (plain top-2 gap {gap:.5f}); {same}/32 tokens equal to the "
          f"plain-version engine", flush=True)
    prof = profile_decode(engine, cfg, Request)
    if prof["device_idle_share"] is None:
        print("serve: decode tick profile: the profiler saw no device "
              "kernels; device time not measured", flush=True)
    else:
        classes = ", ".join(f"{k} {v:.3f} ms" for k, v in
                            prof["device_ms_per_tick_by_class"].items())
        print(f"serve: decode tick (8 x ~600-token contexts) profiled: wall "
              f"{prof['wall_ms_per_tick']:.3f} ms, device busy "
              f"{prof['device_busy_ms_per_tick']:.3f} ms (idle share "
              f"{prof['device_idle_share']:.3f}), "
              f"{prof['launches_per_tick']:.0f} launches; {classes} "
              f"[{card}]", flush=True)
    return launches, dict(
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
        decode_tick_profile=prof,
        tokens_equal_to_plain_engine=same,
        peak_memory_bytes=torch.cuda.max_memory_allocated())


def flash_kernel_phase(device, flush, peaks):
    """Kernels 1-3 against their plain versions at Llama-3-8B heads;
    timed at the training shape (B 4, S 2048). Returns their records."""
    from triton_kubernetes_tpu_torch.ops import _kernels
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa

    bw, flops_peak = peaks
    gen = torch.Generator(device=device).manual_seed(4321)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    errs = {name: 0.0 for name in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv")}
    lse_err = 0.0
    timed = {}
    for b, s in FLASH_SHAPES:
        def rnd(h):
            return torch.randn((b, s, h, D), generator=gen, device=device
                               ).to(torch.bfloat16)
        q, k, v, do = rnd(HQ), rnd(HKV), rnd(HKV), rnd(HQ)
        out, lse = _kernels.flash_fwd(q, k, v)
        want_out, want_lse = fa._flash_forward_plain(q, k, v,
                                                     fa.KERNEL_BLOCK_K)
        dvec = fa._row_dot(do, out)
        dq = _kernels.flash_bwd_dq(q, k, v, do, lse, dvec)
        dk, dv = _kernels.flash_bwd_dkv(q, k, v, do, lse, dvec)
        want_dq, want_dk, want_dv = fa._flash_backward_plain(q, k, v, do,
                                                             lse, dvec)
        torch.cuda.synchronize()
        tag = f"B={b},S={s}"
        errs["flash_fwd"] = max(errs["flash_fwd"], check_close(
            f"flash_fwd out {tag}", out, want_out))
        worst_lse = float((lse - want_lse).abs().max())
        if not worst_lse <= LSE_ATOL:
            raise AssertionError(f"flash_fwd lse {tag}: max abs err "
                                 f"{worst_lse} > {LSE_ATOL}")
        lse_err = max(lse_err, worst_lse)
        errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], check_close(
            f"flash_bwd_dq {tag}", dq, want_dq))
        errs["flash_bwd_dkv"] = max(
            errs["flash_bwd_dkv"],
            check_close(f"flash_bwd_dkv dk {tag}", dk, want_dk),
            check_close(f"flash_bwd_dkv dv {tag}", dv, want_dv))
        del want_out, want_lse, want_dq, want_dk, want_dv
        if (b, s) != (TRAIN_BATCH, TRAIN_SEQ):
            continue
        # Timing at the training shape. The plain versions materialise
        # [B, Hq, S, S] f32 scores: median of 5 runs for them.
        timed["flash_fwd"] = (
            time_ms(lambda: _kernels.flash_fwd(q, k, v), flush),
            time_ms(lambda: fa._flash_forward_plain(q, k, v,
                                                    fa.KERNEL_BLOCK_K),
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
    records = []
    for name, (flops, nbytes) in work.items():
        kms, pms = timed[name]
        records.append(dict(
            name=name, route="cuda",
            source=f"triton_kubernetes_tpu_torch/csrc/{name}.cu",
            replaces=f"triton_kubernetes_tpu/ops/flash_attention.py:"
                     f"{lines[name]}",
            max_abs_err=errs[name],
            tolerance=f"{ATOL} + {RTOL} * |plain|",
            ms=kms, plain_ms=pms,
            library_ms=lib_fwd if name == "flash_fwd" else lib_bwd,
            library_call=("scaled_dot_product_attention(is_causal, "
                          "enable_gqa) forward" if name == "flash_fwd" else
                          "the same call's backward (dq, dk and dv "
                          "together)"),
            bound_ms=max(flops / flops_peak, nbytes / bw) * 1e3,
            bound_by="operations" if flops / flops_peak >= nbytes / bw
            else "bytes",
            flops=flops, bytes=nbytes,
            shape=dict(B=b, S=s, Hq=HQ, Hkv=HKV, D=D,
                       checked_at=FLASH_SHAPES)))
    records[0]["lse_max_abs_err"] = lse_err
    # The plain backward computes dq, dk and dv in one pass: its time is
    # recorded once, on the dK/dV row, and the dQ row shares it.
    records[1]["plain_ms"] = records[2]["plain_ms"]
    records[1]["plain_note"] = "one plain pass computes dq, dk and dv"
    records[2]["plain_note"] = records[1]["plain_note"]
    for r in records:
        print(f"kernel {r['name']} (B={b}, S={s}): max_abs_err="
              f"{r['max_abs_err']:.6g} (tolerance {r['tolerance']}) "
              f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} bound_ms="
              f"{r['bound_ms']:.5f} ({r['bound_by']})", flush=True)
    print(f"kernel flash_fwd: lse max abs err {lse_err:.3g} (bound "
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


def step_cross_check(state, cfg):
    """One step's loss and gradients at B 1, S 2048 on the same weights
    and batch: flash kernels, plain flash versions, dense attention."""
    from triton_kubernetes_tpu_torch.models import llama
    from triton_kubernetes_tpu_torch.ops import flash_attention as fa
    from triton_kubernetes_tpu_torch.train import loss_fn, synthetic_batches

    model = state.model
    params = list(model.parameters())
    tokens = torch.from_numpy(next(synthetic_batches(
        cfg.vocab_size, 1, TRAIN_SEQ, seed=99))["tokens"]).to(model.device)
    arms = {"kernels": llama.resolve_attention(cfg, model.device),
            "plain flash": lambda q, k, v, pos: fa.flash_attention_plain(
                q, k, v),
            "dense": llama._dense_attention}
    results = {}
    for arm, attn in arms.items():
        for p in params:
            p.grad = None
        total, metrics = loss_fn(model, tokens, cfg, attn)
        total.backward()
        results[arm] = (float(metrics["loss"]), [p.grad for p in params])
    for p in params:
        p.grad = None
    torch.cuda.synchronize()

    def compare(a, b):
        (la, ga), (lb, gb) = results[a], results[b]
        return (abs(la - lb) / abs(lb),
                max(rel_l2(x, y) for x, y in zip(ga, gb)))

    loss_rel, grad_rel = compare("kernels", "plain flash")
    floor_loss, floor_grad = compare("dense", "plain flash")
    out = dict(loss_kernels=results["kernels"][0],
               loss_plain_flash=results["plain flash"][0],
               loss_dense=results["dense"][0],
               loss_rel_diff=loss_rel, grad_max_rel_l2=grad_rel,
               floor_loss_rel_diff=floor_loss, floor_grad_max_rel_l2=floor_grad)
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

    report_path = out_dir / "train_report.json"
    fa.reset_launch_counts()
    rc = train_main.main(TRAIN_ARGV + ["--report-json", str(report_path)])
    launches = dict(fa.flash_attention.launches)
    if rc != 0:
        raise AssertionError(f"trainer exited {rc}")
    rep = json.loads(report_path.read_text())
    vals = rep["losses"] + rep["grad_norms"]
    if rep["steps"] != TRAIN_STEPS or not all(np.isfinite(vals)):
        raise AssertionError(f"trainer: {rep['steps']} steps, losses "
                             f"{rep['losses']}, grad norms "
                             f"{rep['grad_norms']}")
    want = {"flash_fwd": 2 * TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dq": TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dkv": TRAIN_LAYERS * TRAIN_STEPS}
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
    check = step_cross_check(state, cfg)
    print(f"train: step at B 1, S {TRAIN_SEQ}, kernels vs plain flash: "
          f"loss {check['loss_kernels']:.6f} vs "
          f"{check['loss_plain_flash']:.6f} (rel diff "
          f"{check['loss_rel_diff']:.3g}, bound {STEP_LOSS_REL}), worst "
          f"gradient leaf rel L2 {check['grad_max_rel_l2']:.4g} (bound "
          f"{STEP_GRAD_REL_L2}); two plain paths (dense vs plain flash) "
          f"differ by {check['floor_loss_rel_diff']:.3g} in loss and "
          f"{check['floor_grad_max_rel_l2']:.4g} in the worst leaf",
          flush=True)
    return launches, dict(report=rep, step_seconds=step_s,
                          steady_tokens_per_sec=tps, mfu=mfu,
                          launches=launches, profile=prof,
                          cross_check=check)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None,
                        help="directory for chip_smoke.json")
    args = parser.parse_args()
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

    # Phase 2: build, every source at once.
    t0 = time.perf_counter()
    logs = _kernels.build()
    for kernel in _kernels.KERNELS:
        _kernels.library(kernel)
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(_kernels.KERNELS)} in {build_s:.1f} s", flush=True)
    for kernel, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {kernel}: {line.strip()}", flush=True)

    # Phase 3: kernels against their plain versions.
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    records = kernel_phase(pa, device, flush, peaks)
    records += flash_kernel_phase(device, flush, peaks)
    del flush

    # Phase 4: serve.
    launches, serve = serve_phase(card)
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 5: train.
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out if args.out is not None else Path(tmp)
        out_dir.mkdir(parents=True, exist_ok=True)
        train_launches, train = train_phase(card, out_dir)
    launches.update(train_launches)
    # Launches per unit of the main path: a decode tick, a prefill window,
    # a training step.
    per = {"paged_decode": ("decode tick", serve["decode_ticks"]),
           "paged_prefill": ("prefill window", serve["prefill_windows"])}
    for r in records:
        r["launches"] = launches[r["name"]]
        unit, n = per.get(r["name"], ("training step", TRAIN_STEPS))
        r["launches_per"] = unit
        r["launches_per_unit"] = r["launches"] / n

    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(dict(
            card=card, device=name, build_s=build_s, kernels=records,
            serve=serve, train=train), indent=1))
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_per_unit", "launches_per", "max_abs_err", "ms",
            "plain_ms", "plain_note", "bound_ms", "bound_by", "library_ms",
            "library_call")
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys}
                                  for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
