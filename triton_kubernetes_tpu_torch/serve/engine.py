"""Continuous-batching scheduler over the paged KV cache -- the port of
``triton_kubernetes_tpu/serve/engine.py``.

One :meth:`ServeEngine.step` is one scheduler tick:

1. **admit** -- pop waiting requests while a decode slot and enough KV
   pages exist. Without ``prefill_chunk`` each admit runs the whole-prompt
   paged prefill and samples the first token. With ``prefill_chunk`` set,
   admission only allocates pages (plus a prefix-cache lookup when sharing
   is on) and prefill compute moves to step 2;
2. **chunked prefill** -- ONE ``prefill_chunk``-token window of the oldest
   still-prefilling sequence per tick, interleaved with decode. Windows are
   absolute (window ``j`` covers prompt tokens ``[j*C, (j+1)*C)``); with
   ``prefix_cache=True`` windows whose pages the radix index already holds
   are skipped outright. The first token is sampled when the last window
   lands;
3. **grow/preempt** -- every decoding sequence gets the page its next
   token needs; when the pool is dry, unreferenced prefix-cache pages are
   evicted first, then the latest-admitted sequence is preempted (pages
   freed, sequence back at the queue front, re-prefilled later from prompt
   + tokens so far);
4. **decode** -- ONE batched ragged decode step for all fully prefilled
   sequences (always ``max_batch`` wide; empty and still-prefilling slots
   ride the trash page), then per-sequence sampling, completion checks and
   page frees. With ``spec_k > 0`` the step widens into a **speculative
   verify**: each sequence's n-gram self-drafter (``serve/speculation.py``)
   proposes up to ``spec_k`` tokens from its own history, pages for them
   are allocated only from what is free after every sequence's mandatory
   growth, ``models.paged.paged_verify_step`` scores all ``spec_k + 1``
   positions in one pass (one weight read), acceptance keeps the longest
   prefix the request's own (seed, position)-keyed samples agree with, and
   the KV writes of rejected tokens are rolled back (``paged_rewind``)
   before any page is freed. A tick where nothing was drafted runs the
   plain decode step.

The scheduler is deterministic: the clock is injectable (:class:`ManualClock`
for tests), allocation is lowest-index-first, admission FIFO, preemption
latest-admitted-first, and each request samples position ``n`` with a
``torch.Generator`` seeded from ``(request.seed, n)`` -- never from batch
composition -- so a request's output is the same solo or batched.

The page pool is written in place by the model functions
(``models/paged.py``). Attention runs the hand-written CUDA kernels when
the model lives on a card; a config with ``attention="dense"`` forces the
plain versions (a reference engine).

``kv_dtype`` "int8"/"fp8" stores the pool quantized (anchored per-page
scales); the quantized kernels dequantize as they read, and each prompt's
final prefill sets the ``tk8s_serve_quant_error`` gauges.

``weight_dtype`` "int8"/"fp8" quantizes the model per channel when the
engine is built (``train.precision.quantize_for_decode``: a new model, the
caller's untouched), and ``matmul_dtype`` picks the arithmetic: "auto"
(the dequantize path off a TPU, as in the reference) or "f32" dequantize
each weight at its use; "int8"/"fp8" (which need weights stored so) run
W8A8 -- each product's input quantized per token, the hand-written int8 or
fp8 GEMM on the card.

Tracing: ``flight=`` takes a :class:`~..utils.trace.FlightRecorder`, which
records each request's lifecycle (the same events, at the same clock reads,
as the JAX engine) and folds it into ``FinishedRequest.phases``; with a
``TraceWriter`` on the recorder each tick also lands as a ``serve.step``
span. ``engine.goodput`` takes a ``GoodputRecorder("serve")``, into which
every tick books its compute (prefill/decode/verify/recompute, migration)
with the rest of the wall window falling to idle. Both read host time: on a
card a phase's attribution follows where the host blocks (the token read in
sampling), and neither adds a device synchronization. With ``flight=None``
and no goodput the engine reads the clock no more often than untraced.

Migration (``serve/migration.py``): a ``handoff`` request finishes right
after its first token with its pages parked; ``export_session`` packs a
parked or live decoding session into the wire unit (one indexed read of the
pool and one device-to-host copy a component), ``import_session`` verifies
and installs one (one host-to-device copy and one indexed write a
component, into fresh pages only: pages the local prefix cache already
holds for the same tokens are shared by reference), ``release_session`` /
``resume_session`` settle the source after the transfer succeeded or
failed.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..constants import KV_DTYPES, MATMUL_DTYPES
from ..models.config import ModelConfig
from ..models.generate import sample_token
from ..models.llama import Llama, resolve_device
from ..models.paged import (
    init_paged_cache,
    paged_decode_step,
    paged_prefill,
    paged_prefill_chunk,
    paged_rewind,
    paged_verify_step,
)
from ..ops.paged_attention import TRASH_PAGE, blocks_for, byte_view
from ..train.precision import quantize_for_decode
from ..utils import metrics
from ..utils.trace import FlightRecorder
from .blocks import BlockAllocator, OutOfBlocksError, PrefixCache
from .migration import (
    MigrationError,
    TornPayloadError,
    check_compatible,
    dtype_name,
    pack_session,
    unpack_session,
)
from .speculation import draft_ngram, longest_agreeing_prefix

# Ticks of pool-utilization history behind the stats() kv_pressure signal.
_PRESSURE_WINDOW = 32


class ManualClock:
    """Deterministic injectable clock: advances only when told to."""

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self.now = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        t = self.now
        self.now += self.tick
        return t

    def advance(self, dt: float) -> None:
        self.now += dt


@dataclass
class Request:
    """One generation request. ``seed`` keys this request's sampling
    stream independently of batch composition (solo == batched).
    ``trace_id`` is the fleet-wide correlation id (None falls back to the
    request id in the flight recorder)."""

    request_id: str
    tokens: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    seed: int = 0
    trace_id: Optional[str] = None
    # Disaggregated prefill/decode: a handoff request finishes right after
    # its first token (finish_reason "handoff") with its KV pages PARKED for
    # export_session instead of freed.
    handoff: bool = False


@dataclass
class FinishedRequest:
    request_id: str
    prompt_len: int
    tokens: List[int]  # generated only
    finish_reason: str  # "eos" | "length" | "handoff" | "migrated"
    submitted_at: float
    first_token_at: float
    finished_at: float
    preemptions: int = 0
    # Tracing ride-alongs (None with the flight recorder off): the trace id
    # and the per-phase latency attribution (the phases sum to e2e).
    trace_id: Optional[str] = None
    phases: Optional[Dict[str, float]] = None
    spec: Optional[Dict[str, int]] = None
    # Where a "migrated" session now lives, for a caller that follows it
    # (the HTTP layer sets these).
    migrated_to: Optional[str] = None
    dest_request_id: Optional[str] = None

    @property
    def ttft(self) -> float:
        return self.first_token_at - self.submitted_at

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first."""
        n = len(self.tokens) - 1
        if n <= 0:
            return 0.0
        return (self.finished_at - self.first_token_at) / n


@dataclass
class _Sequence:
    """A request plus its scheduling state -- in the waiting queue
    (no pages) or in a decode slot (pages allocated)."""

    request: Request
    submitted_at: float
    generated: List[int] = field(default_factory=list)
    first_token_at: Optional[float] = None
    preemptions: int = 0
    pages: List[int] = field(default_factory=list)
    admit_seq: int = -1  # admission order; preemption evicts the highest
    # Prefill progress: tokens of the teacher-forced prompt already in
    # pages vs its full length. prefilled == target means decoding.
    prefilled: int = 0
    target: int = 0
    # This tick's self-drafted proposal (spec_k > 0): made during page
    # growth, consumed by the verify, dropped on preemption.
    draft: List[int] = field(default_factory=list)
    # Migration state: handed_off -- the lifecycle closed with a "handoff"
    # FinishedRequest (pages parked for export); imported -- it arrived
    # through import_session (its TTFT was measured on the source);
    # migrate_reason -- the reason label its migration counters carry.
    handed_off: bool = False
    imported: bool = False
    migrate_reason: str = ""

    @property
    def length(self) -> int:
        """Tokens written to pages so far (the latest generated token is
        sampled but unwritten: it is the next decode's input)."""
        return len(self.request.tokens) + max(0, len(self.generated) - 1)


def _sample_generator(seed: int, position: int,
                      device: torch.device) -> torch.Generator:
    """The generator of one (request seed, position) draw."""
    mixed = np.random.SeedSequence(
        [seed & 0xFFFFFFFFFFFFFFFF, position]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) >> 1)


class ServeEngine:
    """Continuous batching over one model replica.

    Not thread-safe: one owner calls ``submit``/``step``.
    """

    def __init__(
        self,
        params: Llama,
        config: ModelConfig,
        *,
        block_size: int = 16,
        num_blocks: int = 64,
        max_batch: int = 4,
        max_model_len: Optional[int] = None,
        sequential: bool = False,
        kv_dtype: str = "auto",
        weight_dtype: str = "auto",
        matmul_dtype: str = "auto",
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = False,
        spec_k: int = 0,
        clock: Callable[[], float] = time.monotonic,
        flight: Optional[FlightRecorder] = None,
        device: torch.device | str = "cuda",
    ):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        if matmul_dtype not in MATMUL_DTYPES:
            raise ValueError(
                f"matmul_dtype must be one of {MATMUL_DTYPES}, got "
                f"{matmul_dtype!r}")
        if prefill_chunk is not None and (
                prefill_chunk < block_size
                or prefill_chunk % block_size != 0):
            raise ValueError(
                f"prefill_chunk must be a positive multiple of the block "
                f"size {block_size}, got {prefill_chunk}")
        if prefix_cache and prefill_chunk is None:
            raise ValueError(
                "prefix_cache requires prefill_chunk: prefix reuse skips "
                "whole chunk windows (the absolute-window alignment is "
                "what keeps sharing ON/OFF outputs identical)")
        dev = resolve_device(device)
        if params.device.type != dev.type or (
                dev.index is not None and params.device.index != dev.index):
            raise ValueError(
                f"the model lives on {params.device}, the engine was asked "
                f"to run on {dev}")
        self.device = params.device
        # The weight policy first, model and config rewritten as one; the
        # arithmetic after it, so that ModelConfig checks an explicit
        # int8/fp8 against the storage just set (raising at init, never a
        # silently dequantizing engine).
        params, config = quantize_for_decode(params, config, weight_dtype)
        config = replace(config, matmul_dtype=matmul_dtype)
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        self.matmul_dtype = matmul_dtype
        self.config = config
        self.params = params
        self.block_size = block_size
        self.max_batch = max_batch
        self.max_model_len = min(max_model_len or config.max_seq_len,
                                 config.max_seq_len)
        self.sequential = sequential
        self.prefill_chunk = prefill_chunk
        self.spec_k = spec_k
        self.clock = clock
        # Optional per-request lifecycle recorder. None means no tracing
        # work and no extra clock() reads: the untraced engine is unchanged.
        self.flight = flight
        # Optional process-level goodput ledger (GoodputRecorder, source
        # "serve"), attached after construction; opt-in for the same reason.
        self.goodput: Optional[Any] = None
        # One table width serves prefill and decode: enough pages for a
        # full-length sequence -- under chunked prefill padded up to whole
        # chunk windows, so every absolute window sits inside the table.
        self.blocks_per_seq = blocks_for(self.max_model_len, block_size)
        if prefill_chunk is not None:
            per_window = prefill_chunk // block_size
            self.blocks_per_seq = (
                -(-self.blocks_per_seq // per_window) * per_window)
        self.prefill_width = self.blocks_per_seq * block_size
        self.allocator = BlockAllocator(num_blocks)
        self.prefix = (PrefixCache(self.allocator, block_size)
                       if prefix_cache else None)
        self.cache = init_paged_cache(config, num_blocks, block_size,
                                      kv_dtype=kv_dtype, device=self.device)
        self.waiting: Deque[_Sequence] = deque()
        self.slots: List[Optional[_Sequence]] = [None] * max_batch
        # Sessions frozen out of the scheduler with their pages intact:
        # handed-off sequences awaiting export, and live sequences
        # mid-migration (a torn transfer resumes them via resume_session).
        self.parked: Dict[str, _Sequence] = {}
        self._admit_counter = 0
        self._steps = 0
        self._prefill_windows = 0
        self._decode_steps = 0
        self._verify_steps = 0
        self._pressure_samples: Deque[float] = deque(
            maxlen=_PRESSURE_WINDOW)
        metrics.gauge("tk8s_serve_kv_bytes").set(
            self.cache.pool_bytes, component="pages")
        metrics.gauge("tk8s_serve_kv_bytes").set(
            self.cache.scale_bytes, component="scales")

    def _tensor(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------ intake
    def validate_request(self, request: Request) -> None:
        """Raise ValueError for a request this engine can never serve.
        Pure (no state change)."""
        n = len(request.tokens)
        if n < 1:
            raise ValueError(f"{request.request_id}: empty prompt")
        bad = next((t for t in request.tokens
                    if not 0 <= t < self.config.vocab_size), None)
        if bad is not None:
            raise ValueError(
                f"{request.request_id}: token id {bad} outside the "
                f"model vocabulary [0, {self.config.vocab_size})")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"{request.request_id}: max_new_tokens must be >= 1")
        total = n + request.max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"{request.request_id}: prompt ({n}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds max_model_len "
                f"({self.max_model_len})")
        if blocks_for(total, self.block_size) > self.allocator.capacity:
            raise ValueError(
                f"{request.request_id}: needs "
                f"{blocks_for(total, self.block_size)} KV blocks, pool "
                f"capacity is {self.allocator.capacity}")

    def submit(self, request: Request) -> None:
        self.validate_request(request)
        t = self.clock()
        self.waiting.append(_Sequence(request, submitted_at=t))
        if self.flight is not None:
            # One shared clock read: the queue phase starts at exactly the
            # submitted_at the TTFT math uses.
            self.flight.begin(request.request_id, request.trace_id, t)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    @property
    def num_running(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    # ----------------------------------------------------------- stepping
    def step(self) -> List[FinishedRequest]:
        """One scheduler tick; returns requests that completed in it."""
        # Tick spans only when a JSONL writer rides along; the recorder
        # alone never pays the extra clock reads.
        tick_span = (self.flight is not None
                     and self.flight.writer is not None)
        t0 = self.clock() if tick_span else 0.0
        finished: List[FinishedRequest] = []
        with torch.inference_mode():
            self._admit(finished)
            if self.prefill_chunk is not None:
                self._prefill_tick(finished)
            self._ensure_growth_pages()
            if any(s is not None and s.prefilled >= s.target
                   for s in self.slots):
                if self.spec_k > 0:
                    self._spec_decode_once(finished)
                else:
                    self._decode_once(finished)
        self._steps += 1
        self._update_gauges()
        if self.goodput is not None:
            # Close the tick's last compute segment: whatever follows is
            # idle time.
            self.goodput.transition("idle")
        if tick_span:
            self.flight.step(t0, self.clock() - t0, len(finished))
        return finished

    def run_until_idle(self, max_steps: int = 100_000,
                       ) -> List[FinishedRequest]:
        out: List[FinishedRequest] = []
        steps = 0
        while self.has_work:
            out.extend(self.step())
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"engine did not drain in {max_steps} steps "
                    f"(waiting={len(self.waiting)}, "
                    f"running={self.num_running})")
        return out

    # ------------------------------------------------------------- admit
    def _admit(self, finished: List[FinishedRequest]) -> None:
        while self.waiting:
            if self.sequential and self.num_running:
                return
            slot = next((i for i, s in enumerate(self.slots) if s is None),
                        None)
            if slot is None:
                return
            seq = self.waiting[0]
            if seq.pages:
                # A resumed or imported session: its pages hold the whole
                # history, so admission only grants the slot and it rejoins
                # decode directly.
                self.waiting.popleft()
                seq.admit_seq = self._admit_counter
                self._admit_counter += 1
                self.slots[slot] = seq
                if self.flight is not None:
                    now = self.clock()
                    rid = seq.request.request_id
                    self.flight.event(rid, "serve.admitted", now,
                                      slot=slot, reused_pages=0,
                                      recompute=False, deferred=True)
                    self.flight.event(rid, "serve.resume", now)
                continue
            prompt = list(seq.request.tokens) + list(seq.generated)
            need = blocks_for(len(prompt), self.block_size)
            reuse: List[int] = []
            if self.prefix is not None:
                reuse = self._reusable_pages(prompt)
                # Hold the reused pages BEFORE eviction can run: a page
                # at refcount 1 (cache-only) is eviction's prey.
                self.allocator.incref(reuse)
            fresh = need - len(reuse)
            shortfall = fresh - self.allocator.available
            if shortfall > 0 and self.prefix is not None \
                    and self.prefix.evictable() >= shortfall:
                # Evict only when eviction actually closes the gap.
                self.prefix.evict(shortfall)
            if fresh > self.allocator.available:
                if reuse:
                    self.allocator.free(reuse)
                return  # pool pressure: wait for frees, keep FIFO order
            self.waiting.popleft()
            seq.pages = reuse + self.allocator.alloc(fresh)
            seq.admit_seq = self._admit_counter
            self._admit_counter += 1
            seq.target = len(prompt)
            seq.prefilled = len(reuse) * self.block_size
            self.slots[slot] = seq
            if self.flight is not None:
                # recompute=True re-prefills a preempted sequence's own
                # history; deferred=True (chunked mode) only grants the
                # slot, compute starting at the first serve.prefill window.
                self.flight.event(
                    seq.request.request_id, "serve.admitted",
                    self.clock(), slot=slot, reused_pages=len(reuse),
                    recompute=seq.preemptions > 0,
                    deferred=self.prefill_chunk is not None)
            if seq.prefilled:
                metrics.counter(
                    "tk8s_serve_prefix_hit_tokens_total").inc(seq.prefilled)
            if self.prefill_chunk is None:
                self._prefill_sequence(seq, prompt)
                metrics.counter("tk8s_serve_tokens_total").inc(
                    len(prompt), kind="prefill")
                if self._maybe_finish(slot, finished):
                    continue

    def _reusable_pages(self, prompt: List[int]) -> List[int]:
        """Prefix-cache pages this prompt can map: the longest indexed
        full-page prefix, rounded DOWN to whole chunk windows and capped
        so at least the final window is computed (its last row is where
        the first token's logits come from)."""
        matched = self.prefix.lookup(prompt)
        usable = min(len(matched) * self.block_size, len(prompt) - 1)
        usable -= usable % self.prefill_chunk
        return matched[:usable // self.block_size]

    # --------------------------------------------------- chunked prefill
    def _table(self, seq: _Sequence) -> List[int]:
        return seq.pages + [TRASH_PAGE] * (self.blocks_per_seq
                                           - len(seq.pages))

    def _prefill_tick(self, finished: List[FinishedRequest]) -> None:
        """Run ONE prefill window for the oldest still-prefilling
        sequence (FIFO by admission)."""
        cands = [i for i, s in enumerate(self.slots)
                 if s is not None and s.prefilled < s.target]
        if not cands:
            return
        i = min(cands, key=lambda j: self.slots[j].admit_seq)
        seq = self.slots[i]
        prompt = list(seq.request.tokens) + list(seq.generated)
        c = self.prefill_chunk
        off = seq.prefilled
        clen = min(c, seq.target - off)
        if self.goodput is not None:
            # A preempted sequence's re-prefill is work done once already:
            # waste, booked as recompute.
            self.goodput.transition(
                "recompute" if seq.preemptions > 0 else "prefill")
        if self.flight is not None:
            self.flight.event(seq.request.request_id, "serve.prefill",
                              self.clock(), offset=off, tokens=clen)
        toks = prompt[off:off + clen] + [0] * (c - clen)
        # The quant-error gauge reads the final window only: earlier
        # windows' values would be overwritten, so they are not computed.
        final = off + clen == seq.target
        out = paged_prefill_chunk(
            self.params, self._tensor([toks]), off, clen, self.config,
            self.cache, self._tensor(self._table(seq)),
            with_quant_error=final and self.cache.quantized)
        self._prefill_windows += 1
        seq.prefilled = off + clen
        metrics.counter("tk8s_serve_tokens_total").inc(clen, kind="prefill")
        if seq.prefilled < seq.target:
            if self.flight is not None:
                # Window over, more to run: the wait for the next one is
                # queue time.
                self.flight.event(seq.request.request_id,
                                  "serve.prefill_yield", self.clock(),
                                  offset=seq.prefilled)
            return
        logits = self._set_quant_error(out)
        if self.prefix is not None:
            # Index every full prompt page (reused prefixes dedupe to
            # their existing nodes).
            self.prefix.insert(prompt, seq.pages)
        seq.generated.append(self._sample(seq, logits[None, :]))
        self._first_token_or_resume(seq)
        self._maybe_finish(i, finished)

    def _first_token_or_resume(self, seq: _Sequence) -> None:
        """After a prompt's last window: the first token (TTFT stops here),
        or the end of a preempted sequence's re-prefill (its recompute
        phase ends here)."""
        if seq.first_token_at is None:
            seq.first_token_at = self.clock()
            if self.flight is not None:
                self.flight.event(seq.request.request_id,
                                  "serve.first_token", seq.first_token_at)
        elif self.flight is not None:
            self.flight.event(seq.request.request_id, "serve.resume",
                              self.clock())

    def _prefill_sequence(self, seq: _Sequence, prompt: List[int]) -> None:
        if self.goodput is not None:
            self.goodput.transition(
                "recompute" if seq.preemptions > 0 else "prefill")
        if self.flight is not None:
            self.flight.event(seq.request.request_id, "serve.prefill",
                              self.clock(), offset=0, tokens=len(prompt))
        padded = prompt + [0] * (self.prefill_width - len(prompt))
        logits = self._set_quant_error(paged_prefill(
            self.params, self._tensor([padded]), len(prompt), self.config,
            self.cache, self._tensor(self._table(seq)),
            with_quant_error=self.cache.quantized))
        seq.prefilled = seq.target = len(prompt)
        seq.generated.append(self._sample(seq, logits[None, :]))
        self._first_token_or_resume(seq)

    def _set_quant_error(self, out) -> torch.Tensor:
        """A prefill's logits; on a quantized pool, ``out`` also carries
        the (k, v) dequantization errors, which set the gauges."""
        if not self.cache.quantized:
            return out
        logits, (k_err, v_err) = out
        metrics.gauge("tk8s_serve_quant_error").set(float(k_err), tensor="k")
        metrics.gauge("tk8s_serve_quant_error").set(float(v_err), tensor="v")
        return logits

    # ------------------------------------------------- growth/preemption
    def _ensure_growth_pages(self) -> None:
        """Every decoding sequence gets the page its next written token
        needs. When the pool is dry: first reclaim unreferenced prefix-
        cache pages, then preempt latest-admitted sequences."""
        for i in sorted(range(self.max_batch),
                        key=lambda i: (self.slots[i].admit_seq
                                       if self.slots[i] else -1)):
            seq = self.slots[i]
            if seq is None or seq.prefilled < seq.target:
                continue  # still prefilling: its pages cover the prompt
            grew = 0
            while blocks_for(seq.length + 1,
                             self.block_size) > len(seq.pages):
                try:
                    seq.pages.extend(self.allocator.alloc(1))
                    grew += 1
                except OutOfBlocksError:
                    if self.prefix is not None and self.prefix.evict(1):
                        continue
                    victim = max(
                        (j for j, s in enumerate(self.slots)
                         if s is not None),
                        key=lambda j: self.slots[j].admit_seq)
                    self._preempt(victim)
                    if victim == i:
                        break  # preempted ourselves; re-admit later
            if grew and self.flight is not None \
                    and self.slots[i] is seq:
                self.flight.event(seq.request.request_id, "serve.grow",
                                  self.clock(), pages=grew)
        if self.spec_k > 0:
            # Speculative pages come in a second pass, after every
            # sequence's mandatory page: interleaved, an early sequence's
            # draft pages could starve a later one's mandatory page and
            # force an eviction or preemption the spec_k=0 engine would
            # never make.
            for i in sorted(range(self.max_batch),
                            key=lambda i: (self.slots[i].admit_seq
                                           if self.slots[i] else -1)):
                if self.slots[i] is not None:
                    self._draft_and_grow(self.slots[i])

    def _preempt(self, slot: int) -> None:
        seq = self.slots[slot]
        assert seq is not None
        freed = len(seq.pages)
        self.allocator.free(seq.pages)
        seq.pages = []
        seq.admit_seq = -1
        seq.preemptions += 1
        seq.prefilled = seq.target = 0
        seq.draft = []
        self.slots[slot] = None
        self.waiting.appendleft(seq)
        metrics.counter("tk8s_serve_preemptions_total").inc()
        if self.flight is not None:
            self.flight.event(seq.request.request_id, "serve.preempt",
                              self.clock(), pages_freed=freed)

    def _draft_and_grow(self, seq: _Sequence) -> None:
        """Self-draft this tick's proposal and allocate the pages its
        writes need. Speculative pages are opportunistic: under pool
        pressure the draft trims itself instead of evicting prefix-cache
        pages or preempting a neighbour, so every eviction and preemption
        is the spec_k=0 engine's."""
        seq.draft = []
        if seq.prefilled < seq.target or not seq.generated:
            return  # still prefilling: nothing to speculate from
        r = seq.request
        # Accepted drafts + the bonus token never pass max_new_tokens (so
        # every written position stays inside the validated window).
        cap = min(self.spec_k, r.max_new_tokens - len(seq.generated) - 1)
        if cap <= 0:
            return
        draft = draft_ngram(list(r.tokens) + list(seq.generated), cap)
        while draft:
            need = (blocks_for(seq.length + len(draft) + 1, self.block_size)
                    - len(seq.pages))
            if need <= self.allocator.available:
                if need > 0:
                    seq.pages.extend(self.allocator.alloc(need))
                break
            draft.pop()
        seq.draft = draft

    # ------------------------------------------------------------ decode
    def _decode_once(self, finished: List[FinishedRequest]) -> None:
        if self.goodput is not None:
            self.goodput.transition("decode")
        tokens = [0] * self.max_batch
        lengths = [0] * self.max_batch
        tables = [[TRASH_PAGE] * self.blocks_per_seq
                  for _ in range(self.max_batch)]
        active = []
        for i, seq in enumerate(self.slots):
            if seq is None or seq.prefilled < seq.target:
                continue  # still prefilling: ride the trash page
            tokens[i] = seq.generated[-1]
            lengths[i] = seq.length
            tables[i][:len(seq.pages)] = seq.pages
            active.append(i)
        logits = paged_decode_step(
            self.params, self._tensor(tokens), self.config, self.cache,
            self._tensor(tables), self._tensor(lengths))
        self._decode_steps += 1
        # Greedy rows share one batched argmax (one host sync); sampled
        # rows draw with their own (seed, position) generators.
        greedy = None
        if any(self.slots[i].request.temperature == 0.0 for i in active):
            greedy = torch.argmax(logits, dim=-1).tolist()
        for i in active:
            seq = self.slots[i]
            if seq.request.temperature == 0.0:
                tok = int(greedy[i])
            else:
                tok = self._sample(seq, logits[i:i + 1])
            seq.generated.append(tok)
            self._maybe_finish(i, finished)
        metrics.counter("tk8s_serve_tokens_total").inc(
            len(active), kind="decode")

    def _spec_decode_once(self, finished: List[FinishedRequest]) -> None:
        """The widened decode tick: verify every sequence's draft at
        ``spec_k + 1`` positions in one pass, keep the longest prefix the
        model agrees with, roll rejected KV writes back, and emit the
        accepted tokens plus the model's own next token. Every position is
        sampled with the same (seed, position)-keyed draw as plain decode,
        so a rejected draft costs a verify row, never a changed token."""
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and s.prefilled >= s.target]
        if not any(self.slots[i].draft for i in active):
            # Nothing drafted: the plain step emits the same token for one
            # weight pass less.
            self._decode_once(finished)
            return
        if self.goodput is not None:
            self.goodput.transition("verify")
        s_width = self.spec_k + 1
        tokens = [[0] * s_width for _ in range(self.max_batch)]
        lengths = [0] * self.max_batch
        tables = [[TRASH_PAGE] * self.blocks_per_seq
                  for _ in range(self.max_batch)]
        for i in active:
            seq = self.slots[i]
            tokens[i][0] = seq.generated[-1]
            tokens[i][1:1 + len(seq.draft)] = seq.draft
            lengths[i] = seq.length
            tables[i][:len(seq.pages)] = seq.pages
        bt, lens = self._tensor(tables), self._tensor(lengths)
        logits, undo = paged_verify_step(
            self.params, self._tensor(tokens), self.config, self.cache, bt,
            lens)
        self._verify_steps += 1
        # Greedy rows share one batched argmax (one host sync); sampled
        # rows draw per position below.
        greedy = None
        if any(self.slots[i].request.temperature == 0.0 for i in active):
            greedy = torch.argmax(logits, dim=-1).tolist()
        proposed = accepted = emitted = 0
        keep = [s_width] * self.max_batch
        plans: Dict[int, List[int]] = {}
        for i in active:
            seq = self.slots[i]
            r = seq.request
            nd, g0 = len(seq.draft), len(seq.generated)
            samples: List[int] = []
            for j in range(nd + 1):
                if r.temperature == 0.0:
                    tok = int(greedy[i][j])
                else:
                    tok = self._sample_at(seq, logits[i, j][None], g0 + j)
                samples.append(tok)
                if j >= nd or tok != seq.draft[j]:
                    break  # bonus row sampled, or first disagreement
            a = longest_agreeing_prefix(seq.draft, samples)
            # Truncate at eos / max_new BEFORE keep and the accept counts:
            # a draft token past the sequence's end is never emitted, so
            # its K/V is rewound and it is not counted as accepted.
            emit = samples[:a + 1]
            cut = len(emit)
            for j, tok in enumerate(emit):
                if (r.eos_id is not None and tok == r.eos_id) \
                        or g0 + j + 1 >= r.max_new_tokens:
                    cut = j + 1
                    break
            plans[i] = emit[:cut]
            keep[i] = cut
            proposed += nd
            accepted += min(a, cut)
            if self.flight is not None and nd:
                self.flight.event(r.request_id, "serve.verify",
                                  self.clock(), proposed=nd,
                                  accepted=min(a, cut))
        if any(keep[i] < s_width for i in active):
            # Roll back every rejected (and pad) write BEFORE any page can
            # be freed or handed out again.
            paged_rewind(self.cache, undo, bt, lens, self._tensor(keep))
        for i in active:
            seq = self.slots[i]
            seq.draft = []
            seq.generated.extend(plans[i])
            emitted += len(plans[i])
            if not self._maybe_finish(i, finished):
                # Return the surplus pages of rejected drafts now: a
                # spec_k=0 engine that emitted these tokens would end the
                # tick holding blocks_for(length) pages, and admission,
                # eviction and preemption match it only if this one does.
                surplus = (len(seq.pages)
                           - blocks_for(seq.length, self.block_size))
                if surplus > 0:
                    self.allocator.free(seq.pages[-surplus:])
                    del seq.pages[-surplus:]
        metrics.counter("tk8s_serve_tokens_total").inc(emitted, kind="decode")
        metrics.counter("tk8s_serve_spec_proposed_tokens_total").inc(proposed)
        metrics.counter("tk8s_serve_spec_accepted_tokens_total").inc(accepted)
        if proposed:
            metrics.histogram("tk8s_serve_spec_accept_rate").observe(
                accepted / proposed)
        metrics.gauge("tk8s_serve_spec_tokens_per_step").set(
            emitted / len(active))

    def _sample(self, seq: _Sequence, logits: torch.Tensor) -> int:
        """Sample position len(generated) of this request (see
        :meth:`_sample_at`)."""
        return self._sample_at(seq, logits, len(seq.generated))

    def _sample_at(self, seq: _Sequence, logits: torch.Tensor,
                   position: int) -> int:
        """Sample one position of this request, keyed by the request's own
        seed and the position -- independent of batch composition, the
        same draw after a preemption's re-prefill, and the same whether
        the position is reached by plain decode or inside a verify."""
        r = seq.request
        gen = (None if r.temperature == 0.0 else
               _sample_generator(r.seed, position, logits.device))
        return int(sample_token(logits, gen, r.temperature, r.top_k,
                                r.top_p)[0])

    def _maybe_finish(self, slot: int,
                      finished: List[FinishedRequest]) -> bool:
        seq = self.slots[slot]
        assert seq is not None
        r = seq.request
        reason = None
        if r.eos_id is not None and seq.generated[-1] == r.eos_id:
            reason = "eos"
        elif len(seq.generated) >= r.max_new_tokens:
            reason = "length"
        # Handoff parks AFTER the genuine-completion checks: a request that
        # is already done has nothing left to hand off.
        if reason is None and r.handoff and seq.prefilled >= seq.target:
            reason = "handoff"
        if reason is None:
            return False
        if reason == "handoff":
            # The decode half runs elsewhere: keep the pages (parked, off
            # the scheduler) for export_session, give back only the slot.
            seq.handed_off = True
            seq.draft = []
            self.parked[r.request_id] = seq
        else:
            self.allocator.free(seq.pages)
        self.slots[slot] = None
        now = self.clock()
        done = FinishedRequest(
            request_id=r.request_id, prompt_len=len(r.tokens),
            tokens=list(seq.generated), finish_reason=reason,
            submitted_at=seq.submitted_at,
            first_token_at=seq.first_token_at or now,
            finished_at=now, preemptions=seq.preemptions)
        if self.flight is not None:
            rec = self.flight.finish(r.request_id, now, reason)
            if rec is not None:
                done.trace_id = rec.trace_id
                done.phases = dict(rec.phases)
                if rec.spec_proposed:
                    done.spec = {"proposed": rec.spec_proposed,
                                 "accepted": rec.spec_accepted}
        finished.append(done)
        metrics.counter("tk8s_serve_requests_total").inc(outcome=reason)
        # The trace id rides the latency observations as an exemplar. An
        # imported session's first token was sampled on its source, so only
        # its decode pace is observed here.
        if not seq.imported:
            metrics.histogram("tk8s_serve_ttft_seconds").observe(
                done.ttft, exemplar=done.trace_id)
        if len(done.tokens) > 1:
            metrics.histogram("tk8s_serve_tpot_seconds").observe(
                done.tpot, exemplar=done.trace_id)
        return True

    # ------------------------------------------------------------ metrics
    def _kv_pressure(self) -> float:
        """Max pool utilization over the last _PRESSURE_WINDOW ticks."""
        now = self.allocator.in_use / max(1, self.allocator.capacity)
        return max([now] + list(self._pressure_samples))

    def _update_gauges(self) -> None:
        self._pressure_samples.append(
            self.allocator.in_use / max(1, self.allocator.capacity))
        metrics.gauge("tk8s_serve_queue_depth").set(len(self.waiting))
        metrics.gauge("tk8s_serve_sequences").set(
            self.num_running, state="running")
        metrics.gauge("tk8s_serve_sequences").set(
            len(self.waiting), state="waiting")
        metrics.gauge("tk8s_serve_kv_blocks_in_use").set(
            self.allocator.in_use)
        metrics.gauge("tk8s_serve_kv_block_utilization").set(
            self.allocator.in_use / max(1, self.allocator.capacity))
        metrics.gauge("tk8s_serve_prefix_cache_pages").set(
            self.prefix.pages if self.prefix is not None else 0)

    def stats(self) -> Dict[str, object]:
        return {
            "model": self.config.name,
            "device": str(self.device),
            "block_size": self.block_size,
            "num_blocks": self.allocator.num_blocks,
            "kv_blocks_in_use": self.allocator.in_use,
            "kv_blocks_free": self.allocator.available,
            "max_batch": self.max_batch,
            "max_model_len": self.max_model_len,
            "running": self.num_running,
            "waiting": len(self.waiting),
            "steps": self._steps,
            "prefill_windows": self._prefill_windows,
            "decode_steps": self._decode_steps,
            "verify_steps": self._verify_steps,
            "sequential": self.sequential,
            "kv_dtype": self.kv_dtype,
            "weight_dtype": self.weight_dtype,
            "matmul_dtype": self.matmul_dtype,
            "kv_pool_bytes": self.cache.pool_bytes + self.cache.scale_bytes,
            "kv_pressure": self._kv_pressure(),
            "prefill_chunk": self.prefill_chunk,
            "spec_k": self.spec_k,
            "prefix_cache": self.prefix is not None,
            "prefix_cache_pages": (self.prefix.pages
                                   if self.prefix is not None else 0),
            # Migration surface: what a drain could ship away now, and what
            # is frozen awaiting a transfer verdict.
            "parked": sorted(self.parked),
            "sessions": self.exportable_sessions(),
            "tracing": (self.flight.snapshot()
                        if self.flight is not None else None),
        }

    def abort_inflight(self, error: str) -> int:
        """Flush every in-flight request's lifecycle as ``aborted`` (the
        engine loop died): their partial phase attribution survives into
        the recorder and the JSONL trace. Returns the number flushed."""
        if self.flight is None:
            return 0
        return len(self.flight.flush_aborted(self.clock(), error))

    def release_prefix_cache(self) -> int:
        """Drop every cache-held page reference; returns pages the cache
        released. After ``run_until_idle()`` and this, ``allocator.in_use``
        must be 0 or pages leaked."""
        if self.prefix is None:
            return 0
        return self.prefix.clear()

    # --------------------------------------------------------- migration
    def _components(self) -> Dict[str, torch.Tensor]:
        """The pool arrays a session ships, by wire name."""
        c = self.cache
        pool = {"k": c.k, "v": c.v}
        if c.quantized:
            pool["k_scale"], pool["v_scale"] = c.k_scale, c.v_scale
        return pool

    def exportable_sessions(self) -> List[str]:
        """Request ids a migration could ship now: parked sessions plus
        fully prefilled live ones (a mid-prefill sequence has no complete
        state to pack)."""
        live = [s.request.request_id for s in self.slots
                if s is not None and s.prefilled >= s.target
                and s.generated]
        return sorted(self.parked) + live

    def _trace_id(self, seq: _Sequence) -> str:
        return seq.request.trace_id or seq.request.request_id

    def export_session(self, request_id: str,
                       reason: str = "handoff") -> bytes:
        """Pack one session into the wire unit (``serve/migration.py``).
        Non-destructive: the pages stay allocated and the session stays
        parked until the destination confirms the import
        (``release_session``) or the transfer fails (``resume_session``).

        A live decoding session (drain) is parked here first, freezing it
        out of the scheduler so the shipped snapshot stays authoritative.
        Each component leaves the card in one indexed read of the pool and
        one device-to-host copy."""
        seq = self.parked.get(request_id)
        if seq is None:
            slot = next(
                (i for i, s in enumerate(self.slots)
                 if s is not None and s.request.request_id == request_id),
                None)
            if slot is None:
                raise MigrationError(
                    f"no exportable session {request_id!r} (not parked, "
                    f"not in a decode slot)")
            seq = self.slots[slot]
            if seq.prefilled < seq.target or not seq.generated:
                raise MigrationError(
                    f"session {request_id!r} is still prefilling -- drain "
                    f"re-lands it via recompute, not migration")
            seq.draft = []  # drafts are per-tick state; they never ship
            self.slots[slot] = None
            self.parked[request_id] = seq
        seq.migrate_reason = reason
        t0 = self.clock()
        if self.goodput is not None:
            self.goodput.transition("migrate_out")
        pages = torch.tensor(seq.pages, dtype=torch.long, device=self.device)
        arrays = {}
        for name, pool in self._components().items():
            # fp8 has no indexing kernel: gather its bytes, view them back.
            host = byte_view(pool)[:, pages].cpu()
            arrays[name] = host.view(pool.dtype)
        r = seq.request
        blob = pack_session(
            model=self.config.name, kv_dtype=self.kv_dtype,
            block_size=self.block_size, arrays=arrays,
            request={"request_id": r.request_id,
                     "tokens": list(r.tokens),
                     "max_new_tokens": r.max_new_tokens,
                     "temperature": r.temperature, "top_k": r.top_k,
                     "top_p": r.top_p, "eos_id": r.eos_id,
                     "seed": r.seed, "trace_id": r.trace_id},
            generated=list(seq.generated), prefilled=seq.prefilled,
            target=seq.target, preemptions=seq.preemptions)
        if self.goodput is not None:
            self.goodput.transition("idle")
        metrics.counter("tk8s_serve_migration_bytes_total").inc(
            len(blob), direction="out", exemplar=self._trace_id(seq))
        if self.flight is not None:
            now = self.clock()
            if seq.handed_off:
                # The handoff lifecycle already closed: the pack lands as a
                # writer-only span so the timeline still shows it.
                self.flight.migration(
                    "serve.migrate_out", t0, now - t0,
                    trace=self._trace_id(seq), request=request_id,
                    bytes=len(blob), pages=len(seq.pages), reason=reason)
            else:
                self.flight.event(
                    request_id, "serve.migrate_out", t0,
                    bytes=len(blob), pages=len(seq.pages), reason=reason)
        return blob

    def release_session(self, request_id: str,
                        ) -> Optional[FinishedRequest]:
        """The destination confirmed the import: free the parked pages
        (pages the prefix cache shares survive under its own references).
        A drained session's lifecycle closes here with finish_reason
        ``migrated``; a handed-off one already answered and returns None."""
        seq = self.parked.pop(request_id, None)
        if seq is None:
            raise MigrationError(f"no parked session {request_id!r}")
        self.allocator.free(seq.pages)
        seq.pages = []
        metrics.counter("tk8s_serve_migrations_total").inc(
            direction="out", reason=seq.migrate_reason or "handoff",
            status="ok", exemplar=self._trace_id(seq))
        if seq.handed_off:
            return None
        now = self.clock()
        done = FinishedRequest(
            request_id=request_id, prompt_len=len(seq.request.tokens),
            tokens=list(seq.generated), finish_reason="migrated",
            submitted_at=seq.submitted_at,
            first_token_at=seq.first_token_at or now,
            finished_at=now, preemptions=seq.preemptions)
        if self.flight is not None:
            rec = self.flight.finish(request_id, now, "migrated")
            if rec is not None:
                done.trace_id = rec.trace_id
                done.phases = dict(rec.phases)
        metrics.counter("tk8s_serve_requests_total").inc(
            outcome="migrated")
        if not seq.imported:
            metrics.histogram("tk8s_serve_ttft_seconds").observe(
                done.ttft, exemplar=done.trace_id)
        return done

    def resume_session(self, request_id: str) -> None:
        """The transfer failed: un-park the session with everything intact
        and let it finish HERE. Clears the handoff flag so it decodes to
        genuine completion instead of re-parking."""
        seq = self.parked.pop(request_id, None)
        if seq is None:
            raise MigrationError(f"no parked session {request_id!r}")
        seq.request.handoff = False
        seq.admit_seq = -1
        self.waiting.appendleft(seq)

    def import_session(self, payload: bytes,
                       request_id: Optional[str] = None,
                       reason: str = "handoff") -> str:
        """Verify, unpack and install a shipped session byte for byte.

        The digest check runs first: a torn payload raises
        :class:`~.migration.TornPayloadError` with this pool untouched.
        Full prompt pages the local prefix cache already indexes transfer
        by reference (incref, no write); the rest are allocated fresh and
        their bytes written in: one host-to-device copy and one indexed
        write a component. The session rejoins decode on the next tick and
        samples with its own (seed, position) keys, so its tokens are the
        never-migrated stream's. ``request_id`` renames it on arrival."""
        t0 = self.clock()
        if self.goodput is not None:
            self.goodput.transition("migrate_in")
        mig = metrics.counter("tk8s_serve_migrations_total")
        try:
            sp = unpack_session(payload)
            check_compatible(
                sp, model=self.config.name, kv_dtype=self.kv_dtype,
                block_size=self.block_size,
                expect_arrays=tuple(self._components()))
            self._check_importable(sp)
        except MigrationError as e:
            status = ("torn" if isinstance(e, TornPayloadError)
                      else "error")
            mig.inc(direction="in", reason=reason, status=status)
            if self.goodput is not None:
                self.goodput.transition("idle")
            raise
        req_state = dict(sp.request)
        rid = request_id or str(req_state["request_id"])
        if (rid in self.parked
                or any(s is not None and s.request.request_id == rid
                       for s in self.slots)
                or any(s.request.request_id == rid
                       for s in self.waiting)):
            mig.inc(direction="in", reason=reason, status="error")
            if self.goodput is not None:
                self.goodput.transition("idle")
            raise MigrationError(
                f"request id {rid!r} is already live on this replica -- "
                f"import under a fresh id")
        request = Request(
            request_id=rid, tokens=[int(t) for t in req_state["tokens"]],
            max_new_tokens=int(req_state["max_new_tokens"]),
            temperature=float(req_state["temperature"]),
            top_k=int(req_state["top_k"]),
            top_p=float(req_state["top_p"]),
            eos_id=(None if req_state["eos_id"] is None
                    else int(req_state["eos_id"])),
            seed=int(req_state["seed"]),
            trace_id=req_state.get("trace_id"), handoff=False)
        n_pages = sp.pages
        # The refcount handshake: full prompt pages the local radix cache
        # indexes hold the same bytes (the same windows of the same tokens
        # wrote them; F2 makes that hold whatever the window width), so
        # they are mapped by reference and their payload bytes not written.
        reuse: List[int] = []
        if self.prefix is not None and n_pages:
            matched = self.prefix.lookup(request.tokens)
            cap = min(len(matched), len(request.tokens) // self.block_size,
                      n_pages)
            reuse = matched[:cap]
            self.allocator.incref(reuse)
        try:
            fresh = self.allocator.alloc(n_pages - len(reuse))
        except OutOfBlocksError:
            if reuse:
                self.allocator.free(reuse)
            mig.inc(direction="in", reason=reason, status="error")
            if self.goodput is not None:
                self.goodput.transition("idle")
            raise MigrationError(
                f"pool pressure: session needs {n_pages - len(reuse)} "
                f"fresh pages, {self.allocator.available} available")
        pages = reuse + fresh
        if fresh:
            dest = torch.tensor(fresh, dtype=torch.long, device=self.device)
            for name, pool in self._components().items():
                pool = byte_view(pool)
                # The reused pages are a prefix of the table: ship the
                # rest, in one copy to the card.
                src = sp.arrays[name][:, len(reuse):]
                pool.index_copy_(1, dest, src.view(pool.dtype).to(
                    self.device))
        if self.prefix is not None:
            # Index the imported prompt pages as a local final window would
            # have: the next session sharing this prompt maps them.
            self.prefix.insert(list(request.tokens), pages)
        seq = _Sequence(
            request, submitted_at=t0,
            generated=[int(t) for t in sp.header["generated"]],
            first_token_at=t0, preemptions=int(sp.header["preemptions"]),
            pages=pages, prefilled=int(sp.header["prefilled"]),
            target=int(sp.header["target"]), imported=True,
            migrate_reason=reason)
        self.waiting.append(seq)
        if self.flight is not None:
            self.flight.begin(rid, request.trace_id, t0)
            self.flight.event(rid, "serve.migrate_in", t0,
                              bytes=sp.nbytes, pages=n_pages,
                              reused_pages=len(reuse), reason=reason)
        mig.inc(direction="in", reason=reason, status="ok",
                exemplar=self._trace_id(seq))
        metrics.counter("tk8s_serve_migration_bytes_total").inc(
            sp.nbytes, direction="in", exemplar=self._trace_id(seq))
        if self.goodput is not None:
            self.goodput.transition("idle")
        return rid

    def _check_importable(self, sp) -> None:
        """Geometry/dtype gate beyond the header identity check: raw bytes
        land only in arrays of the same dtype and per-page shape (a cast
        would break the bitwise contract), and the session must fit."""
        for name, arr in self._components().items():
            meta = sp.header["arrays"].get(name, {})
            want = (arr.shape[0], sp.pages) + tuple(arr.shape[2:])
            got = tuple(meta.get("shape", ()))
            if meta.get("dtype") != dtype_name(arr.dtype):
                raise MigrationError(
                    f"component {name!r}: payload dtype "
                    f"{meta.get('dtype')!r} != pool dtype "
                    f"{dtype_name(arr.dtype)!r}")
            if got != want:
                raise MigrationError(
                    f"component {name!r}: payload shape {list(got)} != "
                    f"expected {list(want)}")
        if sp.pages > self.blocks_per_seq:
            raise MigrationError(
                f"session spans {sp.pages} pages, this pool's table "
                f"width is {self.blocks_per_seq}")
        h = sp.header
        total = len(h["request"]["tokens"]) + int(
            h["request"]["max_new_tokens"])
        if total > self.max_model_len:
            raise MigrationError(
                f"session needs {total} positions, max_model_len is "
                f"{self.max_model_len}")
        if int(h["prefilled"]) < int(h["target"]) or not h["generated"]:
            raise MigrationError(
                "session is not fully prefilled -- only decode-ready "
                "sessions migrate")
