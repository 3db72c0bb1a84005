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

Not ported yet, and raising ``NotImplementedError`` naming the slice: the
flight recorder and goodput ledger, and session handoff, export and import
(migration).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Callable, Deque, Dict, List, Optional

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
from ..ops.paged_attention import TRASH_PAGE, blocks_for
from ..train.precision import quantize_for_decode
from ..utils import metrics
from .blocks import BlockAllocator, OutOfBlocksError, PrefixCache
from .speculation import draft_ngram, longest_agreeing_prefix

# Ticks of pool-utilization history behind the stats() kv_pressure signal.
_PRESSURE_WINDOW = 32


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {slice_name} slice of "
        f"the port (ROADMAP.md)")


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
    ``handoff`` mirrors the JAX engine's request; a handoff request is
    refused until the migration slice lands."""

    request_id: str
    tokens: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    seed: int = 0
    handoff: bool = False


@dataclass
class FinishedRequest:
    request_id: str
    prompt_len: int
    tokens: List[int]  # generated only
    finish_reason: str  # "eos" | "length"
    submitted_at: float
    first_token_at: float
    finished_at: float
    preemptions: int = 0

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
        flight: Optional[object] = None,
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
        if flight is not None:
            raise _later("the flight recorder", "flight recorder and goodput")
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
        if request.handoff:
            raise _later("prefill/decode handoff", "migration")

    def submit(self, request: Request) -> None:
        self.validate_request(request)
        self.waiting.append(_Sequence(request, submitted_at=self.clock()))

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    @property
    def num_running(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    # ----------------------------------------------------------- stepping
    def step(self) -> List[FinishedRequest]:
        """One scheduler tick; returns requests that completed in it."""
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
            return
        logits = self._set_quant_error(out)
        if self.prefix is not None:
            # Index every full prompt page (reused prefixes dedupe to
            # their existing nodes).
            self.prefix.insert(prompt, seq.pages)
        seq.generated.append(self._sample(seq, logits[None, :]))
        if seq.first_token_at is None:
            seq.first_token_at = self.clock()
        self._maybe_finish(i, finished)

    def _prefill_sequence(self, seq: _Sequence, prompt: List[int]) -> None:
        padded = prompt + [0] * (self.prefill_width - len(prompt))
        logits = self._set_quant_error(paged_prefill(
            self.params, self._tensor([padded]), len(prompt), self.config,
            self.cache, self._tensor(self._table(seq)),
            with_quant_error=self.cache.quantized))
        seq.prefilled = seq.target = len(prompt)
        seq.generated.append(self._sample(seq, logits[None, :]))
        if seq.first_token_at is None:
            seq.first_token_at = self.clock()

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
            while blocks_for(seq.length + 1,
                             self.block_size) > len(seq.pages):
                try:
                    seq.pages.extend(self.allocator.alloc(1))
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
        self.allocator.free(seq.pages)
        seq.pages = []
        seq.admit_seq = -1
        seq.preemptions += 1
        seq.prefilled = seq.target = 0
        seq.draft = []
        self.slots[slot] = None
        self.waiting.appendleft(seq)
        metrics.counter("tk8s_serve_preemptions_total").inc()

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
        if reason is None:
            return False
        self.allocator.free(seq.pages)
        self.slots[slot] = None
        now = self.clock()
        done = FinishedRequest(
            request_id=r.request_id, prompt_len=len(r.tokens),
            tokens=list(seq.generated), finish_reason=reason,
            submitted_at=seq.submitted_at,
            first_token_at=seq.first_token_at or now,
            finished_at=now, preemptions=seq.preemptions)
        finished.append(done)
        metrics.counter("tk8s_serve_requests_total").inc(outcome=reason)
        metrics.histogram("tk8s_serve_ttft_seconds").observe(done.ttft)
        if len(done.tokens) > 1:
            metrics.histogram("tk8s_serve_tpot_seconds").observe(done.tpot)
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
        }

    def release_prefix_cache(self) -> int:
        """Drop every cache-held page reference; returns pages the cache
        released. After ``run_until_idle()`` and this, ``allocator.in_use``
        must be 0 or pages leaked."""
        if self.prefix is None:
            return 0
        return self.prefix.clear()
