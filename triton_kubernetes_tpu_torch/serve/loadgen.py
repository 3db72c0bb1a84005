"""Seeded open-loop load for the serving engine and the router fleet --
the port's copy of ``triton_kubernetes_tpu/serve/loadgen.py``: the same
seed gives the identical request stream as the reference's.

Open-loop is the honest shape for "millions of users": arrivals come
from the world on their own schedule, not gated on the server's previous
response, so queueing shows up as queueing (TTFT growth) instead of
silently throttling offered load the way a closed loop does. Every
schedule is fully determined by its seed -- both arms of an A/B replay
the *identical* request stream.

The trace shapes, one per serving claim:

* :class:`PoissonSchedule` -- independent ragged requests (the
  continuous-batching load);
* :class:`SharedPrefixSchedule` -- K system prompts x many users, the
  trace where radix prefix sharing pays: every request is one of K
  long seeded prefixes plus a short per-user suffix;
* :class:`SessionSchedule` -- multi-turn sessions with stable
  ``session_id`` and growing prompts (turn N's prompt extends turn
  N-1's), which is what makes router affinity *measurable*: a
  session-affine fleet serves every turn from the replica whose prefix
  cache already holds the session;
* :class:`RepetitionSchedule` -- prompts that are a short seeded motif
  tiled many times, the self-similar text the n-gram self-drafter
  (``serve/speculation.py``) is built for;
* :class:`DiurnalSchedule` -- non-homogeneous Poisson arrivals over a
  day curve with seeded bursts, the autoscaler's trace.

Dependency-free (``random.Random``): the router box imports it without
torch.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List, Optional, Sequence


@dataclass(frozen=True)
class TimedRequest:
    """One scheduled arrival: submit at ``at`` seconds from epoch 0.
    ``session_id`` is the router affinity key (None = sessionless)."""

    at: float
    request_id: str
    tokens: List[int]
    max_new_tokens: int
    session_id: Optional[str] = None


class PoissonSchedule:
    """Seeded Poisson arrivals with uniform ragged prompt lengths."""

    def __init__(self, *, rate: float, n: int, vocab_size: int,
                 prompt_len_range: Sequence[int] = (4, 32),
                 max_new_tokens: int = 16, seed: int = 0):
        if rate <= 0:
            raise ValueError(f"rate must be > 0 req/s, got {rate}")
        rng = random.Random(seed)
        lo, hi = prompt_len_range
        t = 0.0
        self.requests: List[TimedRequest] = []
        for i in range(n):
            t += rng.expovariate(rate)
            plen = rng.randint(lo, hi)
            self.requests.append(TimedRequest(
                at=t, request_id=f"req-{i}",
                tokens=[rng.randrange(vocab_size) for _ in range(plen)],
                max_new_tokens=max_new_tokens))

    def __iter__(self):
        return iter(self.requests)

    def __len__(self) -> int:
        return len(self.requests)


class SharedPrefixSchedule:
    """K seeded system prompts × many users: Poisson arrivals where each
    request is ``prefixes[k] + short per-user suffix``.

    The trace the prefix cache is built for — without sharing every
    request pays O(prefix_len) prefill; with sharing only the first
    request per prefix does. ``prefix_of`` records which system prompt
    each request drew (evidence scripts group hit accounting by it).
    """

    def __init__(self, *, rate: float, n: int, vocab_size: int,
                 num_prefixes: int = 2, prefix_len: int = 96,
                 suffix_len_range: Sequence[int] = (2, 8),
                 max_new_tokens: int = 16, seed: int = 0):
        if rate <= 0:
            raise ValueError(f"rate must be > 0 req/s, got {rate}")
        if num_prefixes < 1:
            raise ValueError(
                f"num_prefixes must be >= 1, got {num_prefixes}")
        if prefix_len < 1:
            raise ValueError(f"prefix_len must be >= 1, got {prefix_len}")
        rng = random.Random(seed)
        self.prefixes: List[List[int]] = [
            [rng.randrange(vocab_size) for _ in range(prefix_len)]
            for _ in range(num_prefixes)]
        lo, hi = suffix_len_range
        t = 0.0
        self.requests: List[TimedRequest] = []
        self.prefix_of: List[int] = []
        for i in range(n):
            t += rng.expovariate(rate)
            k = rng.randrange(num_prefixes)
            suffix = [rng.randrange(vocab_size)
                      for _ in range(rng.randint(lo, hi))]
            self.prefix_of.append(k)
            self.requests.append(TimedRequest(
                at=t, request_id=f"req-{i}",
                tokens=list(self.prefixes[k]) + suffix,
                max_new_tokens=max_new_tokens))

    def __iter__(self):
        return iter(self.requests)

    def __len__(self) -> int:
        return len(self.requests)


class RepetitionSchedule:
    """Seeded Poisson arrivals of repetition-heavy prompts: each request
    draws a short motif of ``motif_len_range`` tokens and tiles it to
    ``prompt_len`` (cut mid-motif where it does not divide evenly).

    The speculative-decode trace: code, templated prose, and chat
    boilerplate are self-similar, and greedy continuations of
    self-similar context settle into cycles the prompt-lookup drafter
    proposes at high accept rates. ``max_new_tokens`` defaults long
    relative to the other traces because the win compounds over the
    decode tail, which is exactly what the A/B measures.
    """

    def __init__(self, *, rate: float, n: int, vocab_size: int,
                 prompt_len: int = 48,
                 motif_len_range: Sequence[int] = (3, 6),
                 max_new_tokens: int = 32, seed: int = 0):
        if rate <= 0:
            raise ValueError(f"rate must be > 0 req/s, got {rate}")
        if prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
        rng = random.Random(seed)
        lo, hi = motif_len_range
        t = 0.0
        self.requests: List[TimedRequest] = []
        for i in range(n):
            t += rng.expovariate(rate)
            motif = [rng.randrange(vocab_size)
                     for _ in range(rng.randint(lo, hi))]
            tokens = (motif * (prompt_len // len(motif) + 1))[:prompt_len]
            self.requests.append(TimedRequest(
                at=t, request_id=f"req-{i}", tokens=tokens,
                max_new_tokens=max_new_tokens))

    def __iter__(self):
        return iter(self.requests)

    def __len__(self) -> int:
        return len(self.requests)


class SessionSchedule:
    """Multi-turn sessions: each session opens with its own seeded
    prefix, and every later turn's prompt extends the previous turn's by
    a few synthetic tokens (an open-loop trace cannot know real model
    outputs — for routing and prefix accounting only the *shared prefix
    growth* matters, not what the tokens say).

    Arrivals: session starts are Poisson at ``rate``; within a session,
    turns follow at ``think_time`` expovariate gaps — so turns of one
    session are strictly ordered in time while sessions interleave, and
    the stream as a whole still offers open-loop load.
    """

    def __init__(self, *, rate: float, num_sessions: int, turns: int,
                 vocab_size: int, prefix_len: int = 24,
                 turn_len_range: Sequence[int] = (2, 6),
                 think_time: float = 0.2,
                 max_new_tokens: int = 8, seed: int = 0):
        if rate <= 0:
            raise ValueError(f"rate must be > 0 sessions/s, got {rate}")
        if turns < 1:
            raise ValueError(f"turns must be >= 1, got {turns}")
        if think_time <= 0:
            raise ValueError(
                f"think_time must be > 0 s, got {think_time}")
        rng = random.Random(seed)
        lo, hi = turn_len_range
        self.requests: List[TimedRequest] = []
        start = 0.0
        for s in range(num_sessions):
            start += rng.expovariate(rate)
            prompt = [rng.randrange(vocab_size) for _ in range(prefix_len)]
            at = start
            for turn in range(turns):
                if turn:
                    at += rng.expovariate(1.0 / think_time)
                    prompt = prompt + [rng.randrange(vocab_size)
                                       for _ in range(rng.randint(lo, hi))]
                self.requests.append(TimedRequest(
                    at=at, request_id=f"sess-{s}-t{turn}",
                    tokens=list(prompt), max_new_tokens=max_new_tokens,
                    session_id=f"sess-{s}"))
        self.requests.sort(key=lambda r: r.at)

    def __iter__(self):
        return iter(self.requests)

    def __len__(self) -> int:
        return len(self.requests)


class DiurnalSchedule:
    """Seeded non-homogeneous Poisson arrivals over a day curve with
    bursts — the trace the reconcile operator's autoscaler is judged
    against ("Evaluating Kubernetes Performance for GenAI Inference",
    PAPERS.md, drives provisioned infrastructure with exactly this
    shape).

    The instantaneous rate is a raised-cosine day curve between
    ``base_rate`` (the overnight trough) and ``peak_rate`` (the
    afternoon peak at ``peak_at`` of the day), multiplied by
    ``burst_mult`` inside seeded burst windows (flash crowds riding the
    diurnal swell). At production scale the same curve is
    millions of requests per simulated day — ``peak_rate=50`` req/s
    over a 86400 s day is ~3M — while tests and the CI evidence replay
    a compressed day (``day_seconds`` of tens of seconds) so the shape,
    not the wall time, is what transfers.

    Arrivals are drawn by Lewis thinning (candidates at the max rate,
    accepted with probability ``rate_at(t)/max_rate``), so the stream
    is exactly Poisson at every instant and fully determined by the
    seed. ``rate_at`` is exposed for evidence scripts that plot offered
    load against the autoscaler's pool count.
    """

    def __init__(self, *, base_rate: float, peak_rate: float,
                 day_seconds: float = 86400.0, days: float = 1.0,
                 peak_at: float = 0.6, vocab_size: int = 256,
                 prompt_len_range: Sequence[int] = (4, 32),
                 max_new_tokens: int = 16,
                 num_bursts: int = 2, burst_mult: float = 2.0,
                 burst_seconds: Optional[float] = None,
                 seed: int = 0):
        if base_rate <= 0 or peak_rate < base_rate:
            raise ValueError(
                f"need 0 < base_rate <= peak_rate, got "
                f"{base_rate}/{peak_rate}")
        if day_seconds <= 0 or days <= 0:
            raise ValueError("day_seconds and days must be > 0")
        if burst_mult < 1.0:
            raise ValueError(f"burst_mult must be >= 1, got {burst_mult}")
        self.base_rate = float(base_rate)
        self.peak_rate = float(peak_rate)
        self.day_seconds = float(day_seconds)
        self.duration = float(day_seconds) * float(days)
        self.peak_at = float(peak_at)
        self.burst_mult = float(burst_mult)
        rng = random.Random(seed)
        # Burst windows first (fixed draw order = seed determinism even
        # if the thinning loop changes length).
        if burst_seconds is None:
            burst_seconds = self.day_seconds / 24.0  # an "hour"
        self.bursts: List[Sequence[float]] = []
        for _ in range(max(0, int(num_bursts))):
            start = rng.uniform(0.0, self.duration)
            self.bursts.append((start, start + float(burst_seconds)))
        self.bursts.sort()
        max_rate = self.peak_rate * self.burst_mult
        lo, hi = prompt_len_range
        t = 0.0
        self.requests: List[TimedRequest] = []
        i = 0
        while True:
            t += rng.expovariate(max_rate)
            if t >= self.duration:
                break
            if rng.random() >= self.rate_at(t) / max_rate:
                continue  # thinned: the curve is below max here
            plen = rng.randint(lo, hi)
            self.requests.append(TimedRequest(
                at=t, request_id=f"req-{i}",
                tokens=[rng.randrange(vocab_size) for _ in range(plen)],
                max_new_tokens=max_new_tokens))
            i += 1

    def rate_at(self, t: float) -> float:
        """Offered load (req/s) at simulated time ``t``: the day curve,
        times the burst multiplier when ``t`` is inside a burst."""
        phase = (t / self.day_seconds - self.peak_at) * 2.0 * math.pi
        curve = 0.5 * (1.0 + math.cos(phase))  # 1.0 at the peak
        rate = self.base_rate + (self.peak_rate - self.base_rate) * curve
        for start, end in self.bursts:
            if start <= t < end:
                rate *= self.burst_mult
                break
        return rate

    def __iter__(self):
        return iter(self.requests)

    def __len__(self) -> int:
        return len(self.requests)


def percentile(values: Sequence[float], p: float) -> float:
    """Linear-interpolation percentile (p in [0, 100]); 0.0 on empty
    input.

    Interpolates between the two bracketing order statistics (the
    sample-side analog of ``utils/metrics.histogram_quantile``'s
    within-bucket interpolation), so a p99 over a few dozen requests is
    a continuous function of the data instead of snapping to whichever
    single sample nearest-rank lands on — the quantization that let a
    one-sample outlier swing small-N evidence gates by a whole sample.
    """
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile must be in [0, 100], got {p}")
    if not values:
        return 0.0
    ordered = sorted(values)
    if len(ordered) == 1:
        return ordered[0]
    rank = (len(ordered) - 1) * p / 100.0
    lo = min(int(rank), len(ordered) - 2)
    frac = rank - lo
    return ordered[lo] + (ordered[lo + 1] - ordered[lo]) * frac
