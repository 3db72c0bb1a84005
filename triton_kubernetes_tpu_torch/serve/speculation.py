"""Draft-free speculative decoding: the n-gram self-drafter and the
acceptance rule -- the port's copy of
``triton_kubernetes_tpu/serve/speculation.py`` (pure Python, no tensors).

Decode reads every weight and the whole KV context to emit one token per
sequence. Speculation verifies several proposed tokens per weight pass
(``models.paged.paged_verify_step`` scores ``spec_k + 1`` positions in one
call) and keeps the longest prefix the model itself agrees with.

* :func:`draft_ngram` -- prompt-lookup self-drafting: the proposal is the
  continuation of the most recent earlier occurrence of the sequence's
  own current suffix (prompt + generated tokens). No second model; every
  proposed token comes from the sequence's own history, so a draft never
  holds an out-of-vocab id. On text with no self-similarity it proposes
  nothing and the engine runs that step as plain decode.
* :func:`longest_agreeing_prefix` -- acceptance: keep draft tokens while
  the model's own (seed, position)-keyed sample at each position equals
  the draft. The engine samples every position with the same keyed draw
  the non-speculative engine uses, so what it emits is that engine's
  output, for greedy and seeded sampling alike.

Both functions are pure: a given history always drafts the same,
whatever the rest of the batch does.
"""

from __future__ import annotations

from typing import List, Sequence

# Longest suffix the drafter tries to match before shorter ones.
MAX_NGRAM = 3
# Shortest suffix worth matching.
MIN_NGRAM = 1
# How far back the suffix search looks. The drafter runs on the
# scheduler's thread once per decoding sequence per tick, and its worst
# case is text where it finds nothing (it scans everything, every tick),
# so the scan is bounded.
MAX_SCAN = 2048


def draft_ngram(history: Sequence[int], k: int, *,
                max_ngram: int = MAX_NGRAM,
                min_ngram: int = MIN_NGRAM,
                max_scan: int = MAX_SCAN) -> List[int]:
    """Propose up to ``k`` next tokens by suffix match over the last
    ``max_scan`` tokens of ``history``.

    Longest match first: for ``n`` from ``max_ngram`` down to
    ``min_ngram``, find the most recent earlier occurrence of the final
    ``n`` tokens and propose the tokens that followed it. Returns ``[]``
    when nothing matches or ``k <= 0``."""
    if k <= 0:
        return []
    h = list(history)[-max_scan:]
    n_hist = len(h)
    for n in range(min(max_ngram, n_hist - 1), min_ngram - 1, -1):
        suffix = h[n_hist - n:]
        # Most recent occurrence whose continuation exists; compare the
        # first token first, so the common miss costs one comparison.
        first = suffix[0]
        for p in range(n_hist - n - 1, -1, -1):
            if h[p] == first and h[p:p + n] == suffix:
                return h[p + n:p + n + k]
    return []


def longest_agreeing_prefix(draft: Sequence[int],
                            sampled: Sequence[int]) -> int:
    """Number of leading draft tokens the model agreed with: positions
    ``j`` from 0 where ``sampled[j] == draft[j]``, up to the first
    mismatch. The engine emits those plus ``sampled[a]``, so every verify
    nets at least one token."""
    a = 0
    for d, s in zip(draft, sampled):
        if d != s:
            break
        a += 1
    return a
