"""Synthetic training data -- the port of ``synthetic_batches`` in
``triton_kubernetes_tpu/train/data.py`` (a numpy copy: same seed, same
arrays). The packed and sharded file pipelines are later slices."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_batches(
    vocab_size: int,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Order-2 Markov sequences: next = (a*prev + b*prev2 + noise) % V.
    Structured rather than uniform noise, so a model can learn them and a
    falling loss means something. Yields ``{"tokens": [B, S+1] int32}``."""
    rng = np.random.default_rng(seed)
    a, b = 31, 17
    while True:
        out = np.empty((batch_size, seq_len + 1), dtype=np.int32)
        prev = rng.integers(0, vocab_size, size=batch_size)
        prev2 = rng.integers(0, vocab_size, size=batch_size)
        for t in range(seq_len + 1):
            noise = rng.integers(0, 4, size=batch_size)
            cur = (a * prev + b * prev2 + noise) % vocab_size
            out[:, t] = cur
            prev2, prev = prev, cur
        yield {"tokens": out}
