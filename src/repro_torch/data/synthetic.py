"""Synthetic corpora: Zipfian token streams with local structure (Markov
bigram flavor) so small models show real loss descent, plus a tiny embedded
text corpus for tokenizer round-trips.  Deterministic by seed."""
from __future__ import annotations

from typing import Iterator

import numpy as np

_TEXT = (
    "the quick brown fox jumps over the lazy dog . "
    "pipeline parallel training of dynamic language models introduces "
    "load imbalance across workers . dynmo rebalances layers between "
    "stages whenever the workload drifts , and re-packs the model onto "
    "fewer accelerators when the total work shrinks . "
) * 64


def synthetic_corpus() -> str:
    return _TEXT


def zipf_token_stream(vocab_size: int, seed: int = 0, alpha: float = 1.1,
                      block: int = 1 << 16) -> Iterator[np.ndarray]:
    """Endless stream of token blocks with Zipf marginals and bigram
    structure (each token biases the next toward a deterministic successor,
    giving the model something learnable)."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** -alpha
    probs /= probs.sum()
    succ = rng.permutation(vocab_size)
    while True:
        base = rng.choice(vocab_size, size=block, p=probs)
        coin = rng.rand(block) < 0.35
        out = base.copy()
        out[1:][coin[1:]] = succ[out[:-1][coin[1:]]]
        yield out.astype(np.int32)
