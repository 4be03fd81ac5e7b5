"""A frozen copy of the port's synthetic data (``repro_torch.data.synthetic``
and ``repro_torch.data.loader``), numpy only: Zipfian token blocks with a
bigram flavour, cut into [num_micro, mb_global, seq] batches with
next-token labels.  The benchmark makes the same batches the program's
loader makes from the same seed; a test holds the two equal."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def zipf_token_stream(vocab_size: int, seed: int, alpha: float = 1.1,
                      block: int = 1 << 16) -> Iterator[np.ndarray]:
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


def batches(vocab_size: int, num_micro: int, mb: int, seq: int,
            seed: int) -> Iterator[Dict[str, np.ndarray]]:
    """Step 0, 1, ... of the training stream: ``tokens`` and ``labels``
    [num_micro, mb, seq] int32."""
    need = num_micro * mb * (seq + 1)
    buf = np.empty(0, np.int32)
    for blk in zipf_token_stream(vocab_size, seed, block=max(1 << 16, need)):
        buf = np.concatenate([buf, blk])
        while len(buf) >= need:
            chunk, buf = buf[:need], buf[need:]
            toks = chunk.reshape(num_micro, mb, seq + 1)
            yield {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def take(vocab_size: int, num_micro: int, mb: int, seq: int, seed: int,
         steps) -> Dict[int, Dict[str, np.ndarray]]:
    """The batches of the given steps, by step."""
    want = sorted(set(steps))
    out = {}
    for step, b in enumerate(batches(vocab_size, num_micro, mb, seq, seed)):
        if step > want[-1]:
            break
        if step in want:
            out[step] = b
    return out
