"""Frozen copies of the training loop's schedules, as the port's
``Session.train`` applies them: the learning rate (``optim.schedule``),
the gradual pruning share and its block count (``dynamics``), and the
uniform first split of the layers over the stage buffers."""
from __future__ import annotations

import math
from typing import List

import numpy as np

PRUNE_EVERY = 10          # the loop prunes after every tenth step


def cosine_lr(step: int, total: int, base_lr: float = 3e-4,
              warmup: int = 10, final_frac: float = 0.1) -> float:
    f = np.float32
    s = f(step)
    w = np.minimum(f(1.0), (s + f(1)) / f(max(1, warmup)))
    prog = np.clip((s - f(warmup)) / f(max(1, total - warmup)), f(0.0),
                   f(1.0))
    cos = f(final_frac) + f(1 - final_frac) * f(0.5) * (
        f(1) + np.cos(f(math.pi) * prog))
    return float(f(base_lr) * w * cos)


def sparsity(step: int, total: int, initial: float, final: float) -> float:
    """The cubic schedule the loop stretches over its ``total`` steps
    (the paper's Eq. 3 at iteration ``100 * step``)."""
    k, t1 = step * 100, total * 100
    if k >= t1:
        return final
    frac = k / max(1, t1)
    return final + (initial - final) * (1.0 - frac) ** 3


def keep_blocks(layers: int, blocks_per_layer: int, share: float) -> int:
    return max(layers, int(round(layers * blocks_per_layer * (1.0 - share))))


def live_blocks(step: int, total: int, layers: int, blocks_per_layer: int,
                initial: float, final: float) -> int:
    """FFN blocks live in step ``step``: every block until the first
    prune, then the count kept by the newest prune before this step."""
    last = (step - 1) // PRUNE_EVERY * PRUNE_EVERY
    if step <= PRUNE_EVERY or last <= 0:
        return layers * blocks_per_layer
    return keep_blocks(layers, blocks_per_layer,
                       sparsity(last, total, initial, final))


def uniform_split(layers: int, stages: int) -> List[int]:
    base, rem = divmod(layers, stages)
    return [base + (1 if s < rem else 0) for s in range(stages)]
