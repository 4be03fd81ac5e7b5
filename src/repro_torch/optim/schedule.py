"""LR schedules (pure functions of the step), ported from
``repro.optim.schedule``; computed in float32 as the reference's jnp
version is."""
from __future__ import annotations

import math

import numpy as np


def cosine_schedule(step, total: int, base_lr: float, warmup: int = 100,
                    final_frac: float = 0.1) -> float:
    f = np.float32
    step = f(step)
    w = np.minimum(f(1.0), (step + f(1)) / f(max(1, warmup)))
    prog = np.clip((step - f(warmup)) / f(max(1, total - warmup)), f(0.0),
                   f(1.0))
    cos = f(final_frac) + f(1 - final_frac) * f(0.5) * (
        f(1) + np.cos(f(math.pi) * prog))
    return float(f(base_lr) * w * cos)
