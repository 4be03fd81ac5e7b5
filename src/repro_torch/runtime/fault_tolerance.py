"""Straggler detection — the training slice's part of
``repro.runtime.fault_tolerance`` (heartbeats, the worker pool and the rest
of the fault layer wait for ROADMAP Queue 1 [control-plane])."""
from __future__ import annotations

import numpy as np


class StragglerDetector:
    """EMA of per-stage step times; exposes slowdown multipliers ≥ 1 that
    the controller multiplies into the by-time cost vector."""

    def __init__(self, num_stages: int, ema: float = 0.9):
        self.ema = ema
        self.times = np.zeros(num_stages)
        self.initialized = False

    def reset(self, num_stages: int) -> None:
        """Forget the EMAs — required after an elastic resize (the stage
        set itself changed, old per-stage times are meaningless)."""
        self.times = np.zeros(num_stages)
        self.initialized = False

    def update(self, stage_times: np.ndarray) -> None:
        stage_times = np.asarray(stage_times, dtype=np.float64)
        if stage_times.shape != self.times.shape:
            self.reset(len(stage_times))
        if not self.initialized:
            self.times = stage_times.copy()
            self.initialized = True
        else:
            self.times = self.ema * self.times + (1 - self.ema) * stage_times

    def relative_slowdown(self, expected: np.ndarray) -> np.ndarray:
        """Scale-free variant of ``slowdown``: rescales ``expected`` to the
        measured total first, so a uniform calibration error in the cost
        model (absolute seconds off by a constant factor) does not read as
        every stage straggling — only *relative* skew between stages
        survives.  This is the multiplier the controller folds into the
        balancer's time cost vector."""
        expected = np.maximum(np.asarray(expected, dtype=np.float64), 1e-12)
        if not self.initialized:
            return np.ones_like(expected)
        scale = self.times.sum() / expected.sum()
        if scale <= 0:
            return np.ones_like(expected)
        return np.maximum(1.0, self.times / (expected * scale))
