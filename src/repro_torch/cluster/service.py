"""The DynMo decision service (paper §3.3.1), ported from
``repro.cluster.service`` in its synchronous mode.

The training loop talks to the controller only through ``ControlPlane``:
it *publishes* a host-side ``StatsSnapshot`` on controller cadence, *polls*
the finished ``DecisionPlan`` at its next safe point, and *applies* the
plan's migration there.  Plans are fenced by the engine's world epoch, so a
plan decided against another world is never applied.  With
``async_mode=False`` (the only mode of this slice) the decision runs on the
publishing thread — the reference's inline path, bit-identical to its
asynchronous one by construction.  The background thread waits for ROADMAP
Queue 1 [training] (async control plane).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.controller import ControllerEvent, DynMoController
from repro_torch.core.profiler import profile_from_stats


@dataclasses.dataclass
class StatsSnapshot:
    """Host-side view of one profiling iteration, tagged with the engine
    epoch it was observed in."""
    iteration: int
    epoch: int
    stats: Dict[str, np.ndarray]        # folded [S, L_max, ...] (host)
    tags: np.ndarray                    # [S, L_max] slot -> layer type
    num_micro: int
    tokens: int
    seq: int
    frozen: Optional[np.ndarray] = None
    stage_times: Optional[np.ndarray] = None   # per-stage seconds (feeds
    #   the controller's StragglerDetector when one is attached)


@dataclasses.dataclass
class DecisionPlan:
    """One controller decision, fenced by the epoch of the world it was
    decided against.  ``new_lps`` is the in-mesh migration's split (None:
    keep the current one)."""
    epoch: int
    iteration: int
    new_lps: Optional[List[int]]
    event: ControllerEvent
    decide_s: float


class ControlPlane:
    """Runs the controller's decisions for the training loop."""

    def __init__(self, ctrl: DynMoController, *, async_mode: bool = False,
                 epoch_fn: Optional[Callable[[], int]] = None):
        if async_mode:
            raise NotImplementedError(
                "the asynchronous control plane (decisions on a background "
                "thread) is not in repro_torch yet (ROADMAP Queue 1 "
                "[training]: async ControlPlane)")
        self.ctrl = ctrl
        self.async_mode = False
        self.epoch_fn = epoch_fn
        self._outbox: Optional[DecisionPlan] = None
        self.published = 0
        self.decided = 0
        self.dropped = 0
        self.stale_rejected = 0

    def publish(self, snap: StatsSnapshot) -> None:
        """Decide on ``snap`` now and post the plan (latest wins)."""
        self.published += 1
        self._outbox = self._decide(snap)

    def poll(self, epoch: int) -> Optional[DecisionPlan]:
        """Fetch the newest finished plan, or None; a plan decided against
        another epoch is rejected."""
        plan, self._outbox = self._outbox, None
        if plan is None:
            return None
        if plan.epoch != epoch:
            self.stale_rejected += 1
            return None
        return plan

    def apply(self, plan: DecisionPlan, params, opt_state, dyn, cache=None):
        """Apply a rebalance plan's migration at a safe point."""
        return self.ctrl.apply(plan.new_lps, params, opt_state, dyn, cache)

    def _decide(self, snap: StatsSnapshot) -> Optional[DecisionPlan]:
        if self.epoch_fn is not None and self.epoch_fn() != snap.epoch:
            self.stale_rejected += 1
            return None
        t0 = time.perf_counter()
        ctrl = self.ctrl
        if snap.stage_times is not None and ctrl.straggler is not None:
            ctrl.straggler.update(snap.stage_times)
        profile = profile_from_stats(
            ctrl.cfg, snap.stats, snap.tags, snap.num_micro, snap.tokens,
            snap.seq, frozen=snap.frozen,
            bytes_per_param=ctrl.dcfg.bytes_per_param)
        new_lps, ev = ctrl.decide(profile, snap.iteration)
        self.decided += 1
        return DecisionPlan(epoch=snap.epoch, iteration=snap.iteration,
                            new_lps=new_lps, event=ev,
                            decide_s=time.perf_counter() - t0)
