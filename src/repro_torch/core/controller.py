"""DynMo controller — the autonomous loop of Fig. 2, ported from
``repro.core.controller``:

  (2) dynamism alters the model -> (3) profile -> (4) balance -> (5)
  migrate & continue.

The controller consumes the per-slot stats every train step emits, decides
a new contiguous split on the host, and applies one migration (a gather
over params, optimizer moments and dyn state).  This slice ports the
synchronous controller with its straggler folding; re-packing onto fewer
workers and live expert re-layout raise ``NotImplementedError`` naming
their ROADMAP items.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import DistConfig, ModelConfig
from repro_torch.core import balancer as bal
from repro_torch.core import migration as mig
from repro_torch.core.cost_model import MEM_STATE_FACTOR
from repro_torch.core.profiler import LayerProfile
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.runtime.fault_tolerance import StragglerDetector


@dataclasses.dataclass
class ControllerConfig:
    method: str = "diffusion"        # partition | diffusion
    cost_by: str = "time"            # time | param
    rebalance_every: int = 1
    imbalance_threshold: float = 0.05  # skip rebalance below this ΔL
    mem_cap: float = float("inf")
    repack: bool = False             # raises: not in this slice
    expert_relayout: bool = False    # raises: not in this slice


@dataclasses.dataclass
class ControllerEvent:
    iteration: int
    imbalance_before: float
    imbalance_after: float
    moved_layers: int
    active_workers: int
    decision_s: float
    rebalanced: bool


class DynMoController:
    """Stateful controller owning the current assignment."""

    def __init__(self, cfg: ModelConfig, dcfg: DistConfig,
                 dyncfg: DynamicsConfig, ccfg: ControllerConfig,
                 layers_per_stage: Optional[Sequence[int]] = None,
                 straggler: Optional[StragglerDetector] = None):
        if ccfg.repack:
            raise NotImplementedError(
                "re-packing onto fewer workers (a live shrink) is not in "
                "repro_torch yet (ROADMAP Queue 1 [training]: repack, live "
                "resize)")
        if ccfg.expert_relayout:
            raise NotImplementedError(
                "live expert re-layout is not in repro_torch yet (ROADMAP "
                "Queue 1 [moe])")
        from repro_torch.models.model import uniform_boundaries
        self.cfg, self.dcfg, self.dyncfg, self.ccfg = cfg, dcfg, dyncfg, ccfg
        self.straggler = straggler
        self.lps: List[int] = list(
            layers_per_stage
            or uniform_boundaries(cfg.total_blocks(), dcfg.num_stages))
        self.pattern = cfg.block_pattern()
        self.events: List[ControllerEvent] = []
        self.active_workers = dcfg.num_stages

    def cadence(self, iteration: int) -> bool:
        """Whether the controller acts this iteration; the training loop
        gates its device -> host stats sync on this (paper §3.3.1)."""
        return iteration % max(1, self.ccfg.rebalance_every) == 0

    def decide(self, profile: LayerProfile, iteration: int
               ) -> Tuple[Optional[List[int]], ControllerEvent]:
        t0 = time.perf_counter()
        costs = (profile.time_per_layer if self.ccfg.cost_by == "time"
                 else profile.param_bytes)
        if (self.straggler is not None and self.ccfg.cost_by == "time"
                and self.straggler.initialized
                and len(self.straggler.times) == len(self.lps)):
            # a persistent straggler appears to DynMo exactly like load
            # imbalance (paper §1): fold the measured-vs-modelled per-stage
            # slowdown into each of the stage's layers
            expected = np.asarray(bal.stage_loads(costs, self.lps))
            slow = self.straggler.relative_slowdown(expected)
            costs = np.asarray(costs, dtype=np.float64) \
                * np.repeat(slow, self.lps)
        loads = bal.stage_loads(costs, self.lps)
        imb_before = bal.imbalance(loads)
        new_lps: Optional[List[int]] = None
        imb_after = imb_before
        if imb_before > self.ccfg.imbalance_threshold:
            res = bal.balance(
                self.ccfg.method, costs, self.dcfg.num_stages,
                max_slots=self.dcfg.slots_for(self.cfg),
                mem=profile.param_bytes * MEM_STATE_FACTOR,
                mem_cap=self.ccfg.mem_cap,
                init=self.lps if self.ccfg.method == "diffusion" else None)
            if res.imbalance < imb_before - 1e-9:
                new_lps = res.layers_per_stage
                imb_after = res.imbalance
        moved = 0
        if new_lps is not None:
            moved = mig.build_plan(self.lps, new_lps,
                                   self.dcfg.slots_for(self.cfg)).moved_layers
        ev = ControllerEvent(
            iteration=iteration, imbalance_before=imb_before,
            imbalance_after=imb_after, moved_layers=moved,
            active_workers=self.active_workers,
            decision_s=time.perf_counter() - t0,
            rebalanced=new_lps is not None)
        self.events.append(ev)
        return new_lps, ev

    def apply(self, new_lps: Sequence[int], params: Dict[str, Any],
              opt_state: Any, dyn: Dict[str, Any], cache: Any = None):
        """Migrate stage-keyed state to the new split; returns updated
        (params, opt_state, dyn, assignment, cache)."""
        stages, nopt, ndyn, assignment, ncache, _ = mig.migrate(
            params["stages"], opt_state, dyn, self.lps, new_lps,
            self.pattern, self.dcfg.slots_for(self.cfg), cache)
        self.lps = list(new_lps)
        params = dict(params)
        params["stages"] = stages
        return params, nopt, ndyn, assignment, ncache
