"""DynMo controller — the autonomous loop of Fig. 2, ported from
``repro.core.controller``:

  (2) dynamism alters the model -> (3) profile -> (4) balance (+ optionally
  re-pack) -> (5) migrate & continue.

The controller consumes the per-slot stats every train step emits, decides
a new contiguous split on the host, and applies one migration (a gather
over params, optimizer moments and dyn state).  With ``repack`` on it also
decides, on every cadence, whether the stages fit onto fewer workers under
the memory budget; such a decision is a ``ResizePlan`` the engine executes
as a live shrink at the next safe point.  The straggler folding and the
live expert re-layout decision (applied at a safe point) are the
reference's too.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import DistConfig, ModelConfig
from repro_torch.core import balancer as bal
from repro_torch.core import expert_layout as el
from repro_torch.core import migration as mig
from repro_torch.core import repack as rp
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
    repack: bool = False
    repack_policy: str = "adjacent"  # adjacent | first_fit
    # per-worker repack budget in ABSOLUTE bytes (the trainer converts its
    # --repack-mem-cap capacity factor into this)
    repack_mem_cap: float = float("inf")
    repack_target: int = 1
    mem_cap: float = float("inf")
    # live expert re-layout (MoE archs with the grouped kernels)
    expert_relayout: bool = False
    expert_watermark: float = 2.0     # max/mean routed-load trigger
    expert_min_tokens: int = 16       # ignore windows below this total


@dataclasses.dataclass
class ControllerEvent:
    iteration: int
    imbalance_before: float
    imbalance_after: float
    moved_layers: int
    active_workers: int
    decision_s: float
    rebalanced: bool
    # MoE telemetry (defaults keep non-MoE call sites untouched)
    expert_skew: float = 0.0          # measured max/mean routed load
    expert_dropped: float = 0.0       # capacity-overflow drop fraction
    relayout: bool = False            # a re-layout plan was emitted


@dataclasses.dataclass
class ResizePlan:
    """A repack decision the elastic runtime acts on live: rebuild the
    pipeline on ``target_stages`` workers and release the rest to the job
    manager (paper §3.4, Alg. 2).  ``layers_per_stage`` is the compacted
    per-surviving-stage layer count in pipeline order (None: a uniform
    split); the engine re-splits uniformly if a count exceeds the shrunk
    world's slot capacity.  ``released_stages`` names the logical stages
    the packing emptied; the released WORKER ids are the engine's (the tail
    of its stage -> worker map, ``ResizeEvent.workers``).
    ``mem_per_stage`` is the memory of the contiguous groups the engine
    will execute."""
    iteration: int
    target_stages: int
    layers_per_stage: Optional[List[int]]
    released_stages: List[int]
    policy: str
    mem_per_stage: List[float]


class DynMoController:
    """Stateful controller owning the current assignment."""

    def __init__(self, cfg: ModelConfig, dcfg: DistConfig,
                 dyncfg: DynamicsConfig, ccfg: ControllerConfig,
                 layers_per_stage: Optional[Sequence[int]] = None,
                 straggler: Optional[StragglerDetector] = None,
                 mesh=None):
        from repro_torch.models.model import uniform_boundaries
        self.cfg, self.dcfg, self.dyncfg, self.ccfg = cfg, dcfg, dyncfg, ccfg
        self.straggler = straggler
        # across ranks (a launch.mesh.Mesh) ``apply`` moves rows between
        # them; every rank's controller decides from the same gathered
        # inputs, so every rank applies the same plan
        self.mesh = mesh
        self.lps: List[int] = list(
            layers_per_stage
            or uniform_boundaries(cfg.total_blocks(), dcfg.num_stages))
        self.pattern = cfg.block_pattern()
        self.events: List[ControllerEvent] = []
        self.active_workers = dcfg.num_stages
        self.pending_resize: Optional[ResizePlan] = None
        self.expected_loads: Optional[List[float]] = None
        # expert placement: the controller owns the LOGICAL layout; the
        # runtime mirrors it into dyn["expert_map"] at safe points, and the
        # layout advances only when a plan is applied (commit_relayout)
        self.expert_layout = (el.ExpertLayout.identity(cfg.num_experts)
                              if cfg.num_experts else None)
        self.pending_relayout: Optional[el.ExpertRelayoutPlan] = None
        self.relayouts: List[el.ExpertRelayoutPlan] = []

    def cadence(self, iteration: int) -> bool:
        """Whether the controller acts this iteration; the training loop
        gates its device -> host stats sync on this (paper §3.3.1)."""
        return iteration % max(1, self.ccfg.rebalance_every) == 0

    def take_resize(self) -> Optional[ResizePlan]:
        """Consume the pending repack decision (the engine's shrink
        trigger)."""
        plan, self.pending_resize = self.pending_resize, None
        return plan

    def take_expert_relayout(self) -> Optional[el.ExpertRelayoutPlan]:
        """Consume the pending expert re-layout (safe-point apply)."""
        plan, self.pending_relayout = self.pending_relayout, None
        return plan

    def commit_relayout(self, plan: el.ExpertRelayoutPlan):
        """Record that a re-layout plan was applied to the model's
        expert_map; only now does the controller's layout advance."""
        self.expert_layout = plan.new
        self.relayouts.append(plan)
        return self

    def rebind(self, dcfg: DistConfig, layers_per_stage: Sequence[int]):
        """Re-anchor the controller after the engine rebuilt its world
        (shrink / grow / evict): new stage count, new split, no pending
        plan, and fresh straggler EMAs (per-stage times of another stage
        set mean nothing).  The expert layout survives: placement is per
        expert, and the expert_map dyn leaf rides the resize."""
        self.dcfg = dcfg
        self.lps = list(layers_per_stage)
        self.active_workers = dcfg.num_stages
        self.pending_resize = None
        self.pending_relayout = None
        if self.straggler is not None:
            self.straggler.reset(dcfg.num_stages)

    def decide(self, profile: LayerProfile, iteration: int
               ) -> Tuple[Optional[List[int]], ControllerEvent]:
        t0 = time.perf_counter()
        self.pending_resize = None      # stale unconsumed plans don't linger
        self.pending_relayout = None
        expert_skew = 0.0
        if profile.expert_load is not None and self.expert_layout is not None:
            expert_skew, _ = el.measure_skew(profile.expert_load)
            if self.ccfg.expert_relayout:
                self.pending_relayout = el.build_relayout(
                    profile.expert_load, self.expert_layout,
                    watermark=self.ccfg.expert_watermark,
                    min_tokens=self.ccfg.expert_min_tokens,
                    iteration=iteration)
        costs = (profile.time_per_layer if self.ccfg.cost_by == "time"
                 else profile.param_bytes)
        # the cost model's per-stage loads of this profile, before any
        # measured slowdown is folded in (telemetry beside measured times)
        self.expected_loads = [float(x) for x in
                               bal.stage_loads(costs, self.lps)]
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
        if self.ccfg.repack:
            # evaluated on every cadence, not only after a rebalance:
            # uniform dynamism (global pruning) keeps the split balanced
            # while the memory still shrinks
            cand = list(new_lps) if new_lps is not None else list(self.lps)
            mem_layers = profile.param_bytes * MEM_STATE_FACTOR
            mem_stage = bal.stage_loads(mem_layers, cand)
            # counts bounded by the CURRENT world's slot capacity, which
            # every smaller world's capacity dominates
            plan = rp.repack(self.ccfg.repack_policy, mem_stage, cand,
                             self.ccfg.repack_mem_cap,
                             self.ccfg.repack_target,
                             max_layers=self.dcfg.slots_for(self.cfg))
            if plan.num_active < len(cand):
                compact = [plan.layers_per_stage[s] for s in range(len(cand))
                           if plan.active_workers[s]]
                # the engine executes the counts as a CONTIGUOUS split
                # (first_fit may have grouped other layers): re-check it
                # against the budget; a group no heavier than today's worst
                # stage is no regression even above the cap
                limit = max(self.ccfg.repack_mem_cap, max(mem_stage))
                # the packing decides who survives; the split the shrunk
                # world executes is re-balanced on the time costs
                compact = self._balance_resize_split(
                    costs, mem_layers, compact, plan.num_active, limit)
                contiguous_mem = bal.stage_loads(mem_layers, compact)
                if all(m < limit for m in contiguous_mem):
                    self.pending_resize = ResizePlan(
                        iteration=iteration,
                        target_stages=plan.num_active,
                        layers_per_stage=compact,
                        released_stages=[s for s in range(len(cand))
                                         if not plan.active_workers[s]],
                        policy=self.ccfg.repack_policy,
                        mem_per_stage=[float(m) for m in contiguous_mem])
                    # the resize supersedes the in-mesh migration: its
                    # re-split moves every layer anyway
                    new_lps = None
                    imb_after = imb_before
        moved = 0
        if new_lps is not None:
            moved = mig.build_plan(self.lps, new_lps,
                                   self.dcfg.slots_for(self.cfg)).moved_layers
        ev = ControllerEvent(
            iteration=iteration, imbalance_before=imb_before,
            imbalance_after=imb_after, moved_layers=moved,
            active_workers=self.active_workers,
            decision_s=time.perf_counter() - t0,
            rebalanced=new_lps is not None,
            expert_skew=expert_skew,
            expert_dropped=profile.moe_drop_frac,
            relayout=self.pending_relayout is not None)
        self.events.append(ev)
        return new_lps, ev

    def _balance_resize_split(self, costs, mem_layers, compact,
                              target_stages: int, mem_cap: float
                              ) -> List[int]:
        """Fold the balancer's time costs into a resize's target split.
        ``compact`` (the repack policy's merged per-survivor counts) is the
        fallback when the balanced split is infeasible or no better."""
        target_dcfg = dataclasses.replace(self.dcfg,
                                          num_stages=target_stages)
        try:
            res = bal.balance(
                self.ccfg.method, costs, target_stages,
                max_slots=target_dcfg.slots_for(self.cfg),
                mem=mem_layers, mem_cap=mem_cap,
                init=compact if self.ccfg.method == "diffusion" else None)
        except Exception:
            return compact
        balanced = list(res.layers_per_stage)
        if (len(balanced) != target_stages or min(balanced) < 1
                or sum(balanced) != sum(compact)):
            return compact
        balanced_fits = all(m < mem_cap for m in
                            bal.stage_loads(mem_layers, balanced))
        compact_fits = all(m < mem_cap for m in
                           bal.stage_loads(mem_layers, compact))
        if balanced_fits and not compact_fits:
            # the packing's counts regroup over budget when executed
            # contiguously: a memory-feasible balanced split rescues it
            return balanced
        if (max(bal.stage_loads(costs, balanced))
                > max(bal.stage_loads(costs, compact)) - 1e-12):
            return compact
        return balanced

    def apply(self, new_lps: Sequence[int], params: Dict[str, Any],
              opt_state: Any, dyn: Dict[str, Any], cache: Any = None):
        """Migrate stage-keyed state to the new split; returns updated
        (params, opt_state, dyn, assignment, cache).  A rank outside the
        mesh's world (None trees) gets the assignment alone."""
        stages, nopt, ndyn, assignment, ncache, _ = mig.migrate(
            None if params is None else params["stages"], opt_state, dyn,
            self.lps, new_lps, self.pattern, self.dcfg.slots_for(self.cfg),
            cache, mesh=self.mesh)
        self.lps = list(new_lps)
        if params is not None:
            params = dict(params)
            params["stages"] = stages
        return params, nopt, ndyn, assignment, ncache
