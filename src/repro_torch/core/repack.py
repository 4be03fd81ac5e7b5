"""Workload re-packing (paper §3.4, Algorithm 2), ported from
``repro.core.repack`` (plain numpy, the same policies): first-fit
consolidation of pipeline stages onto fewer workers subject to memory
capacity, so idle workers can be released back to the job manager.

The controller turns a plan that empties stages into a ``ResizePlan``; the
engine then rebuilds the stage buffers at the smaller stage count (a live
shrink, ``launch.engine.ElasticEngine.shrink``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass
class RepackPlan:
    transfers: List[Tuple[int, int, int]]   # (src_stage, dst_stage, layer_idx)
    active_workers: List[int]               # 0/1 per stage after packing
    mem_usage: List[float]                  # per-stage memory after packing
    layers_per_stage: List[int]             # new layer counts

    @property
    def num_active(self) -> int:
        return int(sum(self.active_workers))


def repack_first_fit(mem_usage: Sequence[float], num_layers: Sequence[int],
                     max_mem: float, target_num_workers: int = 1,
                     max_layers: int = 10 ** 9) -> RepackPlan:
    """Algorithm 2 (faithful): iterate worker pairs (src, dst>src); if their
    combined memory fits one worker's budget and we are still above the
    target count, migrate all of src's layers to dst and deactivate src.
    ``max_layers`` bounds a worker's slot capacity (L_max)."""
    mem = list(map(float, mem_usage))
    nl = list(map(int, num_layers))
    n = len(mem)
    active = [1] * n
    transfers: List[Tuple[int, int, int]] = []
    for src in range(n):
        if not active[src]:
            continue
        for dst in range(src + 1, n):
            if not active[dst]:
                continue
            if (mem[src] + mem[dst] < max_mem
                    and sum(active) > target_num_workers
                    and nl[src] > 0
                    and nl[src] + nl[dst] <= max_layers):
                active[src] = 0
                for lyr in range(nl[src]):
                    transfers.append((src, dst, lyr))
                mem[dst] += mem[src]
                mem[src] = 0.0
                nl[dst] += nl[src]
                nl[src] = 0
                break
    return RepackPlan(transfers, active, mem, nl)


def repack_adjacent(mem_usage: Sequence[float], num_layers: Sequence[int],
                    max_mem: float, target_num_workers: int = 1,
                    max_layers: int = 10 ** 9) -> RepackPlan:
    """Pipeline-order-preserving variant (beyond-paper): only merge adjacent
    stages so the contiguous layer order is kept and migrations are single-hop
    ppermutes.  First-fit over adjacent pairs, repeated to fixpoint.
    ``max_layers`` bounds a worker's slot capacity (L_max)."""
    mem = list(map(float, mem_usage))
    nl = list(map(int, num_layers))
    n = len(mem)
    active = [1] * n
    transfers: List[Tuple[int, int, int]] = []
    changed = True
    while changed and sum(active) > target_num_workers:
        changed = False
        i = 0
        order = [s for s in range(n) if active[s]]
        for a, b in zip(order, order[1:]):
            if sum(active) <= target_num_workers:
                break
            if (mem[a] + mem[b] < max_mem and nl[a] > 0
                    and nl[a] + nl[b] <= max_layers):
                active[a] = 0
                for lyr in range(nl[a]):
                    transfers.append((a, b, lyr))
                mem[b] += mem[a]
                mem[a] = 0.0
                nl[b] += nl[a]
                nl[a] = 0
                changed = True
                break
    return RepackPlan(transfers, active, mem, nl)


REPACK_POLICIES = {
    "first_fit": repack_first_fit,   # Algorithm 2 as written
    "adjacent": repack_adjacent,     # order-preserving variant
}


def repack(policy: str, mem_usage: Sequence[float],
           num_layers: Sequence[int], max_mem: float,
           target_num_workers: int = 1,
           max_layers: int = 10 ** 9) -> RepackPlan:
    """Policy-dispatched consolidation; the controller selects via
    ``ControllerConfig.repack_policy``."""
    try:
        fn = REPACK_POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown repack policy {policy!r}; have "
            f"{sorted(REPACK_POLICIES)}")
    return fn(mem_usage, num_layers, max_mem, target_num_workers, max_layers)
