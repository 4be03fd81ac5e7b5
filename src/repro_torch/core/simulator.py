"""Discrete-event pipeline simulator, ported from ``repro.core.simulator``
onto the port's balancer, repack policy and cost model.

Reproduces the paper's evaluation (Figs. 1, 3, 4) without devices: per-layer
fwd/bwd times come from the calibrated cost model (or measured profiles),
dynamism trajectories evolve them over iterations, and the simulator computes
step makespans, per-stage idleness (bubble ratio), and end-to-end throughput
for static (Megatron-uniform / DeepSpeed-param) vs DynMo (Partition /
Diffusion x by-param / by-time) balancing, including DynMo's own overhead
(profiling + algorithm + migration) and optional re-packing.  It keeps the
reference's cost constants (``ICI_BW`` as the migration bandwidth), so its
numbers are the reference's: a model of a cluster, not a measurement of
any device.

Schedules: GPipe and non-interleaved 1F1B.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import balancer as bal
from repro_torch.core import repack as rp
from repro_torch.core.cost_model import ICI_BW


@dataclasses.dataclass
class SimResult:
    makespan: float
    bubble_ratio: float          # idle fraction across stages
    stage_busy: np.ndarray
    throughput: float = 0.0      # tokens/sec (filled by callers)


def simulate_pipeline(fwd: Sequence[float], bwd: Sequence[float],
                      num_micro: int, comm: float = 0.0,
                      schedule: str = "1f1b") -> SimResult:
    """Event-driven makespan of one step on S stages with per-stage op times.

    Dependencies: F[s,k] ← F[s-1,k]+comm; B[s,k] ← B[s+1,k]+comm and F[s,k];
    ops on one stage execute in the schedule's per-stage order.
    """
    S, m = len(fwd), num_micro
    order: List[List[Tuple[str, int]]] = []
    for s in range(S):
        ops: List[Tuple[str, int]] = []
        if schedule == "gpipe":
            ops += [("F", k) for k in range(m)]
            ops += [("B", k) for k in range(m)]
        else:  # 1f1b (non-interleaved)
            w = min(m, S - s)
            ops += [("F", k) for k in range(w)]
            nf, nb = w, 0
            while nf < m or nb < m:
                if nb < m:
                    ops.append(("B", nb))
                    nb += 1
                if nf < m:
                    ops.append(("F", nf))
                    nf += 1
        order.append(ops)

    end: Dict[Tuple[str, int, int], float] = {}
    ptr = [0] * S
    stage_free = [0.0] * S
    busy = np.zeros(S)
    remaining = sum(len(o) for o in order)
    while remaining:
        progressed = False
        for s in range(S):
            if ptr[s] >= len(order[s]):
                continue
            kind, k = order[s][ptr[s]]
            if kind == "F":
                dep = 0.0 if s == 0 else end.get(("F", s - 1, k))
                if dep is None:
                    continue
                start = max(stage_free[s], dep + (comm if s else 0.0))
                dur = fwd[s]
            else:
                dep_b = 0.0 if s == S - 1 else end.get(("B", s + 1, k))
                dep_f = end.get(("F", s, k))
                if dep_b is None or dep_f is None:
                    continue
                start = max(stage_free[s],
                            dep_b + (comm if s < S - 1 else 0.0), dep_f)
                dur = bwd[s]
            end[(kind, s, k)] = start + dur
            stage_free[s] = start + dur
            busy[s] += dur
            ptr[s] += 1
            remaining -= 1
            progressed = True
        if not progressed:
            raise RuntimeError("schedule deadlock (bug)")
    makespan = max(stage_free)
    denom = max(1e-12, S * makespan)
    bubble = 1.0 - float(busy.sum()) / denom
    return SimResult(makespan, bubble, busy)


def stage_times_from_layers(layer_fwd: np.ndarray, layer_bwd: np.ndarray,
                            layers_per_stage: Sequence[int]
                            ) -> Tuple[np.ndarray, np.ndarray]:
    f, b, i = [], [], 0
    for n in layers_per_stage:
        f.append(float(layer_fwd[i:i + n].sum()))
        b.append(float(layer_bwd[i:i + n].sum()))
        i += n
    return np.asarray(f), np.asarray(b)


@dataclasses.dataclass
class TrainSimConfig:
    num_stages: int
    num_micro: int
    tokens_per_iter: int
    iters: int = 10000
    sample_every: int = 50            # evaluate the makespan this often
    rebalance_every: int = 0          # 0 = static
    balancer: str = "uniform"         # uniform | dsparam | partition | diffusion
    cost_by: str = "time"             # time | param
    schedule: str = "1f1b"
    comm: float = 0.0
    max_slots: int = 10 ** 9
    repack: bool = False
    repack_mem_cap: float = float("inf")
    layer_mem: Optional[np.ndarray] = None
    migration_bw: float = ICI_BW
    profile_overhead_frac: float = 1.0   # one profiling iteration's cost


@dataclasses.dataclass
class TrainSimResult:
    total_time: float
    throughput: float
    avg_bubble: float
    avg_active_workers: float
    overhead_frac: float
    overhead_breakdown: Dict[str, float]
    bubble_history: List[Tuple[int, float]]
    imbalance_history: List[Tuple[int, float]]


def simulate_training(layer_time_fn: Callable[[int], Tuple[np.ndarray,
                                                           np.ndarray]],
                      layer_param_bytes: np.ndarray,
                      sim: TrainSimConfig) -> TrainSimResult:
    """End-to-end training simulation.

    ``layer_time_fn(k)`` returns (fwd_times, bwd_times) per *layer* at
    iteration k (the dynamism trajectory).  Balancers see the by-time or
    by-param cost vector (profiled at the last profile iteration, like the
    real system — rebalance acts on slightly stale data, faithfully).
    """
    S = sim.num_stages
    L = len(layer_param_bytes)
    lps = bal.balance("uniform", np.ones(L), S,
                      max_slots=sim.max_slots).layers_per_stage
    if sim.balancer == "dsparam" and sim.rebalance_every == 0:
        lps = bal.partition_balance(layer_param_bytes, S,
                                    max_slots=sim.max_slots).layers_per_stage
    total, tokens = 0.0, 0.0
    t_overhead = {"profile": 0.0, "algorithm": 0.0, "migration": 0.0}
    bubbles, imbs = [], []
    busy_w = 0.0
    active_workers = S
    aw_acc, n_samples = 0.0, 0
    reb_round = max(sim.sample_every,
                    (sim.rebalance_every // max(1, sim.sample_every))
                    * sim.sample_every) if sim.rebalance_every else 0
    for k in range(0, sim.iters, sim.sample_every):
        f_l, b_l = layer_time_fn(k)
        # rebalance?
        if reb_round and k and k % reb_round == 0:
            costs = (f_l + b_l) if sim.cost_by == "time" \
                else layer_param_bytes
            method = {"partition": "partition", "diffusion": "diffusion",
                      "dsparam": "partition",
                      "uniform": "uniform"}[sim.balancer]
            t0 = _time.perf_counter()
            res = bal.balance(method, costs, S, max_slots=sim.max_slots,
                              init=lps if method == "diffusion" else None)
            t_alg = _time.perf_counter() - t0
            new_lps = res.layers_per_stage
            moved = _moved_bytes(lps, new_lps, layer_param_bytes)
            t_overhead["algorithm"] += t_alg
            t_overhead["migration"] += moved / sim.migration_bw
            step_now = simulate_pipeline(
                *stage_times_from_layers(f_l, b_l, lps), sim.num_micro,
                sim.comm, sim.schedule).makespan
            t_overhead["profile"] += step_now * sim.profile_overhead_frac
            lps = new_lps
            if sim.repack and sim.layer_mem is not None:
                mem_stage = bal.stage_loads(sim.layer_mem, lps)
                plan = rp.repack_adjacent(mem_stage, lps,
                                          sim.repack_mem_cap)
                t_overhead["migration"] += _moved_bytes(
                    lps, plan.layers_per_stage, layer_param_bytes) \
                    / sim.migration_bw
                lps = plan.layers_per_stage
                active_workers = plan.num_active
        fwd_s, bwd_s = stage_times_from_layers(f_l, b_l, lps)
        r = simulate_pipeline(fwd_s, bwd_s, sim.num_micro, sim.comm,
                              sim.schedule)
        total += r.makespan * sim.sample_every
        tokens += sim.tokens_per_iter * sim.sample_every
        busy_w += r.bubble_ratio * sim.sample_every
        aw_acc += active_workers
        n_samples += 1
        bubbles.append((k, r.bubble_ratio))
        imbs.append((k, bal.imbalance(fwd_s + bwd_s)))
    oh = sum(t_overhead.values())
    total += oh
    return TrainSimResult(
        total_time=total, throughput=tokens / total,
        avg_bubble=busy_w / max(1, sim.iters),
        avg_active_workers=aw_acc / max(1, n_samples),
        overhead_frac=oh / max(1e-12, total),
        overhead_breakdown=t_overhead,
        bubble_history=bubbles, imbalance_history=imbs)


def _moved_bytes(old_lps: Sequence[int], new_lps: Sequence[int],
                 layer_bytes: np.ndarray) -> float:
    """Bytes migrated between stages when the contiguous split changes:
    layers whose stage changed, weighted ×4 (weights + grads + 2 opt
    moments), matching the paper's migration of full layer state."""
    def owner(lps):
        out = []
        for s, n in enumerate(lps):
            out += [s] * n
        return np.asarray(out)
    o1, o2 = owner(old_lps), owner(new_lps)
    n = min(len(o1), len(o2))
    moved = o1[:n] != o2[:n]
    return float((layer_bytes[:n] * moved).sum() * 4.0)
