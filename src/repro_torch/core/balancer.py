"""DynMo load balancers (paper §3.3).

Both balancers map a per-layer cost vector onto S contiguous stages,
minimising the bottleneck (max stage cost) — the imbalance ΔL of Eq. (2) is
monotone in the bottleneck, so bottleneck-minimisation ⇔ maximum imbalance
reduction (Lemmas 1 & 2).

``Partition``  — centralized: binary search on the bottleneck value with a
                 greedy feasibility probe (DeepSpeed partition_balanced
                 style), by parameter count or by measured layer time.
``Diffusion``  — decentralized iterative: neighbor-to-neighbor single-layer
                 transfers from overloaded to underloaded stages; Lyapunov
                 potential (sum of pairwise load gaps) strictly decreases;
                 round bound per Lemma 2.

Both respect per-stage slot capacity (L_max) and optional per-stage memory
capacity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class BalanceResult:
    layers_per_stage: List[int]
    bottleneck: float
    imbalance: float            # ΔL of Eq. (2)
    rounds: int = 0             # diffusion iterations (0 for partition)

    @property
    def boundaries(self) -> List[int]:
        out, acc = [], 0
        for n in self.layers_per_stage:
            acc += n
            out.append(acc)
        return out


def imbalance(loads: Sequence[float]) -> float:
    """ΔL^(k) of Eq. (2): (Lmax - Lmin) / mean."""
    loads = np.asarray(loads, dtype=np.float64)
    m = loads.mean()
    if m <= 0:
        return 0.0
    return float((loads.max() - loads.min()) / m)


def stage_loads(costs: Sequence[float], layers_per_stage: Sequence[int]
                ) -> np.ndarray:
    loads, i = [], 0
    for n in layers_per_stage:
        loads.append(float(np.sum(costs[i:i + n])))
        i += n
    return np.asarray(loads)


def _feasible(costs: np.ndarray, S: int, cap: float, max_slots: int,
              mem: Optional[np.ndarray], mem_cap: float) -> Optional[List[int]]:
    """Greedy probe: can we split into ≤ S contiguous stages with stage cost
    ≤ cap, ≤ max_slots layers and ≤ mem_cap memory each?"""
    out, cur_c, cur_n, cur_m, used = [], 0.0, 0, 0.0, 1
    for j, c in enumerate(costs):
        mj = float(mem[j]) if mem is not None else 0.0
        over = (cur_c + c > cap or cur_n + 1 > max_slots
                or (mem is not None and cur_m + mj > mem_cap))
        if over and cur_n > 0:
            out.append(cur_n)
            used += 1
            cur_c, cur_n, cur_m = 0.0, 0, 0.0
            if used > S:
                return None
        if c > cap or (mem is not None and mj > mem_cap):
            return None                      # single layer violates cap
        cur_c += c
        cur_n += 1
        cur_m += mj
    out.append(cur_n)
    if len(out) > S:
        return None
    # pad empty stages at the end (allowed: re-packing uses them)
    out += [0] * (S - len(out))
    return out


def partition_balance(costs: Sequence[float], num_stages: int,
                      max_slots: int = 10 ** 9,
                      mem: Optional[Sequence[float]] = None,
                      mem_cap: float = float("inf"),
                      iters: int = 48) -> BalanceResult:
    """Centralized balancer: minimal-bottleneck contiguous partition via
    binary search on the bottleneck + greedy feasibility probe.

    Optimal to within float tolerance: the returned bottleneck is ≤ any
    feasible contiguous partition's bottleneck (tested property).
    """
    costs = np.asarray(costs, dtype=np.float64)
    assert len(costs) >= 1
    mem_arr = None if mem is None else np.asarray(mem, dtype=np.float64)
    lo = float(costs.max())
    hi = float(costs.sum())
    best = None
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        probe = _feasible(costs, num_stages, mid, max_slots, mem_arr, mem_cap)
        if probe is not None:
            best, hi = probe, mid
        else:
            lo = mid
    if best is None:
        best = _feasible(costs, num_stages, hi, max_slots, mem_arr, mem_cap)
    if best is None:
        raise ValueError("infeasible: capacity/memory constraints too tight")
    best = _rebalance_empty(costs, best, max_slots)
    loads = stage_loads(costs, best)
    return BalanceResult(best, float(loads.max()), imbalance(loads))


def _rebalance_empty(costs: np.ndarray, lps: List[int],
                     max_slots: int) -> List[int]:
    """Greedy probing can leave trailing empty stages.  An empty stage is a
    harmless relay (that is exactly how re-packed shadow stages work), but
    when there are enough layers we cosmetically spread one layer into each
    empty stage: decrementing a donor and incrementing the empty stage keeps
    the split contiguous (all spans in between shift by one)."""
    lps = list(lps)
    S = len(lps)
    if sum(lps) < S:
        return lps
    for s in range(S):
        if lps[s] == 0:
            cand = [d for d in range(S) if lps[d] > 1]
            if not cand:
                break
            d = min(cand, key=lambda dd: (abs(dd - s), -lps[dd]))
            lps[d] -= 1
            lps[s] += 1
    return lps


def diffusion_balance(costs: Sequence[float], num_stages: int,
                      max_slots: int = 10 ** 9,
                      mem: Optional[Sequence[float]] = None,
                      mem_cap: float = float("inf"),
                      gamma: float = 1e-3,
                      max_rounds: Optional[int] = None,
                      init: Optional[Sequence[int]] = None) -> BalanceResult:
    """Decentralized diffusion balancer: odd/even alternating neighbor
    exchanges of boundary layers, accepted only if they strictly reduce the
    pair's local potential |L_i − L_{i+1}| (Lyapunov descent ⇒ convergence;
    round bound per Lemma 2)."""
    costs = np.asarray(costs, dtype=np.float64)
    S = num_stages
    mem_arr = None if mem is None else np.asarray(mem, dtype=np.float64)
    if init is None:
        base = len(costs) // S
        rem = len(costs) % S
        lps = [min(max_slots, base + (1 if s < rem else 0)) for s in range(S)]
        # fix any total mismatch from capacity clamping
        deficit = len(costs) - sum(lps)
        s = 0
        while deficit > 0:
            if lps[s] < max_slots:
                lps[s] += 1
                deficit -= 1
            s = (s + 1) % S
    else:
        lps = list(init)

    Sn = float(costs.sum())
    if max_rounds is None:
        # Lemma 2 bound: O(min{N^2 log(SN/γ) log N, S N log N / γ})
        n = max(2, S)
        b1 = n * n * math.log(max(Sn * n / max(gamma, 1e-9), 2.0)) \
            * math.log(n)
        b2 = Sn * n * math.log(n) / max(gamma, 1e-9)
        max_rounds = int(min(max(64, b1), max(64, b2))) + 1
        max_rounds = min(max_rounds, 10000)

    def bounds_ok(lps_, s):
        if lps_[s] > max_slots or lps_[s] < 0:
            return False
        if mem_arr is not None:
            starts = np.concatenate([[0], np.cumsum(lps_)])
            m = float(mem_arr[starts[s]:starts[s + 1]].sum())
            if m > mem_cap:
                return False
        return True

    def pair_best_cut(span_lo: int, span_hi: int, cur_left: int,
                      prefer_small_left: bool):
        """Optimal 2-partition of the contiguous span [lo, hi): the cut that
        minimises max(left, right) load, tie-broken by smaller gap, then by
        the percolation direction (equal-quality cuts drift load toward the
        lighter side of the ring).  Pure pair-local information.

        Vectorized prefix-sum scan (the controller runs this for every
        neighbor pair every round — O(n) per pair instead of a Python
        loop): the stable lexsort reproduces the sequential scan's
        earliest-cut tie-break."""
        seg = costs[span_lo:span_hi]
        n = len(seg)
        left = np.concatenate([[0.0], np.cumsum(seg)])      # [n + 1]
        right = left[-1] - left
        cuts = np.arange(n + 1)
        ok = (cuts <= max_slots) & ((n - cuts) <= max_slots)
        if not ok.any():
            return cur_left
        key1 = np.where(ok, np.maximum(left, right), np.inf)
        key2 = np.abs(left - right)
        key3 = -cuts if not prefer_small_left else cuts      # = -tie_dir
        return int(np.lexsort((key3, key2, key1))[0])

    def window_pass(lps, width: int, offset: int) -> Tuple[List[int], bool]:
        """Re-partition each window of `width` consecutive stages optimally
        over its own contiguous span (only neighbor-local information);
        accept on strict window-bottleneck reduction."""
        starts = np.concatenate([[0], np.cumsum(lps)]).astype(int)
        moved = False
        i = offset
        while i + width <= S:
            lo, hi = starts[i], starts[i + width]
            if hi > lo:
                span = costs[lo:hi]
                old_max = max(float(span[starts[i + t] - lo:
                                         starts[i + t + 1] - lo].sum())
                              for t in range(width))
                res = partition_balance(span, width, max_slots=max_slots)
                if res.bottleneck < old_max - 1e-12:
                    trial = list(lps)
                    for t in range(width):
                        trial[i + t] = res.layers_per_stage[t]
                    ok = all(bounds_ok(trial, i + t) for t in range(width))
                    if ok:
                        lps = trial
                        starts = np.concatenate(
                            [[0], np.cumsum(lps)]).astype(int)
                        moved = True
            i += width
        return lps, moved

    rounds = 0
    for r in range(max_rounds):
        rounds = r + 1
        moved = False
        # pairwise exchange (odd/even alternation)
        loads_ring = stage_loads(costs, lps)
        for parity in (0, 1):
            starts = np.concatenate([[0], np.cumsum(lps)]).astype(int)
            for i in range(parity, S - 1, 2):
                j = i + 1
                lo, hi = starts[i], starts[j + 1]
                cur_left = lps[i]
                left_mean = float(loads_ring[:j].mean())
                right_mean = float(loads_ring[j:].mean())
                cut = pair_best_cut(lo, hi, cur_left,
                                    prefer_small_left=left_mean > right_mean)
                if cut == cur_left:
                    continue
                trial = list(lps)
                trial[i] = cut
                trial[j] = (hi - lo) - cut
                if not (bounds_ok(trial, i) and bounds_ok(trial, j)):
                    continue
                old_max = max(float(costs[lo:lo + cur_left].sum()),
                              float(costs[lo + cur_left:hi].sum()))
                new_max = max(float(costs[lo:lo + cut].sum()),
                              float(costs[lo + cut:hi].sum()))
                if new_max < old_max - 1e-12:
                    lps = trial
                    starts = np.concatenate(
                        [[0], np.cumsum(lps)]).astype(int)
                    moved = True
                elif abs(new_max - old_max) < 1e-12 and r < 2 * S:
                    # tie percolation: the direction-aware tie-break above
                    # already chose the drift toward the lighter ring side;
                    # accept so heavy plateaus drain toward idle stages.
                    # (bounded to 2S rounds — prevents endless tie walks)
                    lps = trial
                    starts = np.concatenate(
                        [[0], np.cumsum(lps)]).astype(int)
                    moved = True
        if not moved:
            # plateau: escalate to 3-stage neighborhoods (patterns like
            # [3,1 | 3,3] need coordinated shifts pairs cannot express)
            for off in (0, 1, 2):
                lps, m3 = window_pass(lps, 3, off)
                moved = moved or m3
        if not moved:
            break
    loads = stage_loads(costs, lps)
    return BalanceResult(list(map(int, lps)), float(loads.max()),
                         imbalance(loads), rounds)


def balance(method: str, costs: Sequence[float], num_stages: int,
            **kw) -> BalanceResult:
    if method == "partition":
        kw.pop("init", None)
        kw.pop("gamma", None)
        return partition_balance(costs, num_stages, **kw)
    if method == "diffusion":
        return diffusion_balance(costs, num_stages, **kw)
    if method == "uniform":      # Megatron-LM static baseline
        base = len(costs) // num_stages
        rem = len(costs) % num_stages
        lps = [base + (1 if s < rem else 0) for s in range(num_stages)]
        loads = stage_loads(costs, lps)
        return BalanceResult(lps, float(loads.max()), imbalance(loads))
    raise ValueError(method)
