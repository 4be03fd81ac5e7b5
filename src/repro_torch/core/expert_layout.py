"""Live expert re-layout for expert-parallel MoE (LAER-style move) — the
PyTorch port of ``repro.core.expert_layout`` (numpy on the host; the move
is the port's torch migration gather).

The controller watches the per-expert routed-token vector that
``stats["expert_load"]`` folds into every :class:`StatsSnapshot`.  When the
measured hot/cold skew (``max(load) / mean(load)``) crosses a watermark it
emits an :class:`ExpertRelayoutPlan`: a new placement of *logical* experts
over *physical* kernel groups that interleaves hot and cold experts so no
physical neighbourhood concentrates the heavy groups.

Two invariants keep this bit-exact and restart-free:

  * **Params and optimizer state never move.**  The optimizer's global-norm
    clip sums in expert order, so physically permuting the expert axis would
    perturb every update.  Placement lives only in the ``dyn["expert_map"]``
    leaf ([S, L_max, E] float32) folded into the grouped kernels' weight
    index (K4, K5) —
    per-token math is row-wise, so any placement computes the same y
    bitwise.
  * **The move is the migration gather.**  A placement change is expressed
    as a :class:`migration.MigrationPlan` over a single-stage [1, E] grid
    and applied with the same ``apply_plan`` machinery that moves layers
    between stages — per-expert controller state rides it exactly like
    weights ride a rebalance.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.core import migration as mig


@dataclasses.dataclass(frozen=True)
class ExpertLayout:
    """Placement of logical experts over physical kernel groups.

    ``placement[e]`` is the physical group computing logical expert ``e``;
    ``capacity_weights[e]`` records the normalized load share that produced
    this placement (1.0 = exactly mean load) — a signal for capacity-aware
    follow-ups, not a kernel input."""
    placement: Tuple[int, ...]
    capacity_weights: Tuple[float, ...]

    @classmethod
    def identity(cls, num_experts: int) -> "ExpertLayout":
        return cls(placement=tuple(range(num_experts)),
                   capacity_weights=(1.0,) * num_experts)

    def __post_init__(self):
        E = len(self.placement)
        assert sorted(self.placement) == list(range(E)), self.placement
        assert len(self.capacity_weights) == E

    @property
    def num_experts(self) -> int:
        return len(self.placement)

    @property
    def inverse(self) -> Tuple[int, ...]:
        """``inverse[p]`` = logical expert computed by physical group p."""
        inv = [0] * len(self.placement)
        for e, p in enumerate(self.placement):
            inv[p] = e
        return tuple(inv)

    def as_array(self) -> np.ndarray:
        return np.asarray(self.placement, np.float32)


@dataclasses.dataclass(frozen=True)
class ExpertRelayoutPlan:
    """One decided placement change, carried by a DecisionPlan to the next
    safe point."""
    old: ExpertLayout
    new: ExpertLayout
    skew: float               # max/mean load ratio that triggered it
    total_tokens: int         # routed tokens in the window
    iteration: int            # trainer step / scheduler tick of the decision

    @property
    def moved_experts(self) -> int:
        return int(sum(a != b for a, b in
                       zip(self.old.placement, self.new.placement)))


def measure_skew(load) -> Tuple[float, int]:
    """(max/mean ratio, total routed tokens) of a per-expert load vector."""
    load = np.asarray(load, np.float64)
    total = float(load.sum())
    if total <= 0:
        return 1.0, 0
    return float(load.max() / (total / load.size)), int(round(total))


def build_relayout(load, current: ExpertLayout, *, watermark: float,
                   min_tokens: int, iteration: int
                   ) -> Optional[ExpertRelayoutPlan]:
    """Decide a re-layout from a measured per-expert load vector.

    Returns None when the window is too small (< min_tokens routed), the
    skew is under the watermark, or the interleaved placement equals the
    current one (nothing to move)."""
    load = np.asarray(load, np.float64)
    skew, total = measure_skew(load)
    if total < min_tokens or skew <= watermark:
        return None
    # LAER interleave: rank experts hot->cold, then zip the ranking from
    # both ends so physical neighbours pair a hot expert with a cold one —
    # under expert-parallel sharding no device neighbourhood concentrates
    # the heavy groups.  argsort on (-load, e) is deterministic under ties.
    E = load.size
    ranked = np.lexsort((np.arange(E), -load))
    order = np.empty(E, np.int64)
    order[0::2] = ranked[: (E + 1) // 2]
    order[1::2] = ranked[(E + 1) // 2:][::-1]
    placement = [0] * E
    for phys, e in enumerate(order):
        placement[int(e)] = phys
    mean = total / E
    new = ExpertLayout(placement=tuple(placement),
                       capacity_weights=tuple(float(x / mean) for x in load))
    if new.placement == current.placement:
        return None
    return ExpertRelayoutPlan(old=current, new=new, skew=skew,
                              total_tokens=total, iteration=iteration)


def as_migration_plan(old: ExpertLayout, new: ExpertLayout
                      ) -> mig.MigrationPlan:
    """Express a placement change as a migration gather over a [1, E] grid.

    Destination physical slot p must hold the state of whatever logical
    expert ``new`` places there, currently sitting at ``old.placement`` of
    that expert — a pure permutation, so every slot is valid."""
    E = old.num_experts
    assert new.num_experts == E
    old_pl = np.asarray(old.placement, np.int64)
    src_slot = old_pl[np.asarray(new.inverse, np.int64)]
    return mig.MigrationPlan(
        src_stage=np.zeros((1, E), np.int32),
        src_slot=src_slot.reshape(1, E).astype(np.int32),
        valid=np.ones((1, E), bool),
        moved_layers=int(np.sum(src_slot != np.arange(E))))


def apply_expert_plan(tree: Any, plan: mig.MigrationPlan) -> Any:
    """Gather per-expert [E, ...] tensors (a dict tree) to a new placement
    by lifting them to [1, E, ...] and running the standard migration
    gather."""
    if isinstance(tree, dict):
        return {k: apply_expert_plan(v, plan) for k, v in tree.items()}
    return mig.apply_plan(tree[None], plan)[0]
