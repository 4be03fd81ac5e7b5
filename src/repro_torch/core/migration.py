"""Layer migration between pipeline stages (paper §4.1) — the PyTorch port
of ``repro.core.migration``.

A rebalance produces a new contiguous layers-per-stage split.  Stage state
lives in ``[S, L_max, ...]`` slot buffers, so migration is a gather along
the (stage, slot) axes with a host-computed (dst <- src) index map, applied
to params, optimizer moments and dyn state alike.  In one process all S
buffers live on one card, so the gather is one indexing op per leaf; PAD
destinations are zeroed.  Across ranks (``mesh``) each rank holds its row
``[1, L_max, ...]``: it sends the rows a destination on another rank takes
from it and receives the ones it takes from another rank — one
``batch_isend_irecv`` per tree, every transfer listed in one global
(destination stage, slot) order on both sides — and gathers the rows that
stay.  The plan itself is numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import BLOCK_PAD
from repro_torch.launch.sharding import leaves, rebuild, zeros


@dataclasses.dataclass
class MigrationPlan:
    src_stage: np.ndarray     # int32 [S, L_max]
    src_slot: np.ndarray      # int32 [S, L_max]
    valid: np.ndarray         # bool  [S, L_max] (False = dst slot is PAD)
    moved_layers: int         # how many layers change stage
    moved_bytes_per_layer_hint: int = 0


def _locate(lps) -> Tuple[np.ndarray, np.ndarray]:
    """Global layer g -> (stage[g], slot[g]) under a contiguous split."""
    lps = np.asarray(lps, np.int64)
    stages = np.repeat(np.arange(len(lps)), lps)
    starts = np.concatenate([[0], np.cumsum(lps)[:-1]])
    slots = np.arange(int(lps.sum())) - starts[stages]
    return stages, slots


def build_plan(old_lps: Sequence[int], new_lps: Sequence[int],
               L_max: int) -> MigrationPlan:
    """Map each destination slot to its source slot under contiguous
    splits (plan[dst] = src)."""
    total_old, total_new = sum(old_lps), sum(new_lps)
    assert total_old == total_new, (total_old, total_new)
    S = len(new_lps)
    assert max(new_lps) <= L_max, "destination split exceeds slot capacity"
    src_st, src_sl = _locate(old_lps)
    dst_st, dst_sl = _locate(new_lps)
    src_stage = np.zeros((S, L_max), np.int32)
    src_slot = np.zeros((S, L_max), np.int32)
    valid = np.zeros((S, L_max), bool)
    src_stage[dst_st, dst_sl] = src_st
    src_slot[dst_st, dst_sl] = src_sl
    valid[dst_st, dst_sl] = True
    moved = int(np.sum(src_st != dst_st))
    return MigrationPlan(src_stage, src_slot, valid, moved)


def apply_plan(tree: Any, plan: MigrationPlan) -> Any:
    """Gather [S, L_max, ...] tensors to the new layout.  Invalid (PAD)
    destination slots hold zeros."""
    if isinstance(tree, dict):
        return {k: apply_plan(v, plan) for k, v in tree.items()}
    dev = tree.device
    ss = torch.as_tensor(plan.src_stage, dtype=torch.long, device=dev)
    sl = torch.as_tensor(plan.src_slot, dtype=torch.long, device=dev)
    valid = torch.as_tensor(plan.valid, device=dev)
    out = tree[ss, sl]                                  # [S, L_max, ...]
    mask = valid.reshape(valid.shape + (1,) * (out.dim() - 2))
    return torch.where(mask, out, torch.zeros_like(out))


def _apply_plan_to_opt(opt_state: Any, plan: MigrationPlan) -> Any:
    """Optimizer state mirrors the param tree; only its ``stages`` subtrees
    are stage-keyed (the step count and the embed / head moments stay)."""
    if isinstance(opt_state, dict):
        return {k: (apply_plan(v, plan) if k == "stages"
                    else _apply_plan_to_opt(v, plan))
                for k, v in opt_state.items()}
    return opt_state


def exchange_rows(tree: Any, plan: MigrationPlan, src, dst, *,
                  template: Any = None, replica: int = None,
                  device=None) -> Any:
    """Move a stage-keyed tree's rows from the world of ``src`` (a
    ``launch.mesh.Mesh``) to the world of ``dst`` under ``plan``: the row of
    destination (stage ds, slot dl) comes from source (stage ss, slot sl)
    of the same data replica.  A row whose source and destination are this
    rank is copied; the others cross ranks, every send and receive of the
    tree posted in one ``batch_isend_irecv`` in one global (destination
    stage, slot, leaf) order on every rank; PAD destinations hold zeros.

    ``tree``: this rank's ``[1, L_src, ...]`` rows, or None when the rank is
    outside ``src``; ``template``: leaves of the destination's ``[1, L_dst,
    ...]`` shapes and dtypes (default ``tree``: a migration within one
    world); ``replica``: this rank's data row (default ``src``'s).  Returns
    the rank's new rows, or None when it is outside ``dst``.  Adds the rows
    moved to ``comm.stats`` (``rows_sent`` / ``rows_recv``: one per slot of
    the tree)."""
    template = tree if template is None else template
    paths = [p for p, _ in leaves(template)]
    old = dict(leaves(tree)) if tree is not None else None
    me, comm = src.rank, src.comm
    d = src.replica if replica is None else replica
    new = None
    if dst.member:
        dev = comm.device if device is None else device
        new = dict(leaves(zeros(template, dev)))
    S, L = plan.valid.shape
    sends, recvs = [], []
    for ds in range(S):
        for dl in range(L):
            if not plan.valid[ds, dl]:
                continue
            ss, sl = int(plan.src_stage[ds, dl]), int(plan.src_slot[ds, dl])
            s_rank, d_rank = src.rank_of(ss, d), dst.rank_of(ds, d)
            if s_rank == me and d_rank == me:
                for p in paths:
                    new[p][0, dl] = old[p][0, sl]
            elif s_rank == me:
                sends += [(old[p][0, sl], d_rank) for p in paths]
                comm.stats["rows_sent"] += 1
            elif d_rank == me:
                recvs += [(new[p][0, dl], s_rank) for p in paths]
                comm.stats["rows_recv"] += 1
    comm.exchange(sends, recvs)
    return None if new is None else rebuild(template, lambda p, _: new[p])


def apply_plan_across(tree: Any, plan: MigrationPlan, mesh) -> Any:
    """``apply_plan`` on this rank's row of a stage-keyed tree
    (``exchange_rows`` within one world): rows whose source is another
    rank's arrive by point-to-point transfer, rows that stay are gathered
    locally, PAD destinations hold zeros.  None (a rank outside the world
    holds no rows) stays None."""
    if tree is None or not mesh.member:
        return None
    dev = next(leaves(tree))[1].device
    return exchange_rows(tree, plan, mesh, mesh, device=dev)


def _apply_plan_to_opt_across(opt_state: Any, plan: MigrationPlan, mesh):
    if isinstance(opt_state, dict):
        return {k: (apply_plan_across(v, plan, mesh) if k == "stages"
                    else _apply_plan_to_opt_across(v, plan, mesh))
                for k, v in opt_state.items()}
    return opt_state


def migrate(params_stages: Dict[str, torch.Tensor], opt_stages: Any,
            dyn: Dict[str, torch.Tensor], old_lps: Sequence[int],
            new_lps: Sequence[int], tags_pattern: Sequence[int],
            L_max: int, cache: Any = None, mesh=None):
    """One-call migration of all stage-keyed state + fresh assignment.
    With a ``mesh`` the trees are this rank's rows and move across ranks
    (``apply_plan_across``); the assignment is whole on every rank, and a
    rank outside the mesh's world (released by a resize) gets it alone.

    Returns (params_stages, opt_stages, dyn, assignment, cache, plan)."""
    plan = build_plan(old_lps, new_lps, L_max)
    if mesh is None:
        new_params = apply_plan(params_stages, plan)
        new_opt = (_apply_plan_to_opt(opt_stages, plan)
                   if opt_stages is not None else None)
        new_dyn = apply_plan(dyn, plan)
        new_cache = apply_plan(cache, plan) if cache is not None else None
    elif not mesh.member:
        # a rank outside the world holds no rows: only the assignment
        new_params = new_opt = new_dyn = new_cache = None
    else:
        new_params = apply_plan_across(params_stages, plan, mesh)
        new_opt = (_apply_plan_to_opt_across(opt_stages, plan, mesh)
                   if opt_stages is not None else None)
        new_dyn = apply_plan_across(dyn, plan, mesh)
        new_cache = (apply_plan_across(cache, plan, mesh)
                     if cache is not None else None)
    S = len(new_lps)
    tags = np.full((S, L_max), BLOCK_PAD, np.int32)
    dst_st, dst_sl = _locate(new_lps)
    tags[dst_st, dst_sl] = np.asarray(tags_pattern, np.int32)
    lps = np.asarray(new_lps, np.int64)
    assignment = {
        "tags": torch.tensor(tags, dtype=torch.int32),
        "num_active": torch.tensor(lps, dtype=torch.int32),
        "depth_base": torch.tensor(
            np.concatenate([[0], np.cumsum(lps)[:-1]]), dtype=torch.int32),
    }
    return new_params, new_opt, new_dyn, assignment, new_cache, plan
