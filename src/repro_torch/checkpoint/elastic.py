"""Elastic re-split of stage-keyed state (paper §3.4.2), ported from
``repro.checkpoint.elastic``.

Moving to a different stage count rebuilds the slot buffers: the
(layers-per-stage, stacked ``[S, L_max, ...]`` state) is flattened to global
layer order and re-split contiguously for the new count.  It serves a shrink
(re-pack, released workers) and a grow (granted workers) alike.  In one
process all stage buffers live on one card, so the re-split is one gather
per leaf (``core.migration.apply_plan``) into new tensors; the caller
drops the old ones.  Across ranks (``elastic_restore_across``) each rank
holds its stage's rows: the same plan moves each (old stage, old slot)
row from its rank in the old world to its rank in the new one
(``core.migration.exchange_rows``, one ``batch_isend_irecv`` per tree),
into buffers of the new world's shapes (``L_max`` follows the stage
count).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import DistConfig, ModelConfig
from repro_torch.core.migration import (_apply_plan_to_opt, apply_plan,
                                        build_plan, exchange_rows)
from repro_torch.models.model import make_assignment, uniform_boundaries


def resplit_indices(old_lps: Sequence[int], new_lps: Sequence[int],
                    new_L_max: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side plan: for each destination slot of the new layout, the
    (src_stage, src_slot) it gathers from, plus a validity mask for PAD
    slots — ``migration.build_plan``'s index map across stage counts."""
    plan = build_plan(old_lps, new_lps, new_L_max)
    return plan.src_stage, plan.src_slot, plan.valid


def _resplit_stage_tree(tree, old_lps: Sequence[int],
                        new_lps: Sequence[int], new_L_max: int):
    """Re-split [S_old, L_old, ...] tensors to [S_new, L_new, ...] along
    global layer order; PAD destination slots are zeroed."""
    return apply_plan(tree, build_plan(old_lps, new_lps, new_L_max))


def elastic_restore(cfg: ModelConfig, old_dcfg: DistConfig,
                    new_dcfg: DistConfig, params, opt_state, dyn,
                    old_lps: Sequence[int],
                    new_lps: Optional[Sequence[int]] = None):
    """Reshape stage-keyed state from the old stage layout to the new one
    (a uniform split unless ``new_lps`` is given).

    Returns (params, opt_state, dyn, assignment, new_lps)."""
    if new_lps is None:
        new_lps = uniform_boundaries(cfg.total_blocks(), new_dcfg.num_stages)
    L_new = new_dcfg.slots_for(cfg)
    params = dict(params)
    params["stages"] = _resplit_stage_tree(params["stages"], old_lps,
                                           new_lps, L_new)
    if opt_state is not None:
        opt_state = _reshape_opt(opt_state, old_lps, new_lps, L_new)
    dyn = _resplit_stage_tree(dyn, old_lps, new_lps, L_new)
    assignment = make_assignment(cfg, new_dcfg, new_lps)
    return params, opt_state, dyn, assignment, list(new_lps)


def _reshape_opt(opt_state, old_lps, new_lps, L_new):
    """Optimizer moments mirror the param tree: re-split the stages
    subtrees, keep everything else (the step count, non-stage moments)."""
    return _apply_plan_to_opt(opt_state, build_plan(old_lps, new_lps, L_new))


def elastic_restore_across(cfg: ModelConfig, new_dcfg: DistConfig, params,
                           opt_rows, dyn, cache, old_lps: Sequence[int],
                           new_lps: Optional[Sequence[int]], *, src, dst,
                           templates, replica: int, device):
    """``elastic_restore`` on this rank's rows, from the world of ``src`` to
    the world of ``dst`` (``launch.mesh.Mesh``; the same data rows).

    ``params["stages"]``, ``opt_rows`` (the optimizer's ``stages``
    subtrees, ``launch.sharding.split_stages``), ``dyn`` and ``cache``
    (None when the engine serves no cache) are the rank's ``[1, L_old,
    ...]`` rows, None on a rank outside ``src``; ``templates`` holds the
    new world's row shapes under the same keys (``params``, ``opt``,
    ``dyn``, ``cache``).  The trees move in that order, one exchange each.
    Returns (stage params, opt rows, dyn, cache, assignment, new_lps); the
    trees are None on a rank outside ``dst``."""
    if new_lps is None:
        new_lps = uniform_boundaries(cfg.total_blocks(), new_dcfg.num_stages)
    plan = build_plan(old_lps, new_lps, new_dcfg.slots_for(cfg))

    def move(tree, key):
        if templates.get(key) is None:
            return None
        return exchange_rows(tree, plan, src, dst, template=templates[key],
                             replica=replica, device=device)

    stages = move(None if params is None else params["stages"], "params")
    opt_rows = move(opt_rows, "opt")
    dyn = move(dyn, "dyn")
    cache = move(cache, "cache")
    assignment = make_assignment(cfg, new_dcfg, new_lps)
    return stages, opt_rows, dyn, cache, assignment, list(new_lps)
