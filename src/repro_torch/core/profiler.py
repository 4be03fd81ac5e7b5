"""DynMo profiler (paper §3.1 step 3): after each dynamism event, one
iteration measures per-layer execution time and per-worker memory.

Sources, in decreasing fidelity:
  * measured   — wall-clock timing of per-stage execution on the host
                 backend (integration runs / single-node);
  * stats      — the pipeline's per-slot stats outputs (expert loads, ff
                 retention, attention density, token fractions) folded
                 through the analytic cost model;
  * analytic   — pure cost model from the dynamism state (dry-run scale).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import BLOCK_PAD, ModelConfig
from repro_torch.core.cost_model import (LayerDynState, MEM_STATE_FACTOR,
                                   cost_vector)


@dataclasses.dataclass
class LayerProfile:
    """Per-global-layer profile in execution order."""
    time_per_layer: np.ndarray      # seconds (fwd+bwd)
    param_bytes: np.ndarray         # bytes
    mem_per_stage: np.ndarray       # bytes resident per stage
    dyn_states: List[LayerDynState]
    # MoE routing signals, aggregated over every MoE slot in the window:
    # per-expert routed-token counts [E] (None for non-MoE archs) and the
    # mean capacity-drop fraction — the controller's expert re-layout and
    # overflow telemetry read these.
    expert_load: Optional[np.ndarray] = None
    moe_drop_frac: float = 0.0


def profile_from_stats(cfg: ModelConfig, stats: Dict[str, np.ndarray],
                       tags: np.ndarray, num_micro: int, tokens: int,
                       seq: int, dyn_ff: Optional[np.ndarray] = None,
                       frozen: Optional[np.ndarray] = None,
                       bytes_per_param: float = 2.0) -> LayerProfile:
    """Fold the pipeline's per-slot stats [S, L_max, ...] into per-layer
    DynStates + cost-model times, in global layer order.

    ``bytes_per_param`` must match the trainer's param dtype
    (``DistConfig.bytes_per_param``) — repack memory budgets are computed
    from these byte vectors."""
    S, L_max = tags.shape
    states: List[LayerDynState] = []
    order: List[int] = []
    expert = stats.get("expert_load")
    dropped = stats.get("moe_dropped")
    dens = stats.get("attn_density")
    ffa = stats.get("ff_active")
    expert_total: Optional[np.ndarray] = None
    drop_sum, drop_n = 0.0, 0
    for s in range(S):
        for l in range(L_max):
            if tags[s, l] == BLOCK_PAD:
                continue
            ds = LayerDynState()
            if ffa is not None and np.ndim(ffa) >= 2:
                v = float(ffa[s, l]) / max(1, num_micro)
                ds.retained = float(np.clip(v, 0.02, 1.0))
            if dens is not None and np.ndim(dens) >= 2:
                v = float(dens[s, l]) / max(1, num_micro)
                ds.attn_density = float(np.clip(v, 0.02, 1.0))
            if expert is not None and cfg.num_experts:
                e = np.asarray(expert[s, l], dtype=np.float64)
                mean = e.mean() if e.mean() > 0 else 1.0
                ds.expert_hot = float(np.clip(e.max() / mean, 1.0, 4.0))
                if e.sum() > 0:   # an MoE slot that actually routed
                    expert_total = (e if expert_total is None
                                    else expert_total + e)
                    if dropped is not None and np.ndim(dropped) >= 2:
                        drop_sum += float(dropped[s, l]) / max(1, num_micro)
                        drop_n += 1
            if frozen is not None:
                ds.frozen = bool(frozen[s, l] > 0)
            states.append(ds)
            order.append(tags[s, l])
    times = cost_vector(cfg, tokens, seq, states, by="time")
    params = cost_vector(cfg, tokens, seq, states,
                         by="param") * float(bytes_per_param)
    mem = np.zeros(S)
    i = 0
    for s in range(S):
        n = int(np.sum(tags[s] != BLOCK_PAD))
        mem[s] = params[i:i + n].sum() * MEM_STATE_FACTOR
        i += n
    return LayerProfile(times, params, mem, states,
                        expert_load=expert_total,
                        moe_drop_frac=drop_sum / drop_n if drop_n else 0.0)
