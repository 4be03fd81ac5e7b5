"""Analytic per-layer cost model.

Single source of truth for: the simulator's per-layer times, the balancers'
"by-param"/"by-time" cost vectors at dry-run scale, and the roofline's
MODEL_FLOPS cross-check.  All dynamism schemes modulate per-layer cost
through a ``LayerDynState`` so the *same* model drives Fig. 1/3/4
reproductions.

A copy of ``repro.core.cost_model``.  The device constants are
parameters of ``layer_time`` / ``cost_vector``; their defaults are the
reference's (a TPU v5e), so the controller decides exactly what the
reference decides on the same stats.  The model only ranks layers against
each other — no time it returns is stated as a measurement of any card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import (
    BLOCK_DEC, BLOCK_DENSE, BLOCK_ENC, BLOCK_HYBRID_ATTN, BLOCK_MAMBA,
    BLOCK_MLSTM, BLOCK_MOE, BLOCK_SLSTM, ModelConfig,
)

# TPU v5e
PEAK_FLOPS = 197e12          # bf16 FLOP/s per chip
HBM_BW = 819e9               # bytes/s per chip
ICI_BW = 50e9                # bytes/s per link
# H100 SXM (for paper-scale reproduction ratios)
H100_PEAK_FLOPS = 989e12 / 2   # bf16 dense ~ 989/2 without sparsity
H100_HBM_BW = 3.35e12
NVLINK_BW = 450e9


@dataclasses.dataclass
class LayerDynState:
    """Per-layer dynamism multipliers at one training moment."""
    retained: float = 1.0       # pruning: fraction of FFN blocks kept
    frozen: bool = False        # freezing: backward dW skipped
    attn_density: float = 1.0   # sparse attention: fraction of attn blocks
    token_frac: float = 1.0     # early-exit / MoD: fraction of live tokens
    expert_hot: float = 1.0     # MoE: hottest-expert load multiplier vs mean


def layer_flops(cfg: ModelConfig, block_type: int, tokens: int,
                seq: int, dyn: Optional[LayerDynState] = None,
                backward: bool = False) -> float:
    """FLOPs for one block over ``tokens`` tokens at context ``seq``."""
    dyn = dyn or LayerDynState()
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    t = tokens * dyn.token_frac
    f = 0.0
    if block_type in (BLOCK_DENSE, BLOCK_MOE, BLOCK_ENC, BLOCK_DEC,
                      BLOCK_HYBRID_ATTN):
        # qkvo projections
        proj = 2 * t * d * (nq * hd + 2 * nkv * hd + nq * hd)
        ctx = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
        att = 2 * t * ctx * nq * hd * 2 * dyn.attn_density
        f += proj + att
        if block_type == BLOCK_DEC:
            f += proj + 2 * t * cfg.encoder_seq * nq * hd * 2   # cross attn
    if block_type == BLOCK_DENSE:
        f += 2 * t * 3 * d * cfg.d_ff * dyn.retained
    elif block_type == BLOCK_MOE:
        cap = 1.25
        f += 2 * t * cfg.experts_per_token * cap * 3 * d * cfg.d_ff \
            * dyn.retained * dyn.expert_hot
        f += 2 * t * d * cfg.num_experts                        # router
    elif block_type in (BLOCK_ENC, BLOCK_DEC):
        f += 2 * t * 2 * d * cfg.d_ff * dyn.retained
    elif block_type in (BLOCK_MAMBA, BLOCK_HYBRID_ATTN):
        d_in = 2 * d
        st = cfg.ssm_state
        nh = max(1, d_in // 64)
        f_m = 2 * t * d * (2 * d_in + 2 * st + nh)              # in_proj
        f_m += 2 * t * d_in * d                                 # out_proj
        f_m += t * d_in * st * 6                                # ssd scan
        f += f_m
    elif block_type == BLOCK_MLSTM:
        d_in = 2 * d
        nh = max(1, cfg.num_heads)
        dh = d_in // nh
        f += 2 * t * d * 2 * d_in + 2 * t * d_in * d            # up/down
        f += 2 * t * 3 * d_in * dh * dyn.retained               # qkv blockdiag
        chunk = min(seq, 256)
        f += 2 * t * chunk * nh * dh * 2                        # chunk attn
    elif block_type == BLOCK_SLSTM:
        f += 2 * t * d * 4 * d + 2 * t * d * d
        f += 2 * t * d * (8 * d // 3) * dyn.retained
    if backward:
        # dx for all; dW skipped when frozen
        f *= 1.0 if not dyn else (1.0 if dyn.frozen else 2.0)
    return f


def layer_bytes(cfg: ModelConfig, block_type: int, tokens: int,
                seq: int, dyn: Optional[LayerDynState] = None,
                dtype_bytes: int = 2) -> float:
    """HBM traffic estimate: weights once + activations in/out."""
    dyn = dyn or LayerDynState()
    w = cfg.params_per_block(block_type) * dtype_bytes * max(
        0.25, dyn.retained)
    act = 3 * tokens * cfg.d_model * dtype_bytes
    if block_type in (BLOCK_DENSE, BLOCK_MOE, BLOCK_ENC, BLOCK_DEC,
                      BLOCK_HYBRID_ATTN):
        ctx = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
        kv = 2 * tokens * cfg.num_kv_heads * cfg.resolved_head_dim \
            * dtype_bytes
        act += kv + 2 * ctx * cfg.num_kv_heads * cfg.resolved_head_dim \
            * dtype_bytes * dyn.attn_density
    return w + act


def layer_time(cfg: ModelConfig, block_type: int, tokens: int, seq: int,
               dyn: Optional[LayerDynState] = None, backward: bool = True,
               peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
               overhead: float = 2e-6) -> float:
    """Roofline time: max(compute, memory) + launch overhead; fwd+bwd.

    Frozen layers run FORWARD ONLY: layer freezing advances as a front from
    layer 0 (Egeria — early layers converge first), so no activation grads
    flow into the frozen prefix at all; both dW and dx are skipped there
    (matching the paper's 'drop frozen layers from back propagation')."""
    dyn = dyn or LayerDynState()
    f_fwd = layer_flops(cfg, block_type, tokens, seq, dyn)
    t_fwd = max(f_fwd / peak_flops,
                layer_bytes(cfg, block_type, tokens, seq, dyn) / hbm_bw)
    t = t_fwd + overhead
    if backward and not dyn.frozen:
        t += t_fwd * 2.0 + overhead
    return t


def model_flops(cfg: ModelConfig, tokens: int, train: bool = True) -> float:
    """6·N·D convention (2·N·D forward, 4·N·D backward); MoE uses active
    params."""
    n = cfg.active_param_count()
    return (6.0 if train else 2.0) * n * tokens


# resident bytes per param byte: weights + grads + 2 Adam moments + working
# set; single source for every repack memory estimate (profiler, controller,
# trainer budget) — change it HERE, not at a call site
MEM_STATE_FACTOR = 5.0


def stage_memory_budget(cfg: ModelConfig, tokens: int, seq: int,
                        bytes_per_param: float, num_stages: int,
                        cap_factor: float = 1.0) -> float:
    """Per-worker memory budget: ``cap_factor`` × the UNPRUNED per-stage
    footprint (params + optimizer state) under a uniform split — the repack
    trigger the trainer hands the controller."""
    pb = cost_vector(cfg, tokens, seq, None, by="param") \
        * float(bytes_per_param)
    return float(cap_factor) * float(pb.sum()) * MEM_STATE_FACTOR \
        / max(1, num_stages)


def cost_vector(cfg: ModelConfig, tokens: int, seq: int,
                dyn_states: Optional[Sequence[LayerDynState]] = None,
                by: str = "time", peak_flops: float = PEAK_FLOPS,
                hbm_bw: float = HBM_BW) -> np.ndarray:
    """Per-layer cost vector for the balancers.

    ``by='time'``  — analytic layer times (profiled execution time stand-in)
    ``by='param'`` — parameter counts (DeepSpeed-style)
    """
    pattern = cfg.block_pattern()
    if dyn_states is None:
        dyn_states = [LayerDynState() for _ in pattern]
    out = []
    for bt, ds in zip(pattern, dyn_states):
        if by == "param":
            out.append(cfg.params_per_block(bt) * max(0.05, ds.retained))
        else:
            out.append(layer_time(cfg, bt, tokens, seq, ds,
                                  peak_flops=peak_flops, hbm_bw=hbm_bw))
    return np.asarray(out, dtype=np.float64)
