"""Whole-model assembly on top of the slot-block layer — the serving and
training subset of ``repro.models.model``.

Parameters (same keys and stacked layout as the reference)
  params = {
    "embed":  [V, d],
    "head":   [d, V]            (absent when tied),
    "final_norm": [d],
    "stages": {field: [S, L_max, ...]},     # stacked slot params
    "shared": {},
  }

Assignment — host tensors (it steers host control flow: which slot runs)
  assignment = {"tags": int32 [S, L_max], "num_active": int32 [S],
                "depth_base": int32 [S]}

Dynamism state
  dyn = {"ff_mask": f32 [S, L_max, npb], "frozen": f32 [S, L_max],
         "expert_map": f32 [S, L_max, E]   (MoE archs with expert_relayout)}

For training, ``params["stages"]`` may also hold, per field, nested lists
``[S][L_max]`` of per-slot tensors (the engine's gradient leaves, see
``pipeline.value_and_grad``): everything here indexes it as ``v[s][l]``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BLOCK_PAD, DistConfig, ModelConfig
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.models import blocks as B
from repro_torch.models.layers import (cross_entropy_with_head, matmul,
                                      rms_norm)

# what the port's slices serve so far; the other kinds raise
PORTED_DYNAMICS = ("none", "moe", "pruning", "freezing", "sparse_attention")


def check_ported(cfg: ModelConfig, dyncfg: DynamicsConfig) -> None:
    B.check_ported(cfg)
    if dyncfg.kind not in PORTED_DYNAMICS:
        raise NotImplementedError(
            f"dynamism kind {dyncfg.kind!r} is not in repro_torch yet "
            f"(ROADMAP Queue 1 [serve-dynamism])")


# ---------------------------------------------------------------------------
# Assignment
# ---------------------------------------------------------------------------
def uniform_boundaries(num_layers: int, num_stages: int) -> List[int]:
    """Megatron-style uniform contiguous split: layers per stage."""
    base = num_layers // num_stages
    rem = num_layers % num_stages
    return [base + (1 if s < rem else 0) for s in range(num_stages)]


def make_assignment(cfg: ModelConfig, dcfg: DistConfig,
                    layers_per_stage: Optional[Sequence[int]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Assignment tensors (on the host) from a contiguous layers-per-stage
    split."""
    pattern = cfg.block_pattern()
    S, L_max = dcfg.num_stages, dcfg.slots_for(cfg)
    if layers_per_stage is None:
        layers_per_stage = uniform_boundaries(len(pattern), S)
    assert sum(layers_per_stage) == len(pattern), (
        f"{sum(layers_per_stage)} != {len(pattern)}")
    assert max(layers_per_stage) <= L_max, (
        f"stage over capacity: {max(layers_per_stage)} > {L_max}")
    tags = [[BLOCK_PAD] * L_max for _ in range(S)]
    i = 0
    for s, n in enumerate(layers_per_stage):
        for l in range(n):
            tags[s][l] = pattern[i]
            i += 1
    lps = np.array(layers_per_stage)
    depth_base = np.concatenate([[0], np.cumsum(lps)[:-1]])
    return {
        "tags": torch.tensor(np.array(tags), dtype=torch.int32),
        "num_active": torch.tensor(lps, dtype=torch.int32),
        "depth_base": torch.tensor(depth_base, dtype=torch.int32),
    }


# ---------------------------------------------------------------------------
# Params / dyn-state / cache construction
# ---------------------------------------------------------------------------
def param_dtype(dcfg: DistConfig) -> torch.dtype:
    return torch.bfloat16 if dcfg.param_dtype == "bfloat16" else torch.float32


def param_spec(cfg: ModelConfig, dcfg: DistConfig) -> Dict[str, Any]:
    """Stage params in the configured dtype; embed / head / final_norm in
    float32, as in the reference."""
    dt = param_dtype(dcfg)
    S, L_max = dcfg.num_stages, dcfg.slots_for(cfg)
    stages = {k: B.TensorSpec((S, L_max) + v.shape, v.dtype)
              for k, v in B.slot_param_spec(cfg, dt).items()}
    spec = {
        "embed": B.TensorSpec((cfg.vocab_size, cfg.d_model), torch.float32),
        "final_norm": B.TensorSpec((cfg.d_model,), torch.float32),
        "stages": stages,
        "shared": {},
    }
    if not cfg.tie_embeddings:
        spec["head"] = B.TensorSpec((cfg.d_model, cfg.vocab_size),
                                    torch.float32)
    return spec


def init_params(gen: torch.Generator, cfg: ModelConfig, dcfg: DistConfig,
                device=None) -> Dict[str, Any]:
    """Random params with the reference's distributions, drawn from ``gen``
    (a generator on ``device``) — not jax's numbers: parity tests hand the
    reference's params over through ``repro_torch.convert``."""
    S, L_max = dcfg.num_stages, dcfg.slots_for(cfg)
    V, d = cfg.vocab_size, cfg.d_model
    params = {
        "embed": torch.randn((V, d), generator=gen, device=device) * 0.02,
        "final_norm": torch.ones((d,), device=device),
        "stages": B.init_slot(gen, cfg, param_dtype(dcfg), lead=(S, L_max),
                              device=device),
        "shared": {},
    }
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn((d, V), generator=gen, device=device)
                          * d ** -0.5)
    return params


def init_dyn(cfg: ModelConfig, dcfg: DistConfig, dyncfg: DynamicsConfig,
             device=None) -> Dict[str, torch.Tensor]:
    check_ported(cfg, dyncfg)
    S, L_max = dcfg.num_stages, dcfg.slots_for(cfg)
    dyn = {
        "ff_mask": torch.ones((S, L_max, B.n_prune_blocks(cfg)),
                              device=device),
        "frozen": torch.zeros((S, L_max), device=device),
    }
    if dyncfg.expert_relayout and cfg.num_experts:
        # logical expert -> physical kernel group, per slot (identity at
        # init), float32 as in the reference; its [S, L_max] leading dims
        # migrate with every other dyn leaf.  Only the pallas grouped path
        # reads it, and the placement never changes the model function.
        dyn["expert_map"] = torch.arange(
            cfg.num_experts, dtype=torch.float32, device=device).repeat(
                S, L_max, 1)
    return dyn


def cache_spec(cfg: ModelConfig, dcfg: DistConfig, num_micro: int, mb: int,
               cache_len: int) -> Dict[str, B.TensorSpec]:
    """Stacked decode cache: [S, L_max, num_micro, ...per-slot...]."""
    S, L_max = dcfg.num_stages, dcfg.slots_for(cfg)
    return {k: B.TensorSpec((S, L_max, num_micro) + v.shape, v.dtype)
            for k, v in B.slot_cache_spec(cfg, mb, cache_len).items()}


def init_cache(cfg: ModelConfig, dcfg: DistConfig, num_micro: int, mb: int,
               cache_len: int, device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in cache_spec(cfg, dcfg, num_micro, mb,
                                   cache_len).items()}


def paged_cache_spec(cfg: ModelConfig, dcfg: DistConfig, pool_pages: int,
                     page_size: int) -> Dict[str, B.TensorSpec]:
    """Stacked block-paged decode cache: [S, L_max, pool+1, page, kv, hd];
    all lanes of a stage-slot share one pool (no micro axis)."""
    S, L_max = dcfg.num_stages, dcfg.slots_for(cfg)
    return {k: B.TensorSpec((S, L_max) + v.shape, v.dtype)
            for k, v in B.paged_slot_cache_spec(cfg, pool_pages,
                                                page_size).items()}


def init_paged_cache(cfg: ModelConfig, dcfg: DistConfig, pool_pages: int,
                     page_size: int, device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in paged_cache_spec(cfg, dcfg, pool_pages,
                                         page_size).items()}


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed(params, cfg: ModelConfig, tokens) -> Dict[str, torch.Tensor]:
    """tokens: [b, s] int -> carry dict {"x": [b, s, d]}."""
    return {"x": params["embed"][tokens.long()]}


def lm_logits(params, cfg: ModelConfig, h):
    hn = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = params.get("head")
    if head is None:
        head = params["embed"].T
    return matmul(hn, head).float()


# ---------------------------------------------------------------------------
# Stage executor
# ---------------------------------------------------------------------------
def stage_forward(cfg: ModelConfig, dcfg: DistConfig, dyncfg: DynamicsConfig,
                  mode: str, stage_params, shared, tags, dyn_stage, carry,
                  cache_stage, pos, stage_depth_base, *, hash_proj=None):
    """Run one stage's L_max slots over the carry.

    stage_params: {field: [L_max, ...]}; tags: [L_max] host ints (PAD slots
    are skipped on the host); cache_stage: {field: [L_max, ...]} or None,
    written in place.  Returns (carry, cache_stage, stats {field: [L_max,
    ...]}, aux_loss).

    Training: a frozen slot (freezing dynamism) runs on detached params, so
    the backward computes its input gradient and no weight gradient — the
    reference's ``blocks.freezable``.  ``dcfg.remat == "block"`` recomputes
    each slot in the backward (``torch.utils.checkpoint``)."""
    zero = _stat_zeros(cfg, carry["x"].device)
    per_slot = []
    aux = 0.0
    frozen = None
    if dyncfg.uses_freezing and mode == "train":
        frozen = [float(f) > 0 for f in dyn_stage["frozen"].tolist()]
    for l, tag in enumerate(int(t) for t in tags):
        if tag == BLOCK_PAD:
            per_slot.append({})
            continue
        p = {k: v[l] for k, v in stage_params.items()}
        if frozen is not None and frozen[l]:
            p = {k: v.detach() for k, v in p.items()}
        dyn_slot = {k: v[l] for k, v in dyn_stage.items()}
        cache_slot = (None if cache_stage is None
                      else {k: v[l] for k, v in cache_stage.items()})

        def run(carry, p=p, dyn_slot=dyn_slot, cache_slot=cache_slot,
                tag=tag):
            return B.apply_block(
                cfg, dyncfg, mode, p, shared, carry, tag, dyn_slot,
                cache_slot, pos, kernel_impl=dcfg.kernel_impl,
                hash_proj=hash_proj)

        if mode == "train" and dcfg.remat == "block":
            carry, _, st, a = checkpoint(run, carry, use_reentrant=False)
        else:
            carry, _, st, a = run(carry)
        per_slot.append(st)
        aux = aux + a
    stats = {k: torch.stack([st.get(k, z) for st in per_slot])
             for k, z in zero.items()}
    return carry, cache_stage, stats, aux


def _stat_zeros(cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in B.stats_spec(cfg).items()}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
AUX_LOSS_COEF = 0.01


def head_weight(params):
    head = params.get("head")
    return params["embed"].T if head is None else head


def reference_loss(cfg: ModelConfig, dcfg: DistConfig,
                   dyncfg: DynamicsConfig, params, assignment, dyn, tokens,
                   labels, label_mask=None, *, hash_proj=None):
    """Apply all blocks in global order, unpipelined — the oracle the
    pipelined loss is held against; same math (MoE aux weighting added
    identically)."""
    check_ported(cfg, dyncfg)
    tags = assignment["tags"].tolist()
    carry = embed(params, cfg, tokens)
    carry["x"] = carry["x"].to(param_dtype(dcfg))
    pos = torch.arange(carry["x"].shape[1], device=carry["x"].device)
    aux_total = 0.0
    for s, row in enumerate(tags):
        stage_params = {k: v[s] for k, v in params["stages"].items()}
        dyn_stage = {k: v[s] for k, v in dyn.items()}
        carry, _, _, aux = stage_forward(
            cfg, dcfg, dyncfg, "train", stage_params, params["shared"], row,
            dyn_stage, carry, None, pos, 0, hash_proj=hash_proj)
        aux_total = aux_total + aux
    h = carry["x"]
    if label_mask is None:
        label_mask = torch.ones(labels.shape, device=h.device)
    hn = rms_norm(h, params["final_norm"], cfg.norm_eps).float()
    loss = cross_entropy_with_head(hn, head_weight(params).float(), labels,
                                   label_mask=label_mask)
    return loss + AUX_LOSS_COEF * aux_total / max(1, cfg.total_blocks())
