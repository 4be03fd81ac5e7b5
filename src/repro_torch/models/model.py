"""Whole-model assembly on top of the slot-block layer — the port of
``repro.models.model``.

Parameters (same keys and stacked layout as the reference)
  params = {
    "embed":  [V, d],
    "head":   [d, V]            (absent when tied),
    "final_norm": [d],
    "stages": {field: [S, L_max, ...]},     # stacked slot params
    "shared": {...},                        # zamba2 shared attn, whisper pos
  }

Assignment — host tensors (it steers host control flow: which slot runs)
  assignment = {"tags": int32 [S, L_max], "num_active": int32 [S],
                "depth_base": int32 [S]}

Dynamism state
  dyn = {"ff_mask": f32 [S, L_max, npb], "frozen": f32 [S, L_max],
         "mod_router": f32 [S, L_max, d], "mod_on": f32 [S, L_max]   (mod),
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

# every dynamism kind of the reference
PORTED_DYNAMICS = ("none", "moe", "pruning", "freezing", "sparse_attention",
                   "early_exit", "mod")


def check_ported(cfg: ModelConfig, dyncfg: DynamicsConfig) -> None:
    B.check_ported(cfg)
    if dyncfg.kind not in PORTED_DYNAMICS:
        raise ValueError(f"unknown dynamism kind {dyncfg.kind!r}; have "
                         f"{PORTED_DYNAMICS}")


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


def assignment_spec(cfg: ModelConfig, dcfg: DistConfig
                    ) -> Dict[str, B.TensorSpec]:
    """``make_assignment``'s shapes and dtypes, allocating nothing."""
    S, L_max = dcfg.num_stages, dcfg.slots_for(cfg)
    return {"tags": B.TensorSpec((S, L_max), torch.int32),
            "num_active": B.TensorSpec((S,), torch.int32),
            "depth_base": B.TensorSpec((S,), torch.int32)}


# ---------------------------------------------------------------------------
# Params / dyn-state / cache construction
# ---------------------------------------------------------------------------
def param_dtype(dcfg: DistConfig) -> torch.dtype:
    return torch.bfloat16 if dcfg.param_dtype == "bfloat16" else torch.float32


def param_spec(cfg: ModelConfig, dcfg: DistConfig) -> Dict[str, Any]:
    """Stage params in the configured dtype; embed / head / final_norm and
    the shared params in float32, as in the reference."""
    dt = param_dtype(dcfg)
    S, L_max = dcfg.num_stages, dcfg.slots_for(cfg)
    stages = {k: B.TensorSpec((S, L_max) + v.shape, v.dtype)
              for k, v in B.slot_param_spec(cfg, dt).items()}
    spec = {
        "embed": B.TensorSpec((cfg.vocab_size, cfg.d_model), torch.float32),
        "final_norm": B.TensorSpec((cfg.d_model,), torch.float32),
        "stages": stages,
        "shared": B.shared_param_spec(cfg, torch.float32),
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
    }
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn((d, V), generator=gen, device=device)
                          * d ** -0.5)
    params["shared"] = B.init_shared(gen, cfg, torch.float32, device)
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
    if dyncfg.uses_mod:
        # the router and the per-slot switch, zeros as in the reference
        # (nothing there sets mod_on, so MoD's output mix stays off)
        dyn["mod_router"] = torch.zeros((S, L_max, cfg.d_model),
                                        device=device)
        dyn["mod_on"] = torch.zeros((S, L_max), device=device)
    if dyncfg.expert_relayout and cfg.num_experts:
        # logical expert -> physical kernel group, per slot (identity at
        # init), float32 as in the reference; its [S, L_max] leading dims
        # migrate with every other dyn leaf.  Only the pallas grouped path
        # reads it, and the placement never changes the model function.
        dyn["expert_map"] = torch.arange(
            cfg.num_experts, dtype=torch.float32, device=device).repeat(
                S, L_max, 1)
    return dyn


def dyn_spec(cfg: ModelConfig, dcfg: DistConfig,
             dyncfg: DynamicsConfig) -> Dict[str, B.TensorSpec]:
    """``init_dyn``'s shapes and dtypes, allocating nothing (built on the
    ``meta`` device)."""
    return {k: B.TensorSpec(tuple(v.shape), v.dtype)
            for k, v in init_dyn(cfg, dcfg, dyncfg, "meta").items()}


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
def embed(params, cfg: ModelConfig, tokens, *, prefix_emb=None,
          pos_offset=0) -> Dict[str, torch.Tensor]:
    """tokens: [b, s] int -> carry dict {"x": [b, s, d]}.

    ``prefix_emb``: [b, p, d] precomputed modality embeddings — VLM patches,
    prepended to the token stream, or whisper's audio frames, which become
    the encoder stream ``carry["enc"]`` (plus a sinusoid).  Encoder–decoder
    archs add the decoder's learned positions ``dec_pos`` from
    ``pos_offset`` (an int, or a 0-d tensor: one position)."""
    x = params["embed"][tokens.long()]
    if cfg.is_encdec:
        s = tokens.shape[1]
        dec_pos = params["shared"]["dec_pos"]
        if isinstance(pos_offset, int):
            pos = dec_pos[pos_offset:pos_offset + s]
        else:
            pos = dec_pos[pos_offset.reshape(1).long()]
        x = x + pos[None].to(x.dtype)
        carry = {"x": x}
        if prefix_emb is not None:
            carry["enc"] = prefix_emb + _sinusoidal(
                prefix_emb.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
        return carry
    if cfg.family == "vlm" and prefix_emb is not None:
        x = torch.cat([prefix_emb.to(x.dtype), x], dim=1)
    return {"x": x}


def _sinusoidal(length: int, channels: int, device=None):
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(channels // 2, dtype=torch.float32,
                       device=device)[None, :]
    inv = torch.exp(-torch.log(torch.tensor(10000.0)) * dim
                    / (channels // 2))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def prefix_len(cfg: ModelConfig) -> int:
    """Positions the VLM patch prefix adds in front of the tokens."""
    return cfg.num_patches if cfg.family == "vlm" else 0


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
    each slot in the backward (``torch.utils.checkpoint``).

    Mixture-of-Depths (``train`` mode) and early exit (every mode) wrap
    each active slot's output as the reference's ``slot_fn`` does; early
    exit's depth fraction is ``(stage_depth_base + l) / total_blocks``.
    Both executors of the reference (``slot_exec`` "masked_scan" and
    "bounded_loop") are this one loop: PAD slots are skipped on the host,
    so the loop's trip count is the stage's active slots either way."""
    zero = _stat_zeros(cfg, carry["x"].device)
    total = max(1, cfg.total_blocks())
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
                tag=tag, l=l):
            out, c, st, a = B.apply_block(
                cfg, dyncfg, mode, p, shared, carry, tag, dyn_slot,
                cache_slot, pos, kernel_impl=dcfg.kernel_impl,
                hash_proj=hash_proj)
            if dyncfg.uses_mod and mode == "train":
                out, _ = _mod_wrap(cfg, dyncfg, dyn_slot, carry, out)
            if dyncfg.uses_early_exit:
                out, _ = _ee_update(cfg, dyncfg, carry, out,
                                    (stage_depth_base + l) / total)
            return out, c, st, a

        if mode == "train" and dcfg.remat == "block":
            carry, _, st, a = checkpoint(run, carry, use_reentrant=False)
        else:
            carry, _, st, a = run(carry)
        per_slot.append(st)
        aux = aux + a
    stats = {k: torch.stack([st.get(k, z) for st in per_slot])
             for k, z in zero.items()}
    return carry, cache_stage, stats, aux


def _mod_wrap(cfg: ModelConfig, dyncfg: DynamicsConfig, dyn_slot,
              carry_in, carry_out):
    """Mixture-of-Depths as the reference's output mix: where the slot's
    ``mod_on`` is set, the top ``mod_capacity`` share of tokens (by the
    slot's router score) take the block's output and the rest keep their
    input; elsewhere the output passes unchanged.  Returns (carry, the
    processed token fraction)."""
    x_in, x_out = carry_in["x"], carry_out["x"]
    s = x_in.shape[1]
    k = max(1, int(dyncfg.mod_capacity * s))
    scores = torch.einsum("bsd,d->bs", x_in.float(), dyn_slot["mod_router"])
    thresh = torch.topk(scores, k, dim=-1).values[:, -1:]
    sel = (scores >= thresh)[..., None]
    on = dyn_slot["mod_on"] > 0
    new_x = torch.where(on, torch.where(sel, x_out, x_in), x_out)
    return {**carry_out, "x": new_x}, torch.where(on, k / s, 1.0)


def _ee_update(cfg: ModelConfig, dyncfg: DynamicsConfig, carry_in,
               carry_out, depth_frac: float):
    """Early exit: a token whose block output is within ``ee_threshold``
    cosine of its input (at a depth fraction of at least
    ``ee_min_layer_frac``) is marked in ``carry["exited"]`` [b, s]; a token
    already marked keeps its input activation.  A carry without
    ``exited`` (decode) passes unchanged.  Returns (carry, the active
    token fraction)."""
    x_in, x_out = carry_in["x"], carry_out["x"]
    exited = carry_in.get("exited")
    if exited is None:
        return carry_out, 1.0
    xi, xo = x_in.float(), x_out.float()
    cos = (xi * xo).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(xi, dim=-1)
        * torch.linalg.vector_norm(xo, dim=-1), min=1e-6)
    newly = (cos > dyncfg.ee_threshold) & (
        depth_frac >= dyncfg.ee_min_layer_frac)
    exited_new = torch.maximum(exited, newly.to(exited.dtype))
    x_keep = torch.where(exited[..., None] > 0, x_in, x_out)
    return ({**carry_out, "x": x_keep, "exited": exited_new},
            1.0 - exited.mean())


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


def lm_loss(params, cfg: ModelConfig, h, labels, label_mask=None,
            vocab_axis=None, vocab_offset: int = 0):
    """h: [b, s, d] final hidden -> mean cross-entropy.  ``vocab_axis``: a
    ``(comm, group)`` pair when the head is vocab-sharded over the group's
    ranks (this rank's shard starts at ``vocab_offset``), as the
    reference's mesh axis name."""
    hn = rms_norm(h, params["final_norm"], cfg.norm_eps)
    comm, group = (None, None) if vocab_axis is None else vocab_axis
    return cross_entropy_with_head(hn, head_weight(params), labels,
                                   label_mask=label_mask,
                                   vocab_offset=vocab_offset, group=group,
                                   comm=comm)


def reference_loss(cfg: ModelConfig, dcfg: DistConfig,
                   dyncfg: DynamicsConfig, params, assignment, dyn, tokens,
                   labels, label_mask=None, prefix_emb=None, *,
                   hash_proj=None):
    """Apply all blocks in global order, unpipelined — the oracle the
    pipelined loss is held against; same math (MoE aux weighting added
    identically).  ``prefix_emb``: the VLM patches or whisper's frames, as
    ``embed`` takes them; the loss reads the positions after the VLM
    prefix."""
    check_ported(cfg, dyncfg)
    tags = assignment["tags"].tolist()
    dt = param_dtype(dcfg)
    carry = embed(params, cfg, tokens, prefix_emb=prefix_emb)
    carry["x"] = carry["x"].to(dt)
    if "enc" in carry:
        carry["enc"] = carry["enc"].to(dt)
    if dyncfg.uses_early_exit:
        carry["exited"] = torch.zeros(carry["x"].shape[:2],
                                      device=carry["x"].device)
    pos = torch.arange(carry["x"].shape[1], device=carry["x"].device)
    aux_total = 0.0
    depth = 0       # blocks applied so far: early exit's global depth
    for s, row in enumerate(tags):
        stage_params = {k: v[s] for k, v in params["stages"].items()}
        dyn_stage = {k: v[s] for k, v in dyn.items()}
        carry, _, _, aux = stage_forward(
            cfg, dcfg, dyncfg, "train", stage_params, params["shared"], row,
            dyn_stage, carry, None, pos, depth, hash_proj=hash_proj)
        aux_total = aux_total + aux
        depth += sum(1 for t in row if t != BLOCK_PAD)
    h = carry["x"][:, prefix_len(cfg):]
    if label_mask is None:
        label_mask = torch.ones(labels.shape, device=h.device)
    hn = rms_norm(h, params["final_norm"], cfg.norm_eps).float()
    loss = cross_entropy_with_head(hn, head_weight(params).float(), labels,
                                   label_mask=label_mask)
    return loss + AUX_LOSS_COEF * aux_total / max(1, cfg.total_blocks())
