"""GPipe serving schedule on one device — the serving subset of
``repro.pipeline.pipeline``.

The reference runs S stages as a ``shard_map`` over the ``model`` mesh axis
and passes each tick's carries around the ring with ``ppermute``.  Here all
S stage buffers live on one card in a single process: a tick walks the
stages, and the ring ``ppermute`` becomes a roll of the buffer list
(stage s's output is stage s+1's input on the next tick; stage 0 ingests a
fresh microbatch instead).  The schedule keeps the reference's
``num_micro + S - 1`` ticks and its ``mvalid`` masking: a (stage, tick)
pair outside ``0 <= t - s < num_micro`` changes nothing in the reference
(its cache writes are masked or steered to the trash block), so the port
decides that on the host and skips the pair.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import DistConfig, ModelConfig
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.models import model as M


@dataclasses.dataclass(frozen=True)
class PipelineShapes:
    """Concrete global shapes of one pipeline execution."""
    num_micro: int
    mb_global: int          # per-microbatch batch (lanes)
    seq: int                # token positions fed to the decoder stream
    cache_len: int = 0      # decode cache capacity


def _stage_slice(tree, s: int):
    return {k: v[s] for k, v in tree.items()}


def _ticks(m: int, S: int):
    """(tick, stage, micro) for every valid pair of the GPipe schedule.
    Within a tick the stages run last to first, so each stage takes its
    input (the previous tick's output upstream) before the stage upstream
    overwrites it."""
    for t in range(m + S - 1):
        for idx in reversed(range(S)):
            if 0 <= t - idx < m:
                yield t, idx, t - idx


# ---------------------------------------------------------------------------
# Decode (serve_step): one token for every request, pipelined microbatches
# ---------------------------------------------------------------------------
def build_decode_fn(cfg: ModelConfig, dcfg: DistConfig,
                    dyncfg: DynamicsConfig, shapes: PipelineShapes, *,
                    paged: bool = False, temperature: float = 0.0,
                    num_micro: Optional[int] = None, hash_proj=None):
    """Returns decode_fn(params, assignment, dyn, cache, tokens, pos[,
    page_table]) -> (next_ids [m, B] i32, logprobs [m, B] f32, cache).

    tokens: [m, B] current token per request; pos: a scalar position (every
    lane at the same point) or [m, B] per-lane absolute positions.
    cache: {field: [S, L_max, m, B, ...]} — or, with ``paged``, the block
    pool {kp, vp: [S, L_max, pool+1, page, kv, hd]} plus a ``page_table``
    [m, B, J] int32 argument (-1 = unmapped).  The cache is updated in place
    and returned.

    ``num_micro``: the live microbatch count; the tick loop runs only
    ``num_micro + S - 1`` ticks (inputs and outputs keep their full
    [num_micro_full, B] shapes)."""
    M.check_ported(cfg, dyncfg)
    if temperature > 0.0:
        raise NotImplementedError(
            "temperature > 0 sampling is not in repro_torch yet (ROADMAP "
            "Queue 1 [serve-sampling]: a Philox sampler replaces jax's "
            "PRNG)")
    S = dcfg.num_stages
    dt = M.param_dtype(dcfg)
    m_live = shapes.num_micro if num_micro is None else num_micro
    if not (1 <= m_live <= shapes.num_micro):
        raise ValueError(f"num_micro={m_live} outside [1, "
                         f"{shapes.num_micro}]")

    def decode_fn(params, assignment, dyn, cache, tokens, pos,
                  page_table=None):
        per_lane = pos.dim() == 2
        if paged and (not per_lane or page_table is None):
            raise ValueError("paged decode requires per-lane positions and "
                             "a page table")
        device = tokens.device
        tags = assignment["tags"].tolist()
        B = shapes.mb_global
        ids_out = torch.zeros((shapes.num_micro, B), dtype=torch.int32,
                              device=device)
        lp_out = torch.zeros((shapes.num_micro, B), dtype=torch.float32,
                             device=device)
        buf: Dict[int, dict] = {}
        for t, idx, mi in _ticks(m_live, S):
            if idx == 0:
                x = params["embed"].float()[tokens[mi].long()]
                carry = {"x": x[:, None, :].to(dt)}
            else:
                carry = buf.pop(idx)
            L_m = len(tags[idx])
            if paged:
                # pool leaves have no micro axis; the tick's page table and
                # write-ok flag ride as per-slot cache entries
                pt_mb = page_table[mi]
                cache_mb = {"kp": cache["kp"][idx], "vp": cache["vp"][idx],
                            "pt": pt_mb[None].expand(L_m, *pt_mb.shape),
                            "wok": [1] * L_m}
            else:
                cache_mb = {k: v[idx][:, mi] for k, v in cache.items()}
            pos_mb = pos[mi] if per_lane else pos
            carry, _, _, _ = M.stage_forward(
                cfg, dcfg, dyncfg, "decode", _stage_slice(params["stages"],
                                                          idx),
                params["shared"], tags[idx], _stage_slice(dyn, idx), carry,
                cache_mb, pos_mb, idx * L_m, hash_proj=hash_proj)
            if idx == S - 1:
                logits = M.lm_logits(params, cfg, carry["x"][:, 0])
                nid = torch.argmax(logits, dim=-1)
                lp = torch.log_softmax(logits, dim=-1)
                ids_out[mi] = nid.to(torch.int32)
                lp_out[mi] = lp.gather(-1, nid[:, None])[:, 0]
            else:
                buf[idx + 1] = carry          # the ring roll
        return ids_out, lp_out, cache

    return decode_fn


# ---------------------------------------------------------------------------
# Prefill: forward pass that fills the decode cache
# ---------------------------------------------------------------------------
def build_prefill_fn(cfg: ModelConfig, dcfg: DistConfig,
                     dyncfg: DynamicsConfig, shapes: PipelineShapes, *,
                     hash_proj=None):
    """Returns prefill_fn(params, assignment, dyn, cache, batch)
    -> (last_ids [m, B] i32, cache).

    batch = {"tokens": [m, B, seq] int}; cache: the dense {k, v:
    [S, L_max, m, B, cap, kv, hd]}, whose lane lines are written in place
    and returned."""
    M.check_ported(cfg, dyncfg)
    S = dcfg.num_stages
    dt = M.param_dtype(dcfg)

    def prefill_fn(params, assignment, dyn, cache, batch):
        tokens = batch["tokens"]
        device = tokens.device
        m = shapes.num_micro
        tags = assignment["tags"].tolist()
        depth_base = assignment["depth_base"].tolist()
        pos = torch.arange(shapes.seq, device=device)
        ids_out = torch.zeros((m, shapes.mb_global), dtype=torch.int32,
                              device=device)
        buf: Dict[int, dict] = {}
        for t, idx, mi in _ticks(m, S):
            if idx == 0:
                carry = M.embed(params, cfg, tokens[mi])
                carry["x"] = carry["x"].to(dt)
            else:
                carry = buf.pop(idx)
            cache_mb = {k: v[idx][:, mi] for k, v in cache.items()}
            carry, _, _, _ = M.stage_forward(
                cfg, dcfg, dyncfg, "prefill", _stage_slice(params["stages"],
                                                           idx),
                params["shared"], tags[idx], _stage_slice(dyn, idx), carry,
                cache_mb, pos, depth_base[idx], hash_proj=hash_proj)
            if idx == S - 1:
                logits = M.lm_logits(params, cfg, carry["x"][:, -1])
                ids_out[mi] = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                buf[idx + 1] = carry          # the ring roll
        return ids_out, cache

    return prefill_fn
