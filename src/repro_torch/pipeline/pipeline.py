"""GPipe schedule on one device — the port of
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

Training (``build_loss_fn``) runs the same ticks forward, keeps each
finished microbatch's hidden state, then takes the head + log-sum-exp loss
per microbatch after the schedule (recomputed in the backward, as the
reference's ``jax.checkpoint`` of that body); ``value_and_grad`` takes the
gradients of every param leaf, stage params per active slot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BLOCK_PAD, DistConfig, ModelConfig
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.models import model as M
from repro_torch.pipeline import sampling


@dataclasses.dataclass(frozen=True)
class PipelineShapes:
    """Concrete global shapes of one pipeline execution."""
    num_micro: int
    mb_global: int          # per-microbatch batch (lanes)
    seq: int                # token positions fed to the decoder stream
    cache_len: int = 0      # decode cache capacity
    prefix: int = 0         # VLM patch prefix length (prepended)
    enc_seq: int = 0        # whisper encoder frames

    @property
    def seq_total(self) -> int:
        return self.seq + self.prefix

    @classmethod
    def for_model(cls, cfg: ModelConfig, num_micro: int, mb_global: int,
                  seq: int, cache_len: int = 0) -> "PipelineShapes":
        """Shapes with the arch's modality prefix and encoder length, as
        the reference's ``plan_shapes`` derives them."""
        return cls(num_micro, mb_global, seq, cache_len,
                   prefix=M.prefix_len(cfg),
                   enc_seq=cfg.encoder_seq if cfg.is_encdec else 0)


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
                    num_micro: Optional[int] = None, hash_proj=None,
                    stage_timer=None):
    """Returns decode_fn(params, assignment, dyn, cache, tokens, pos[,
    page_table][, seeds]) -> (next_ids [m, B] i32, logprobs [m, B] f32, cache,
    moe_drop_sum f32 — the MoE capacity-drop fractions summed over every
    slot of every valid tick, 0 for non-MoE archs).

    tokens: [m, B] current token per request; pos: a scalar position (every
    lane at the same point) or [m, B] per-lane absolute positions.
    cache: {field: [S, L_max, m, B, ...]} — or, with ``paged``, the block
    pool {kp, vp: [S, L_max, pool+1, page, kv, hd]} plus a ``page_table``
    [m, B, J] int32 argument (-1 = unmapped).  The cache is updated in place
    and returned.

    ``num_micro``: the live microbatch count; the tick loop runs only
    ``num_micro + S - 1`` ticks (inputs and outputs keep their full
    [num_micro_full, B] shapes).

    ``temperature`` > 0 samples each lane from ``softmax(logits / T)``
    (``pipeline.sampling``: Philox keyed by the lane's ``seeds`` [m, B]
    int32, Gumbel-max); the logprob stays the untempered ``log_softmax``
    at the chosen id.  0 keeps the argmax.

    ``stage_timer`` (an ``obs.timing.StageTimer``) stamps each stage's
    call, as the loss does.

    Encoder–decoder archs decode at a scalar position only: their
    embedding adds ``dec_pos[pos]``, and per-lane positions raise as the
    reference does."""
    M.check_ported(cfg, dyncfg)
    S = dcfg.num_stages
    dt = M.param_dtype(dcfg)
    m_live = shapes.num_micro if num_micro is None else num_micro
    if not (1 <= m_live <= shapes.num_micro):
        raise ValueError(f"num_micro={m_live} outside [1, "
                         f"{shapes.num_micro}]")

    def decode_fn(params, assignment, dyn, cache, tokens, pos,
                  page_table=None, seeds=None):
        per_lane = pos.dim() == 2
        if per_lane and cfg.is_encdec:
            raise ValueError(
                "per-lane decode positions need a per-lane dec_pos gather; "
                "encoder-decoder serving uses the scalar-pos path (the "
                "reference lacks per-lane encoder-decoder decode)")
        if paged and (not per_lane or page_table is None):
            raise ValueError("paged decode requires per-lane positions and "
                             "a page table")
        if (temperature > 0.0) != (seeds is not None):
            raise ValueError("per-lane seeds are required iff temperature "
                             "> 0")
        device = tokens.device
        tags = assignment["tags"].tolist()
        B = shapes.mb_global
        ids_out = torch.zeros((shapes.num_micro, B), dtype=torch.int32,
                              device=device)
        lp_out = torch.zeros((shapes.num_micro, B), dtype=torch.float32,
                             device=device)
        drop = torch.zeros((), device=device)
        buf: Dict[int, dict] = {}
        for t, idx, mi in _ticks(m_live, S):
            if idx == 0:
                # encoder-decoder archs add dec_pos at the (scalar) position
                x = M.embed(params, cfg, tokens[mi][:, None],
                            pos_offset=pos.clamp(0, cfg.max_seq_len - 1))
                carry = {"x": x["x"].to(dt)}
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
            if stage_timer is not None:
                stage_timer.stamp(idx, 0)
            carry, _, st, _ = M.stage_forward(
                cfg, dcfg, dyncfg, "decode", _stage_slice(params["stages"],
                                                          idx),
                params["shared"], tags[idx], _stage_slice(dyn, idx), carry,
                cache_mb, pos_mb, idx * L_m, hash_proj=hash_proj)
            if stage_timer is not None:
                stage_timer.stamp(idx, 1)
            if cfg.num_experts:
                drop = drop + st["moe_dropped"].sum()
            if idx == S - 1:
                logits = M.lm_logits(params, cfg, carry["x"][:, 0])
                if temperature > 0.0:
                    ids_out[mi], lp_out[mi] = sampling.sample(
                        logits, seeds[mi], temperature)
                else:
                    nid = torch.argmax(logits, dim=-1)
                    lp = torch.log_softmax(logits, dim=-1)
                    ids_out[mi] = nid.to(torch.int32)
                    lp_out[mi] = lp.gather(-1, nid[:, None])[:, 0]
            else:
                buf[idx + 1] = carry          # the ring roll
        return ids_out, lp_out, cache, drop

    return decode_fn


# ---------------------------------------------------------------------------
# Prefill: forward pass that fills the decode cache
# ---------------------------------------------------------------------------
def build_prefill_fn(cfg: ModelConfig, dcfg: DistConfig,
                     dyncfg: DynamicsConfig, shapes: PipelineShapes, *,
                     hash_proj=None, stage_timer=None):
    """Returns prefill_fn(params, assignment, dyn, cache, batch)
    -> (last_ids [m, B] i32, cache, moe_drop_sum f32 as in decode).
    ``stage_timer`` stamps each stage's call, as in decode.

    batch = {"tokens": [m, B, seq] int, optional "prefix_emb" [m, B, P, d]
    (VLM) / "frames" [m, B, enc_seq, d] (whisper)}; cache: the dense
    {field: [S, L_max, m, B, ...]}, whose lane lines are written in place
    and returned."""
    M.check_ported(cfg, dyncfg)
    S = dcfg.num_stages
    dt = M.param_dtype(dcfg)

    def prefill_fn(params, assignment, dyn, cache, batch):
        tokens = batch["tokens"]
        device = tokens.device
        m = shapes.num_micro
        tags = assignment["tags"].tolist()
        pos = torch.arange(shapes.seq_total, device=device)
        ids_out = torch.zeros((m, shapes.mb_global), dtype=torch.int32,
                              device=device)
        drop = torch.zeros((), device=device)
        buf: Dict[int, dict] = {}
        for t, idx, mi in _ticks(m, S):
            if idx == 0:
                carry = _ingest(params, cfg, dyncfg, tokens[mi], dt,
                                _prefix(batch, mi))
            else:
                carry = buf.pop(idx)
            cache_mb = {k: v[idx][:, mi] for k, v in cache.items()}
            # the reference's prefill passes idx * L_max as the stage's depth
            # base (its loss passes depth_base); early exit reads it
            if stage_timer is not None:
                stage_timer.stamp(idx, 0)
            carry, _, st, _ = M.stage_forward(
                cfg, dcfg, dyncfg, "prefill", _stage_slice(params["stages"],
                                                           idx),
                params["shared"], tags[idx], _stage_slice(dyn, idx), carry,
                cache_mb, pos, idx * len(tags[idx]), hash_proj=hash_proj)
            if stage_timer is not None:
                stage_timer.stamp(idx, 1)
            if cfg.num_experts:
                drop = drop + st["moe_dropped"].sum()
            if idx == S - 1:
                # the first token is the argmax even when decode samples
                # (as the reference's prefill emits it)
                logits = M.lm_logits(params, cfg, carry["x"][:, -1])
                ids_out[mi] = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                buf[idx + 1] = carry          # the ring roll
        return ids_out, cache, drop

    return prefill_fn


# ---------------------------------------------------------------------------
# Training / evaluation loss
# ---------------------------------------------------------------------------
def build_loss_fn(cfg: ModelConfig, dcfg: DistConfig, dyncfg: DynamicsConfig,
                  shapes: PipelineShapes, mode: str = "train", *,
                  hash_proj=None, stage_timer=None):
    """Returns loss_fn(params, assignment, dyn, batch) -> (loss, stats).

    batch = {"tokens", "labels": [m, B, seq] int, "label_mask": [m, B, seq]
    f32, optional "prefix_emb" [m, B, P, d] (VLM patches, prepended: the
    loss reads the positions after them) / "frames" [m, B, enc_seq, d]
    (whisper's encoder stream, which rides the carry as ``enc``)}.
    loss = sum(nll) / sum(mask) + AUX_LOSS_COEF * aux; stats: the
    per-slot profiler aggregates {field: [S, L_max, ...]} summed over the
    valid ticks (detached).  ``stage_timer`` (an ``obs.timing.StageTimer``)
    is stamped around each stage's forward call (in-step stage timing; the
    backward is not stamped)."""
    M.check_ported(cfg, dyncfg)
    S = dcfg.num_stages
    dt = M.param_dtype(dcfg)

    def loss_fn(params, assignment, dyn, batch):
        tokens = batch["tokens"]
        device = tokens.device
        m = shapes.num_micro
        tags = assignment["tags"].tolist()
        depth_base = assignment["depth_base"].tolist()
        pos = torch.arange(shapes.seq_total, device=device)
        per_stage = [None] * S
        aux_acc = 0.0
        h_seq = [None] * m
        exited = []
        buf: Dict[int, dict] = {}
        for t, idx, mi in _ticks(m, S):
            if idx == 0:
                carry = _ingest(params, cfg, dyncfg, tokens[mi], dt,
                                _prefix(batch, mi))
            else:
                carry = buf.pop(idx)

            def stage_fn(carry, idx=idx):
                return M.stage_forward(
                    cfg, dcfg, dyncfg, mode,
                    _stage_slice(params["stages"], idx), params["shared"],
                    tags[idx], _stage_slice(dyn, idx), carry, None, pos,
                    depth_base[idx], hash_proj=hash_proj)

            if stage_timer is not None:
                stage_timer.stamp(idx, 0)
            if dcfg.remat == "full":
                carry, _, stats, aux = checkpoint(stage_fn, carry,
                                                  use_reentrant=False)
            else:
                carry, _, stats, aux = stage_fn(carry)
            if stage_timer is not None:
                stage_timer.stamp(idx, 1)
            stats = {k: v.detach() for k, v in stats.items()}
            per_stage[idx] = (stats if per_stage[idx] is None else
                              {k: per_stage[idx][k] + v
                               for k, v in stats.items()})
            aux_acc = aux_acc + aux
            if idx == S - 1:
                h_seq[mi] = carry["x"][:, shapes.prefix:]
                if "exited" in carry:
                    exited.append(carry["exited"].detach().mean())
            else:
                buf[idx + 1] = carry          # the ring roll
        head = M.head_weight(params)
        nll = cnt = 0.0
        for mi in range(m):
            n_, c_ = checkpoint(_micro_loss, params["final_norm"], head,
                                h_seq[mi], batch["labels"][mi],
                                batch["label_mask"][mi], cfg.norm_eps,
                                use_reentrant=False)
            nll, cnt = nll + n_, cnt + c_
        loss = nll / torch.clamp(cnt, min=1.0)
        loss = loss + M.AUX_LOSS_COEF * aux_acc / (m * max(
            1, cfg.total_blocks()))
        stats = {k: torch.stack([st[k] for st in per_stage])
                 for k in per_stage[0]}
        if exited:
            # early exit: the share of tokens marked exited after the last
            # stage, over the step's microbatches (a device scalar)
            stats["exited_frac"] = torch.stack(exited).mean()
        return loss, stats

    return loss_fn


def _prefix(batch, mi: int):
    """One microbatch's modality input (VLM patches or whisper frames), or
    None; the frames win when a batch holds both, as in the reference."""
    for key in ("frames", "prefix_emb"):
        if key in batch:
            return batch[key][mi]
    return None


def _ingest(params, cfg: ModelConfig, dyncfg: DynamicsConfig, tokens, dt,
            prefix=None):
    """Stage 0's fresh carry for one microbatch: the embedding (with the
    modality ``prefix`` cast to the stage dtype), the encoder stream for
    encoder–decoder archs, and, under early exit, the ``exited`` [b,
    seq_total] marks (zeros) that ride the stage-to-stage hand-off with
    it."""
    if prefix is not None:
        prefix = prefix.to(dt)
    carry = M.embed(params, cfg, tokens, prefix_emb=prefix)
    carry["x"] = carry["x"].to(dt)
    if "enc" in carry:
        carry["enc"] = carry["enc"].to(dt)
    if dyncfg.uses_early_exit:
        carry["exited"] = torch.zeros(carry["x"].shape[:2],
                                      device=tokens.device)
    return carry


def _micro_loss(final_norm, head, h, labels, label_mask, eps):
    hn = M.rms_norm(h, final_norm, eps)
    logits = hn.float() @ head.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return ((lse - ll) * label_mask).sum(), label_mask.sum()


def value_and_grad(loss_fn, params, assignment, dyn, batch):
    """(loss, stats, grads) of ``loss_fn``; ``grads`` has ``params``' tree
    and shapes.

    Each stage field is handed to the loss as per-slot leaves (detached
    views of the stacked tensor, no copy) so the backward writes each
    slot's gradient once instead of scattering into a full-size zero
    buffer per use; PAD slots and frozen slots get zeros, as the reference's
    masked select and ``freezable`` give them."""
    tags = assignment["tags"].tolist()

    def leaf(v):
        return v.detach().requires_grad_(True)

    gp = {k: leaf(v) for k, v in params.items()
          if k not in ("stages", "shared")}
    gp["shared"] = {k: leaf(v) for k, v in params["shared"].items()}
    gp["stages"] = {
        k: [[(leaf(v[s, l]) if tags[s][l] != BLOCK_PAD else v[s, l])
             for l in range(v.shape[1])] for s in range(v.shape[0])]
        for k, v in params["stages"].items()}
    loss, stats = loss_fn(gp, assignment, dyn, batch)
    flat = []
    for k, v in gp.items():
        if k == "stages":
            for rows in v.values():
                flat += [t for row in rows for t in row if t.requires_grad]
        elif k == "shared":
            flat += list(v.values())
        else:
            flat.append(v)
    got = list(torch.autograd.grad(loss, flat, allow_unused=True))
    got.reverse()

    def take(t):
        # pop, so each slot's gradient is freed once it is stacked
        g = got.pop()
        return torch.zeros_like(t) if g is None else g

    grads = {}
    for k, v in gp.items():
        if k == "stages":
            grads[k] = {}
            for f, rows in v.items():
                full = torch.zeros_like(params["stages"][f])
                for s, row in enumerate(rows):
                    for l, t in enumerate(row):
                        if t.requires_grad:
                            full[s, l] = take(t)
                grads[k][f] = full
        elif k == "shared":
            grads[k] = {n: take(t) for n, t in v.items()}
        else:
            grads[k] = take(v)
    return loss.detach(), stats, grads
