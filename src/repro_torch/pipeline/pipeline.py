"""GPipe schedule — the port of ``repro.pipeline.pipeline``.

The reference runs S stages as a ``shard_map`` over the ``model`` mesh axis
and passes each tick's carries around the ring with ``ppermute``.  The
port has two layouts of the same schedule:

  * one process (``mesh=None``): all S stage buffers live on one card, a
    tick walks the stages, and the ring ``ppermute`` becomes a roll of the
    buffer list (stage s's output is stage s+1's input on the next tick;
    stage 0 ingests a fresh microbatch instead);
  * one process per stage (``mesh``, a ``launch.mesh.Mesh`` of ranks):
    rank s holds row s of the stacked state and runs stage s's ticks only;
    the roll becomes ``send`` to s+1 and ``recv`` from s-1 on the model
    ring (``launch.dist.Comm``), into buffers of the carry's static shape
    (``_carry_spec``).  The batch's lanes are split over ``data``.

Both keep the reference's ``num_micro + S - 1`` ticks and its ``mvalid``
masking: a (stage, tick) pair outside ``0 <= t - s < num_micro`` changes
nothing in the reference (its cache writes are masked or steered to the
trash block), so the port decides that on the host and skips the pair.

Training (``build_loss_fn``) runs the same ticks forward, keeps each
finished microbatch's hidden state, then takes the head + log-sum-exp loss
per microbatch after the schedule (recomputed in the backward, as the
reference's ``jax.checkpoint`` of that body); ``value_and_grad`` takes the
gradients of every param leaf, stage params per active slot.  Across
ranks the backward walks each rank's ticks in reverse, receiving the
carry's gradient from s+1 and sending its input's gradient to s-1; the
loss's numerator and denominator are summed over every rank before the
division, as the reference's ``psum(nll) / psum(cnt)``.  Every sum the
ranks split — a slot leaf read several times in a call (its running sum
enters each call first), a shared leaf read on several stages (per stage,
then in stage order, in one process too), the MoE aux losses and drop
fractions (in the one-process tick order) — adds in the one process's
order, so at data 1 the ranks are bitwise one process.
"""
from __future__ import annotations

import dataclasses
import time
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


def plan_shapes(cfg: ModelConfig, dcfg: DistConfig, shape_kind: str,
                seq_len: int, global_batch: int, dp_degree: int
                ) -> PipelineShapes:
    """Microbatching of a shape cell over ``dp_degree`` data replicas, as
    the reference's ``plan_shapes`` derives it: at most ``4 S``
    microbatches a replica; a batch smaller than the data degree (one
    500k-token request) is not split over ``data``."""
    prefix = M.prefix_len(cfg)
    enc_seq = cfg.encoder_seq if cfg.is_encdec else 0
    cache_len = seq_len if shape_kind in ("decode", "prefill") else 0
    if global_batch < dp_degree:
        return PipelineShapes(num_micro=1, mb_global=global_batch,
                              seq=seq_len, cache_len=cache_len,
                              prefix=prefix, enc_seq=enc_seq)
    per_replica = max(1, global_batch // dp_degree)
    num_micro = min(per_replica, 4 * dcfg.num_stages)
    mb = max(1, per_replica // num_micro)
    num_micro = max(1, per_replica // mb)
    return PipelineShapes(num_micro=num_micro, mb_global=mb * dp_degree,
                          seq=seq_len, cache_len=cache_len, prefix=prefix,
                          enc_seq=enc_seq)


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
                    stage_timer=None, mesh=None):
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
    reference does.

    With a ``mesh`` the cache is this rank's row ``[1, L_max, m, B / dp,
    ...]`` — paged: its rows of the pool, ``[1, L_max, pool+1, page, kv,
    hd]``, read through the whole page table's replica lanes — and every
    rank returns the whole ``[m, B]`` ids and logprobs (the last stage's,
    sampled there from the lane seeds at T > 0, broadcast over the ring and
    gathered over ``data``)."""
    M.check_ported(cfg, dyncfg)
    S = dcfg.num_stages
    dt = M.param_dtype(dcfg)
    m_live = shapes.num_micro if num_micro is None else num_micro
    if not (1 <= m_live <= shapes.num_micro):
        raise ValueError(f"num_micro={m_live} outside [1, "
                         f"{shapes.num_micro}]")
    if mesh is not None:
        return _mesh_decode_fn(cfg, dcfg, dyncfg, shapes, mesh, m_live,
                               temperature, hash_proj, stage_timer, paged)

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
                     hash_proj=None, stage_timer=None, mesh=None):
    """Returns prefill_fn(params, assignment, dyn, cache, batch)
    -> (last_ids [m, B] i32, cache, moe_drop_sum f32 as in decode).
    ``stage_timer`` stamps each stage's call, as in decode.

    batch = {"tokens": [m, B, seq] int, optional "prefix_emb" [m, B, P, d]
    (VLM) / "frames" [m, B, enc_seq, d] (whisper)}; cache: the dense
    {field: [S, L_max, m, B, ...]}, whose lane lines are written in place
    and returned.  With a ``mesh``, as in decode: the cache is the rank's
    row of its replica's lanes, the ids are whole on every rank."""
    M.check_ported(cfg, dyncfg)
    S = dcfg.num_stages
    dt = M.param_dtype(dcfg)
    if mesh is not None:
        return _mesh_prefill_fn(cfg, dcfg, dyncfg, shapes, mesh, hash_proj,
                                stage_timer)

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
                  hash_proj=None, stage_timer=None, mesh=None):
    """Returns loss_fn(params, assignment, dyn, batch) -> (loss, stats).

    batch = {"tokens", "labels": [m, B, seq] int, "label_mask": [m, B, seq]
    f32, optional "prefix_emb" [m, B, P, d] (VLM patches, prepended: the
    loss reads the positions after them) / "frames" [m, B, enc_seq, d]
    (whisper's encoder stream, which rides the carry as ``enc``)}.
    loss = sum(nll) / sum(mask) + AUX_LOSS_COEF * aux; stats: the
    per-slot profiler aggregates {field: [S, L_max, ...]} summed over the
    valid ticks (detached).  ``stage_timer`` (an ``obs.timing.StageTimer``)
    is stamped around each stage's forward call (in-step stage timing; the
    backward is not stamped).

    With a ``mesh`` the params' and dyn's stage trees are the rank's row
    ``[1, L_max, ...]``, the batch is the replica's lanes, the loss is the
    global one on every rank and the stats are gathered whole
    (``[S, L_max, ...]``, averaged over ``data``); ``value_and_grad`` runs
    the backward across the ranks.  ``stage_timer`` then times this rank's
    stage as its stage 0."""
    M.check_ported(cfg, dyncfg)
    S = dcfg.num_stages
    dt = M.param_dtype(dcfg)
    if mesh is not None:
        return _mesh_loss_fn(cfg, dcfg, dyncfg, shapes, mode, mesh,
                             hash_proj, stage_timer)

    def loss_fn(params, assignment, dyn, batch, sites=None):
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

            shared = _site(params["shared"], sites, idx)

            def stage_fn(carry, idx=idx, shared=shared):
                return M.stage_forward(
                    cfg, dcfg, dyncfg, mode,
                    _stage_slice(params["stages"], idx), shared,
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


def _site(shared, sites, stage: int):
    """The shared leaves one stage call reads: ``shared`` itself, or — under
    ``value_and_grad`` (``sites`` a list) — leaves of their own, recorded
    as ``(stage, leaves)``, so each call's gradient is taken apart and the
    calls' gradients are summed in one fixed order (``_sum_sites``) in one
    process and across ranks alike."""
    if sites is None or not shared:
        return shared
    own = {k: v.detach().requires_grad_(v.requires_grad)
           for k, v in shared.items()}
    sites.append((stage, own))
    return own


def _add_in_order(parts, like):
    """The non-None ``parts`` added in order; zeros of ``like`` when there
    are none (None when ``like`` is None)."""
    got = [g for g in parts if g is not None]
    if not got:
        return None if like is None else torch.zeros_like(like)
    tot = got[0]
    for g in got[1:]:
        tot = tot + g
    return tot


def _sum_sites(base, sites, stages, name):
    """Each stage's gradient of the shared leaf ``name``: the direct
    uses' (``base``, stage 0's ingest) and then its calls' in tick order;
    None where a stage has none."""
    out = []
    for s in stages:
        g = base if s == stages[0] else None
        for st, own in sites:
            t = own[name]
            if st == s and t.grad is not None:
                g = t.grad if g is None else g + t.grad
        out.append(g)
    return out


def _call_leaves(stage_p):
    """One stage call's own leaves of the per-slot param leaves
    (``value_and_grad``'s; detached views, no copy) and the (slot leaf,
    call leaf) pairs."""
    pairs = []

    def own(t):
        if not (torch.is_tensor(t) and t.requires_grad):
            return t
        q = t.detach().requires_grad_(True)
        pairs.append((t, q))
        return q
    if not all(isinstance(v, list) for v in stage_p.values()):
        return stage_p, pairs
    return {k: [own(t) for t in row] for k, row in stage_p.items()}, pairs


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


def value_and_grad(loss_fn, params, assignment, dyn, batch, phase=None):
    """(loss, stats, grads) of ``loss_fn``; ``grads`` has ``params``' tree
    and shapes.  ``phase`` (``obs.timing.StepSpans.phase``), when given,
    is called with ``"step.backward"`` between the loss and the gradients.

    Each stage field is handed to the loss as per-slot leaves (detached
    views of the stacked tensor, no copy) so the backward writes each
    slot's gradient once instead of scattering into a full-size zero
    buffer per use; PAD slots and frozen slots get zeros, as the reference's
    masked select and ``freezable`` give them.  A tied embedding gets a
    second leaf for its use as the head, and its gradient is the sum of the
    two (the ingest's and the head's): across ranks they are taken on the
    first and the last stage and meet in the ring's sum, in the same
    addition.

    A loss built with a ``mesh`` runs its own backward across the ranks;
    the gradients of the leaves replicated over ``model`` (embed, head,
    ``final_norm``, ``shared``) are then summed over the ring, and every
    gradient over ``data``."""
    mesh = getattr(loss_fn, "mesh", None)
    tags = assignment["tags"].tolist()
    rows = tags if mesh is None else [tags[mesh.stage]]

    def leaf(v):
        return v.detach().requires_grad_(True)

    gp = {k: leaf(v) for k, v in params.items()
          if k not in ("stages", "shared")}
    gp["shared"] = {k: leaf(v) for k, v in params["shared"].items()}
    gp["stages"] = {
        k: [[(leaf(v[s, l]) if rows[s][l] != BLOCK_PAD else v[s, l])
             for l in range(v.shape[1])] for s in range(v.shape[0])]
        for k, v in params["stages"].items()}
    view = dict(gp)
    tied = None
    if "head" not in params:
        tied = leaf(params["embed"])
        view["head"] = tied.T
    flat = []
    for k, v in gp.items():
        if k == "stages":
            for rows_ in v.values():
                flat += [t for row in rows_ for t in row if t.requires_grad]
        elif k == "shared":
            flat += list(v.values())
        else:
            flat.append(v)
    if tied is not None:
        flat.append(tied)
    sites = []
    if mesh is None:
        loss, stats = loss_fn(view, assignment, dyn, batch, sites=sites)
        if phase is not None:
            phase("step.backward")
        own = [t for _, leaves_ in sites for t in leaves_.values()
               if t.requires_grad]
        got = list(torch.autograd.grad(loss, flat + own, allow_unused=True))
        for t, g in zip(own, got[len(flat):]):
            t.grad = g
        del got[len(flat):]
    else:
        loss, stats = loss_fn(view, assignment, dyn, batch, backward=True,
                              sites=sites)
        got = [t.grad for t in flat]
    got.reverse()

    def take(t):
        # pop, so each slot's gradient is freed once it is stacked
        g = got.pop()
        return torch.zeros_like(t) if g is None else g

    grads = {}
    for k, v in gp.items():
        if k == "stages":
            grads[k] = {}
            for f, rows_ in v.items():
                full = torch.zeros_like(params["stages"][f])
                for s, row in enumerate(rows_):
                    for l, t in enumerate(row):
                        if t.requires_grad:
                            full[s, l] = take(t)
                grads[k][f] = full
        elif k == "shared":
            # a shared leaf's gradient is summed per stage, then over the
            # stages that read it, in stage order: the same additions in
            # one process and across ranks (``_reduce_grads``)
            grads[k] = {}
            for n, t in v.items():
                parts = _sum_sites(got.pop(), sites,
                                   list(range(len(tags))) if mesh is None
                                   else [mesh.stage], n)
                grads[k][n] = (_add_in_order(parts, t) if mesh is None
                               else parts[0])
        else:
            g = got.pop()
            # across ranks a leaf this rank never read stays None: the
            # ranks that read it send theirs (``_reduce_grads``)
            grads[k] = g if mesh is not None or g is not None else \
                torch.zeros_like(v)
    if tied is not None:
        grads["embed"] = _add_in_order([grads["embed"], got.pop()],
                                       None if mesh is not None
                                       else params["embed"])
    if mesh is not None:
        grads = _reduce_grads(grads, params, mesh)
    return loss.detach(), stats, grads


# ---------------------------------------------------------------------------
# One process per stage
# ---------------------------------------------------------------------------
def _carry_spec(cfg: ModelConfig, dyncfg: DynamicsConfig,
                shapes: PipelineShapes, dt, decode: bool = False):
    """{leaf: (shape, dtype)} of the stage-to-stage carry of one replica's
    microbatch — the reference's ``_init_carry``; receive buffers take
    these shapes."""
    b = shapes.mb_global
    s = 1 if decode else shapes.seq_total
    spec = {"x": ((b, s, cfg.d_model), dt)}
    if cfg.is_encdec and not decode:
        spec["enc"] = ((b, shapes.enc_seq, cfg.d_model), dt)
    if dyncfg.uses_early_exit and not decode:
        spec["exited"] = ((b, s), torch.float32)
    return spec


def _send_carry(comm, carry, spec, dst: int) -> None:
    if set(carry) != set(spec):
        raise ValueError(f"carry {sorted(carry)} != {sorted(spec)}")
    for k in sorted(spec):
        comm.send(carry[k].detach(), dst)


def _recv_carry(comm, spec, src: int, device, grad: bool = False):
    carry = {}
    for k in sorted(spec):
        shape, dtype = spec[k]
        buf = torch.empty(shape, dtype=dtype, device=device)
        carry[k] = comm.recv(buf, src)
        if grad and k != "exited":
            carry[k].requires_grad_(True)
    return carry


def _diff_leaves(carry):
    """The carry leaves a gradient flows through (``exited`` is a mark)."""
    return [k for k in sorted(carry) if k != "exited"]


# stats that count (summed over ``data``); the rest are means over a
# replica's lanes (averaged over ``data``)
COUNT_STATS = ("expert_load",)


def _gather_stats(stats, mesh):
    """This stage's ``{field: [L_max, ...]}`` -> ``{field: [S, L_max,
    ...]}`` on every rank, as the reference's over the whole microbatch:
    the per-expert token counts summed over ``data``, the fractions (each
    replica's over its equal share of the lanes) averaged."""
    keys = sorted(stats)
    flat = torch.cat([stats[k].reshape(-1).float() for k in keys])
    if mesh.data > 1:
        tot = mesh.comm.all_reduce(flat, mesh.data_group)
        count = torch.cat([torch.full((stats[k].numel(),), k in COUNT_STATS,
                                      device=flat.device) for k in keys])
        flat = torch.where(count, tot, tot / mesh.data)
    full = mesh.comm.all_gather(flat, mesh.model_group)     # [S, n]
    out, o = {}, 0
    for k in keys:
        n = stats[k].numel()
        out[k] = full[:, o:o + n].reshape(
            (mesh.model,) + tuple(stats[k].shape)).to(stats[k].dtype)
        o += n
    return out


def _replicated(tree, path=()):
    """(path, leaf) of the leaves replicated over ``model`` (everything but
    ``stages``), None leaves included, keys in sorted order."""
    for k in sorted(tree):
        if k == "stages" and not path:
            continue
        v = tree[k]
        if isinstance(v, dict):
            yield from _replicated(v, path + (k,))
        else:
            yield path + (k,), v


def _reduce_grads(grads, params, mesh):
    """Sum the replicated leaves' gradients over the model ring, then every
    gradient over ``data``.

    A replicated leaf's gradient comes from the stages that read it (the
    embedding's from stage 0 and, tied, the last; the head's and
    ``final_norm``'s from the last; a shared leaf's from its stages; None
    elsewhere).  The first of them sums the others' in stage order — as
    one process adds them — and hands the sum to every other rank of the
    ring: point-to-point transfers (``Comm.exchange``) in three rounds
    (the readers' gradients to the first; the sum cut into a piece for
    each other rank; each piece passed on among them).  A leaf no stage
    read is zeros everywhere."""
    comm = mesh.comm
    if comm.staged:
        # the sums' own seconds: the backward's queued work first
        torch.cuda.synchronize(comm.device)
    t0 = time.perf_counter()
    flat = list(_replicated(grads))
    like = dict(_replicated(params))
    like[("embed",)] = params["embed"]
    S, me = mesh.model, mesh.stage
    ring = [mesh.rank_of(st) for st in range(S)]
    have = torch.tensor([g is not None for _, g in flat], dtype=torch.uint8)
    seen = comm.all_gather(have, mesh.model_group).tolist()   # [S, n]
    readers = [[st for st in range(S) if seen[st][i]]
               for i in range(len(flat))]
    # round 1: each reader's gradient to the leaf's first reader
    sends, recvs, got = [], [], {}
    for i, (path, g) in enumerate(flat):
        rd = readers[i]
        if len(rd) < 2 or me not in rd:
            continue
        if me == rd[0]:
            for st in rd[1:]:
                got[i, st] = torch.empty_like(g)
                recvs.append((got[i, st], ring[st]))
        else:
            sends.append((g, ring[rd[0]]))
    comm.exchange(sends, recvs, tally=False)
    # rounds 2 and 3: the sum from the first reader to every other rank,
    # cut into one piece per receiver (round 2), which each receiver
    # passes on to the others (round 3): the first reader sends the
    # leaf's bytes once, not once per rank
    out = {}
    rounds = ([], []), ([], [])
    for i, (path, g) in enumerate(flat):
        rd = readers[i]
        if not rd:
            out[path] = torch.zeros_like(like[path])
            continue
        src = rd[0]
        if me == src:
            out[path] = _add_in_order([g] + [got.pop((i, st))
                                             for st in rd[1:]], None)
        else:
            out[path] = torch.empty_like(like[path])
        rcv = [st for st in range(S) if st != src]
        if not rcv:
            continue
        pieces = out[path].view(-1).tensor_split(len(rcv))
        for j, st in enumerate(rcv):
            if not pieces[j].numel():
                continue
            if me == src:
                rounds[0][0].append((pieces[j], ring[st]))
            elif me == st:
                rounds[0][1].append((pieces[j], ring[src]))
                rounds[1][0].extend((pieces[j], ring[o]) for o in rcv
                                    if o != st)
            elif me in rcv:
                rounds[1][1].append((pieces[j], ring[st]))
    for sends, recvs in rounds:
        comm.exchange(sends, recvs, tally=False)
    red = {"stages": grads["stages"]}
    for path, t in out.items():
        node = red
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    t1 = time.perf_counter()
    comm.stats["grad_ring_s"] += t1 - t0
    if mesh.data > 1:
        def over_data(t):
            if isinstance(t, dict):
                return {k: over_data(v) for k, v in t.items()}
            return comm.all_reduce(t, mesh.data_group)
        red = over_data(red)
        comm.stats["grad_data_s"] += time.perf_counter() - t1
    return red


def _check_mesh(dcfg: DistConfig, mesh) -> None:
    if dcfg.num_stages != mesh.model:
        raise ValueError(f"{dcfg.num_stages} stages on a model ring of "
                         f"{mesh.model} ranks")


def _broadcast_ids(mesh, *outs):
    """The last stage's outputs to every rank of the ring, then the
    replicas' lanes gathered over ``data``: ``[m, B_local]`` ->
    ``[m, B]``."""
    last = mesh.rank_of(mesh.model - 1)
    res = []
    for o in outs:
        o = mesh.comm.broadcast(o, last, mesh.model_group)
        if mesh.data > 1:
            g = mesh.comm.all_gather(o, mesh.data_group)     # [dp, m, b]
            o = g.permute(1, 0, 2).reshape(o.shape[0], -1)
        res.append(o)
    return res


def _ordered_sum(vals, m: int, S: int):
    """``vals`` [S, m] (a per-call scalar, every stage's gathered) summed
    in the one-process tick order (``_ticks``), from zero as one process
    sums them."""
    acc = torch.zeros((), dtype=vals.dtype, device=vals.device)
    for _, idx, mi in _ticks(m, S):
        acc = acc + vals[idx, mi]
    return acc


def _spec_for(spec, batch):
    """The carry spec of a batch: whisper served without frames carries no
    encoder stream."""
    return spec if "frames" in batch else {k: v for k, v in spec.items()
                                           if k != "enc"}


def _drop_sum(cfg, drop, mesh, m: int, device):
    """The MoE drop fractions of every stage call (``drop``: this rank's,
    per microbatch) summed as one process sums them: gathered over the
    ring, averaged over ``data`` (each replica's are over its equal share
    of the lanes), added in the tick order; the same value on every rank.
    Zero, with no collective, for an arch without experts."""
    if not cfg.num_experts:
        return torch.zeros((), device=device)
    rows = mesh.comm.all_gather(drop, mesh.model_group)      # [S, m]
    if mesh.data > 1:
        rows = mesh.comm.all_reduce(rows, mesh.data_group) / mesh.data
    return _ordered_sum(rows, m, mesh.model)


def _mesh_loss_fn(cfg, dcfg, dyncfg, shapes, mode, mesh, hash_proj,
                  stage_timer):
    from repro_torch.launch.sharding import replica_shapes
    from repro_torch.models.blocks import data_sum
    _check_mesh(dcfg, mesh)
    S, s = mesh.model, mesh.stage
    dt = M.param_dtype(dcfg)
    rshapes = replica_shapes(shapes, mesh)
    spec = _carry_spec(cfg, dyncfg, rshapes, dt)
    prev = mesh.rank_of(s - 1) if s > 0 else None
    nxt = mesh.rank_of(s + 1) if s < S - 1 else None
    comm = mesh.comm
    # MoE's load-balancing loss over the whole microbatch: its router
    # means and counts are summed over the data replicas
    over_data = (None if mesh.data == 1 or not cfg.num_experts else
                 (lambda t: comm.all_reduce(t, mesh.data_group)))

    def loss_fn(params, assignment, dyn, batch, backward: bool = False,
                sites=None):
        with data_sum(over_data, mesh.data):
            return run(params, assignment, dyn, batch, backward, sites)

    def run(params, assignment, dyn, batch, backward, sites):
        tokens = batch["tokens"]
        device = tokens.device
        m = shapes.num_micro
        tags = assignment["tags"].tolist()[s]
        depth_base = int(assignment["depth_base"][s])
        pos = torch.arange(shapes.seq_total, device=device)
        stage_p = _stage_slice(params["stages"], 0)
        dyn_s = _stage_slice(dyn, 0)
        acc = None
        aux_mi = torch.zeros(m, device=device)
        exited = []
        kept = []              # (micro, carry in, carry out, aux), tick order
        h_seq = {}
        spec_b = _spec_for(spec, batch)

        def stage_fn(carry, shared, stage_p):
            return M.stage_forward(cfg, dcfg, dyncfg, mode, stage_p,
                                   shared, tags, dyn_s, carry,
                                   None, pos, depth_base,
                                   hash_proj=hash_proj)

        with torch.set_grad_enabled(backward):
            for t in range(m + S - 1):
                mi = t - s
                if not 0 <= mi < m:
                    continue
                if s == 0:
                    carry = _ingest(params, cfg, dyncfg, tokens[mi], dt,
                                    _prefix(batch, mi))
                else:
                    carry = _recv_carry(comm, spec_b, prev, device, backward)
                shared = _site(params["shared"], sites, s)
                call_p, pairs = (_call_leaves(stage_p) if backward
                                 else (stage_p, []))
                if stage_timer is not None:
                    stage_timer.stamp(0, 0)
                if dcfg.remat == "full":
                    out, _, stats, aux = checkpoint(stage_fn, carry, shared,
                                                    call_p,
                                                    use_reentrant=False)
                else:
                    out, _, stats, aux = stage_fn(carry, shared, call_p)
                if stage_timer is not None:
                    stage_timer.stamp(0, 1)
                stats = {k: v.detach() for k, v in stats.items()}
                acc = stats if acc is None else {k: acc[k] + v
                                                 for k, v in stats.items()}
                if torch.is_tensor(aux):
                    aux_mi[mi] = aux.detach()
                if s == S - 1:
                    h_seq[mi] = out["x"][:, shapes.prefix:]
                    if "exited" in out:
                        exited.append(out["exited"].detach().mean())
                else:
                    _send_carry(comm, out, spec_b, nxt)
                if backward:
                    kept.append((mi, carry, out, aux, pairs))
            nll = cnt = torch.zeros((), device=device)
            h_leaf = {}
            if s == S - 1:
                head = M.head_weight(params)
                nll = cnt = 0.0
                for mi in range(m):
                    h = h_seq[mi]
                    if backward:
                        h = h_leaf[mi] = h.detach().requires_grad_(True)
                    n_, c_ = checkpoint(_micro_loss, params["final_norm"],
                                        head, h, batch["labels"][mi],
                                        batch["label_mask"][mi],
                                        cfg.norm_eps, use_reentrant=False)
                    nll, cnt = nll + n_, cnt + c_
        # nll, count and every stage call's aux loss ([S, m], this rank's
        # row filled) summed over the world in one collective
        part = torch.zeros(2 + S * m, device=device)
        part[0] = torch.as_tensor(nll, device=device).detach().float()
        part[1] = torch.as_tensor(cnt, device=device).detach().float()
        part[2 + s * m:2 + (s + 1) * m] = aux_mi
        tot = comm.all_reduce(part, mesh.world_group)
        loss = tot[0] / torch.clamp(tot[1], min=1.0)
        den = m * max(1, cfg.total_blocks())
        if cfg.num_experts:
            # the aux losses added in one process's tick order; each
            # replica's is the whole microbatch's (``data_sum``)
            aux_all = tot[2:].reshape(S, m) / mesh.data
            loss = loss + M.AUX_LOSS_COEF * _ordered_sum(aux_all, m, S) / den
        if backward:
            if s == S - 1:
                torch.autograd.backward(
                    nll / torch.clamp(tot[1], min=1.0))
            # d loss / d aux of one call, taken as one process takes it
            g_aux = torch.ones((), device=device) / den * M.AUX_LOSS_COEF
            for mi, cin, cout, aux, pairs in reversed(kept):
                if s == S - 1:
                    outs = [cout["x"][:, shapes.prefix:]]
                    grads = [h_leaf.pop(mi).grad]
                else:
                    keys = [k for k in _diff_leaves(cout)
                            if cout[k].requires_grad]
                    g = _recv_carry(comm, {k: spec_b[k]
                                           for k in _diff_leaves(cout)},
                                    nxt, device)
                    outs = [cout[k] for k in keys]
                    grads = [g[k] for k in keys]
                if torch.is_tensor(aux) and aux.requires_grad:
                    outs.append(aux)
                    grads.append(g_aux.to(aux.dtype))
                # a slot's gradient so far enters this call's leaf first
                # (a view made now runs first in the backward), so a leaf
                # read several times in a call adds each read to the running
                # sum as one process's single backward adds them
                for t, q in pairs:
                    if t.grad is not None:
                        outs.append(q.view_as(q))
                        grads.append(t.grad)
                torch.autograd.backward(outs, grads)
                for t, q in pairs:
                    if q.grad is not None:
                        t.grad = q.grad
                if s > 0:
                    for k in _diff_leaves(cin):
                        gk = cin[k].grad
                        comm.send(torch.zeros_like(cin[k]) if gk is None
                                  else gk, prev)
            kept.clear()
        stats = _gather_stats(acc, mesh)
        if exited:
            ex = torch.stack(exited).mean()
        else:
            ex = torch.zeros((), device=device)
        if dyncfg.uses_early_exit:
            (ex,) = _broadcast_ids(mesh, ex.reshape(1, 1).clone())
            stats["exited_frac"] = ex.mean()
        return loss, stats

    loss_fn.mesh = mesh
    return loss_fn


def _mesh_prefill_fn(cfg, dcfg, dyncfg, shapes, mesh, hash_proj,
                     stage_timer):
    from repro_torch.launch.sharding import replica_shapes, split_batch
    _check_mesh(dcfg, mesh)
    S, s = mesh.model, mesh.stage
    dt = M.param_dtype(dcfg)
    rshapes = replica_shapes(shapes, mesh)
    spec = _carry_spec(cfg, dyncfg, rshapes, dt)
    prev = mesh.rank_of(s - 1) if s > 0 else None
    nxt = mesh.rank_of(s + 1) if s < S - 1 else None
    comm = mesh.comm

    def prefill_fn(params, assignment, dyn, cache, batch):
        batch = split_batch(batch, mesh)
        tokens = batch["tokens"]
        device = tokens.device
        m = shapes.num_micro
        tags = assignment["tags"].tolist()[s]
        pos = torch.arange(shapes.seq_total, device=device)
        stage_p = _stage_slice(params["stages"], 0)
        dyn_s = _stage_slice(dyn, 0)
        ids_out = torch.zeros((m, rshapes.mb_global), dtype=torch.int32,
                              device=device)
        drop = torch.zeros(m, device=device)
        spec_b = _spec_for(spec, batch)
        for t in range(m + S - 1):
            mi = t - s
            if not 0 <= mi < m:
                continue
            if s == 0:
                carry = _ingest(params, cfg, dyncfg, tokens[mi], dt,
                                _prefix(batch, mi))
            else:
                carry = _recv_carry(comm, spec_b, prev, device)
            cache_mb = {k: v[0][:, mi] for k, v in cache.items()}
            if stage_timer is not None:
                stage_timer.stamp(0, 0)
            carry, _, st, _ = M.stage_forward(
                cfg, dcfg, dyncfg, "prefill", stage_p, params["shared"],
                tags, dyn_s, carry, cache_mb, pos, s * len(tags),
                hash_proj=hash_proj)
            if stage_timer is not None:
                stage_timer.stamp(0, 1)
            if cfg.num_experts:
                drop[mi] = st["moe_dropped"].sum()
            if s == S - 1:
                logits = M.lm_logits(params, cfg, carry["x"][:, -1])
                ids_out[mi] = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                _send_carry(comm, carry, spec_b, nxt)
        (ids,) = _broadcast_ids(mesh, ids_out)
        return ids, cache, _drop_sum(cfg, drop, mesh, m, device)

    prefill_fn.mesh = mesh
    return prefill_fn


def _mesh_decode_fn(cfg, dcfg, dyncfg, shapes, mesh, m_live, temperature,
                    hash_proj, stage_timer, paged=False):
    from repro_torch.launch.sharding import lanes, replica_shapes
    _check_mesh(dcfg, mesh)
    S, s = mesh.model, mesh.stage
    dt = M.param_dtype(dcfg)
    rshapes = replica_shapes(shapes, mesh)
    spec = _carry_spec(cfg, dyncfg, rshapes, dt, decode=True)
    prev = mesh.rank_of(s - 1) if s > 0 else None
    nxt = mesh.rank_of(s + 1) if s < S - 1 else None
    comm = mesh.comm

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
        sl = lanes(mesh, tokens.shape[1])
        tokens = tokens[:, sl]
        if per_lane:
            pos = pos[:, sl]
        if seeds is not None:
            seeds = seeds[:, sl]
        if page_table is not None:
            page_table = page_table[:, sl]
        device = tokens.device
        tags = assignment["tags"].tolist()[s]
        stage_p = _stage_slice(params["stages"], 0)
        dyn_s = _stage_slice(dyn, 0)
        B = rshapes.mb_global
        ids_out = torch.zeros((shapes.num_micro, B), dtype=torch.int32,
                              device=device)
        lp_out = torch.zeros((shapes.num_micro, B), dtype=torch.float32,
                             device=device)
        drop = torch.zeros(m_live, device=device)
        for t in range(m_live + S - 1):
            mi = t - s
            if not 0 <= mi < m_live:
                continue
            if s == 0:
                x = M.embed(params, cfg, tokens[mi][:, None],
                            pos_offset=pos.clamp(0, cfg.max_seq_len - 1))
                carry = {"x": x["x"].to(dt)}
            else:
                carry = _recv_carry(comm, spec, prev, device)
            if paged:
                # the rank's rows of the pool; the tick's page table and
                # write-ok flag ride as per-slot entries, as in one process
                L_m = len(tags)
                pt_mb = page_table[mi]
                cache_mb = {"kp": cache["kp"][0], "vp": cache["vp"][0],
                            "pt": pt_mb[None].expand(L_m, *pt_mb.shape),
                            "wok": [1] * L_m}
            else:
                cache_mb = {k: v[0][:, mi] for k, v in cache.items()}
            pos_mb = pos[mi] if per_lane else pos
            if stage_timer is not None:
                stage_timer.stamp(0, 0)
            carry, _, st, _ = M.stage_forward(
                cfg, dcfg, dyncfg, "decode", stage_p, params["shared"],
                tags, dyn_s, carry, cache_mb, pos_mb, s * len(tags),
                hash_proj=hash_proj)
            if stage_timer is not None:
                stage_timer.stamp(0, 1)
            if cfg.num_experts:
                drop[mi] = st["moe_dropped"].sum()
            if s == S - 1:
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
                _send_carry(comm, carry, spec, nxt)
        ids, lps = _broadcast_ids(mesh, ids_out, lp_out)
        return ids, lps, cache, _drop_sum(cfg, drop, mesh, m_live,
                                               device)

    decode_fn.mesh = mesh
    return decode_fn
