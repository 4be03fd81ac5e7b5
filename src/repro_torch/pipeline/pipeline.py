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
division, as the reference's ``psum(nll) / psum(cnt)``.
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
    if mesh is None:
        loss, stats = loss_fn(view, assignment, dyn, batch)
        got = list(torch.autograd.grad(loss, flat, allow_unused=True))
    else:
        loss, stats = loss_fn(view, assignment, dyn, batch, backward=True)
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
            grads[k] = {n: take(t) for n, t in v.items()}
        else:
            grads[k] = take(v)
    if tied is not None:
        grads["embed"] = grads["embed"] + take(tied)
    if mesh is not None:
        grads = _reduce_grads(grads, mesh)
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


def _gather_stats(stats, mesh):
    """This stage's ``{field: [L_max, ...]}`` -> ``{field: [S, L_max,
    ...]}`` on every rank, averaged over ``data`` (each replica's are its
    lanes' sums, as the reference's over the whole microbatch)."""
    keys = sorted(stats)
    flat = torch.cat([stats[k].reshape(-1).float() for k in keys])
    if mesh.data > 1:
        flat = mesh.comm.all_reduce(flat, mesh.data_group) / mesh.data
    full = mesh.comm.all_gather(flat, mesh.model_group)     # [S, n]
    out, o = {}, 0
    for k in keys:
        n = stats[k].numel()
        out[k] = full[:, o:o + n].reshape(
            (mesh.model,) + tuple(stats[k].shape)).to(stats[k].dtype)
        o += n
    return out


def _reduce_grads(grads, mesh):
    """Sum the replicated leaves' gradients over the model ring, then every
    gradient over ``data``."""
    comm = mesh.comm
    out = {}
    for k, v in grads.items():
        if k == "stages":
            out[k] = v
        elif k == "shared":
            out[k] = {n: comm.all_reduce(g, mesh.model_group)
                      for n, g in v.items()}
        else:
            out[k] = comm.all_reduce(v, mesh.model_group)
    if mesh.data > 1:
        def over_data(t):
            if isinstance(t, dict):
                return {k: over_data(v) for k, v in t.items()}
            return comm.all_reduce(t, mesh.data_group)
        out = over_data(out)
    return out


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


def _mesh_loss_fn(cfg, dcfg, dyncfg, shapes, mode, mesh, hash_proj,
                  stage_timer):
    from repro_torch.launch.sharding import replica_shapes
    _check_mesh(dcfg, mesh)
    S, s = mesh.model, mesh.stage
    dt = M.param_dtype(dcfg)
    rshapes = replica_shapes(shapes, mesh)
    spec = _carry_spec(cfg, dyncfg, rshapes, dt)
    prev = mesh.rank_of(s - 1) if s > 0 else None
    nxt = mesh.rank_of(s + 1) if s < S - 1 else None
    comm = mesh.comm

    def loss_fn(params, assignment, dyn, batch, backward: bool = False):
        tokens = batch["tokens"]
        device = tokens.device
        m = shapes.num_micro
        tags = assignment["tags"].tolist()[s]
        depth_base = int(assignment["depth_base"][s])
        pos = torch.arange(shapes.seq_total, device=device)
        stage_p = _stage_slice(params["stages"], 0)
        dyn_s = _stage_slice(dyn, 0)
        acc = None
        aux_acc = 0.0
        exited = []
        kept = []              # (micro, carry in, carry out), tick order
        h_seq = {}

        def stage_fn(carry):
            return M.stage_forward(cfg, dcfg, dyncfg, mode, stage_p,
                                   params["shared"], tags, dyn_s, carry,
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
                    carry = _recv_carry(comm, spec, prev, device, backward)
                if stage_timer is not None:
                    stage_timer.stamp(0, 0)
                if dcfg.remat == "full":
                    out, _, stats, aux = checkpoint(stage_fn, carry,
                                                    use_reentrant=False)
                else:
                    out, _, stats, aux = stage_fn(carry)
                if stage_timer is not None:
                    stage_timer.stamp(0, 1)
                stats = {k: v.detach() for k, v in stats.items()}
                acc = stats if acc is None else {k: acc[k] + v
                                                 for k, v in stats.items()}
                aux_acc = aux_acc + aux
                if s == S - 1:
                    h_seq[mi] = out["x"][:, shapes.prefix:]
                    if "exited" in out:
                        exited.append(out["exited"].detach().mean())
                else:
                    _send_carry(comm, out, spec, nxt)
                if backward:
                    kept.append((mi, carry, out))
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
        aux_t = torch.as_tensor(aux_acc, dtype=torch.float32, device=device)
        tot = comm.all_reduce(torch.stack([
            torch.as_tensor(nll, device=device).detach().float(),
            torch.as_tensor(cnt, device=device).detach().float(),
            aux_t.detach()]), mesh.world_group)
        aux_tot = tot[2] / mesh.data
        loss = tot[0] / torch.clamp(tot[1], min=1.0)
        loss = loss + M.AUX_LOSS_COEF * aux_tot / (m * max(
            1, cfg.total_blocks()))
        if backward:
            if s == S - 1:
                obj = nll / torch.clamp(tot[1], min=1.0)
                if torch.is_tensor(aux_acc) and aux_acc.requires_grad:
                    obj = obj + M.AUX_LOSS_COEF * aux_acc / (
                        mesh.data * m * max(1, cfg.total_blocks()))
                torch.autograd.backward(obj)
            for mi, cin, cout in reversed(kept):
                if s == S - 1:
                    torch.autograd.backward(
                        cout["x"][:, shapes.prefix:], h_leaf.pop(mi).grad)
                else:
                    keys = _diff_leaves(cout)
                    g = _recv_carry(comm, {k: spec[k] for k in keys}, nxt,
                                    device)
                    torch.autograd.backward([cout[k] for k in keys],
                                            [g[k] for k in keys])
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
        for t in range(m + S - 1):
            mi = t - s
            if not 0 <= mi < m:
                continue
            if s == 0:
                carry = _ingest(params, cfg, dyncfg, tokens[mi], dt,
                                _prefix(batch, mi))
            else:
                carry = _recv_carry(comm, spec, prev, device)
            cache_mb = {k: v[0][:, mi] for k, v in cache.items()}
            if stage_timer is not None:
                stage_timer.stamp(0, 0)
            carry, _, _, _ = M.stage_forward(
                cfg, dcfg, dyncfg, "prefill", stage_p, params["shared"],
                tags, dyn_s, carry, cache_mb, pos, s * len(tags),
                hash_proj=hash_proj)
            if stage_timer is not None:
                stage_timer.stamp(0, 1)
            if s == S - 1:
                logits = M.lm_logits(params, cfg, carry["x"][:, -1])
                ids_out[mi] = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                _send_carry(comm, carry, spec, nxt)
        (ids,) = _broadcast_ids(mesh, ids_out)
        return ids, cache, torch.zeros((), device=device)

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
            carry, _, _, _ = M.stage_forward(
                cfg, dcfg, dyncfg, "decode", stage_p, params["shared"],
                tags, dyn_s, carry, cache_mb, pos_mb, s * len(tags),
                hash_proj=hash_proj)
            if stage_timer is not None:
                stage_timer.stamp(0, 1)
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
        return ids, lps, cache, torch.zeros((), device=device)

    decode_fn.mesh = mesh
    return decode_fn
