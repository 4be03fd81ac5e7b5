"""Slot-block layer — the dense-decoder and MoE slice of
``repro.models.blocks``.

A pipeline stage owns ``L_max`` slots; each slot holds the parameter fields
of the arch's block types plus a type tag, so the layer→stage assignment can
change at runtime.  The port has the DENSE block (attention + SwiGLU), the
MOE block (attention + top-k routed experts, ``moe_ffn``) and the PAD slot;
other block families raise ``NotImplementedError``.

Public interface (same names as the reference)
  slot_param_spec(cfg)            -> {field: TensorSpec}   (per slot)
  slot_cache_spec(cfg, mb, clen)  -> {field: TensorSpec}   (per slot)
  paged_slot_cache_spec(cfg, pool_pages, page_size)
  init_slot(gen, cfg, dtype, ...) -> concrete params
  apply_block(...)                -> (carry, new_cache, stats, aux)

The slot's type tag is a host int: the port dispatches on it in Python, so
a PAD slot costs nothing and no device value is read back.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (BLOCK_DENSE, BLOCK_MOE, BLOCK_PAD,
                                      BLOCK_TYPE_NAMES, ModelConfig)
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models.layers import (apply_rope, decode_attention,
                                       flash_attention, matmul, rms_norm,
                                       swiglu)

PRUNE_BLOCK = 128      # block-structured pruning granularity
HASH_PROJ_SEED = 17    # the reference draws its projection from PRNGKey(17)
MOE_CAPACITY_FACTOR = 1.25

# what the port's slices serve so far; anything else raises
PORTED_BLOCK_TYPES = (BLOCK_DENSE, BLOCK_MOE)


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# Dimension helpers
# ---------------------------------------------------------------------------
def _dims(cfg: ModelConfig) -> Dict[str, int]:
    return dict(d=cfg.d_model, hd=cfg.resolved_head_dim, nq=cfg.num_heads,
                nkv=cfg.num_kv_heads, ff=cfg.d_ff, E=cfg.num_experts)


def prunable_dim(cfg: ModelConfig) -> int:
    """Feature dimension subject to block-structured pruning."""
    if cfg.d_ff > 0:
        return cfg.d_ff
    return 2 * 2 * cfg.d_model       # mLSTM up-projection (2*d_in)


def n_prune_blocks(cfg: ModelConfig) -> int:
    return max(1, prunable_dim(cfg) // PRUNE_BLOCK)


def block_type_set(cfg: ModelConfig) -> Tuple[int, ...]:
    return tuple(sorted(set(cfg.block_pattern())))


def check_ported(cfg: ModelConfig) -> None:
    """Raise for an architecture whose block families are not ported yet."""
    missing = [BLOCK_TYPE_NAMES[t] for t in block_type_set(cfg)
               if t not in PORTED_BLOCK_TYPES]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: block types {missing} are not in repro_torch yet "
            f"(ROADMAP Queue 1 [block-families])")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def slot_param_spec(cfg: ModelConfig, dtype=torch.bfloat16
                    ) -> Dict[str, TensorSpec]:
    check_ported(cfg)
    m = _dims(cfg)
    types = block_type_set(cfg)
    d, hd, nq, nkv, ff = m["d"], m["hd"], m["nq"], m["nkv"], m["ff"]
    spec = dict(
        attn_norm=TensorSpec((d,), dtype), wq=TensorSpec((d, nq * hd), dtype),
        wk=TensorSpec((d, nkv * hd), dtype),
        wv=TensorSpec((d, nkv * hd), dtype),
        wo=TensorSpec((nq * hd, d), dtype), ffn_norm=TensorSpec((d,), dtype))
    if BLOCK_DENSE in types:
        spec.update(wi=TensorSpec((d, ff), dtype),
                    wg=TensorSpec((d, ff), dtype),
                    wof=TensorSpec((ff, d), dtype))
    if BLOCK_MOE in types:
        E = m["E"]
        # the router stays fp32 whatever the param dtype, as in the reference
        spec.update(router=TensorSpec((d, E), torch.float32),
                    ewi=TensorSpec((E, d, ff), dtype),
                    ewg=TensorSpec((E, d, ff), dtype),
                    ewo=TensorSpec((E, ff, d), dtype))
    return spec


def slot_cache_spec(cfg: ModelConfig, mb: int, cache_len: int,
                    dtype=torch.bfloat16) -> Dict[str, TensorSpec]:
    """Per-slot decode cache: one K/V line per lane.  bf16 by default, as in
    the reference, whatever the param dtype."""
    check_ported(cfg)
    m = _dims(cfg)
    cap = cache_len
    if cfg.sliding_window:
        cap = min(cache_len, cfg.sliding_window)
    shape = (mb, cap, m["nkv"], m["hd"])
    return dict(k=TensorSpec(shape, dtype), v=TensorSpec(shape, dtype))


def paged_slot_cache_spec(cfg: ModelConfig, pool_pages: int, page_size: int,
                          dtype=torch.bfloat16) -> Dict[str, TensorSpec]:
    """Per-slot block-paged decode cache ``[pool_pages + 1, page_size, n_kv,
    head_dim]``; the final block is the trash block absorbing gated writes."""
    check_ported(cfg)
    if cfg.sliding_window:
        raise ValueError("paged KV does not support sliding-window caches")
    m = _dims(cfg)
    shape = (pool_pages + 1, page_size, m["nkv"], m["hd"])
    return dict(kp=TensorSpec(shape, dtype), vp=TensorSpec(shape, dtype))


def stats_spec(cfg: ModelConfig) -> Dict[str, TensorSpec]:
    E = max(1, cfg.num_experts)
    return dict(expert_load=TensorSpec((E,), torch.float32),
                moe_dropped=TensorSpec((), torch.float32),
                ff_active=TensorSpec((), torch.float32),
                attn_density=TensorSpec((), torch.float32))


def init_slot(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
              *, lead: Sequence[int] = (), device=None
              ) -> Dict[str, torch.Tensor]:
    """Slot params with ``lead`` leading dims (``(S, L_max)`` for a stacked
    stage tree).  Same distributions as the reference (norms ones, matrices
    N(0, fan_in^-1/2)); the numbers come from ``gen``, not jax's PRNG."""
    out = {}
    for name, sds in sorted(slot_param_spec(cfg, dtype).items()):
        shape = tuple(lead) + sds.shape
        if name.endswith("norm"):
            out[name] = torch.ones(shape, dtype=sds.dtype, device=device)
        else:
            fan_in = sds.shape[-2]
            out[name] = torch.randn(shape, generator=gen, device=device
                                    ).mul_(fan_in ** -0.5).to(sds.dtype)
    return out


# ---------------------------------------------------------------------------
# Hash-based dynamic block sparsity
# ---------------------------------------------------------------------------
def hash_bits(nbuckets: int) -> int:
    return max(1, int(nbuckets - 1).bit_length())


def default_hash_projection(d: int, nbuckets: int, device=None):
    """The port's fixed projection [d, nbits], drawn from a seeded torch
    generator on the host (so every device gets the same numbers).  Parity
    tests feed the reference's own projection instead."""
    gen = torch.Generator(device="cpu").manual_seed(HASH_PROJ_SEED)
    return torch.randn((d, hash_bits(nbuckets)), generator=gen).to(device)


def hash_block_mask(x, proj, *, nbuckets: int, block: int,
                    causal: bool = True):
    """Content-based block mask from sign-random-projection hashing.

    x: [b, s, d]; proj: [d, nbits] float32.  Tokens are bucketed by the hash
    of their block-mean hidden state; attention is restricted to (q-block,
    kv-block) pairs whose buckets match, plus the local diagonal band.
    Returns mask [b, 1, nqb, nkb] float and the achieved density."""
    b, s, d = x.shape
    nb = max(1, s // block)
    xb = x[:, :nb * block].reshape(b, nb, block, d).mean(dim=2).float()
    nbits = hash_bits(nbuckets)
    bits = (xb @ proj.float()) > 0                              # [b, nb, nbits]
    weights = 2 ** torch.arange(nbits, device=x.device)
    bucket = (bits.long() * weights).sum(-1) % nbuckets
    same = bucket[:, :, None] == bucket[:, None, :]             # [b, nb, nb]
    ar = torch.arange(nb, device=x.device)
    band = (ar[:, None] - ar[None, :]).abs() <= 1
    mask = same | band[None]
    if causal:
        tril = ar[:, None] >= ar[None, :]
        mask = mask & tril
        denom = float(tril.sum())
    else:
        denom = float(nb * nb)
    density = mask.float().sum(dim=(1, 2)).mean() / denom
    return mask[:, None].float(), density


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------
def _attn_fwd(x, wq, wk, wv, wo, *, cfg, mode, cache, pos, rope: bool = True,
              causal: bool = True, block_mask=None, dyncfg=None,
              kernel_impl: str = "scan", hash_proj=None):
    """GQA attention with RoPE and an optional cache.  x: [mb, s, d]; pos:
    [s] absolute positions (train/prefill), or a scalar / [mb] tensor
    (decode).  Returns (out, cache, density).

    The port writes caches IN PLACE (the reference returns updated copies):
    prefill writes the lane lines of ``cache``'s k/v, decode writes one
    position per lane, into the dense lines or through the page table into
    the pool.  The returned cache is the same dict."""
    m = _dims(cfg)
    nq, nkv, hd = m["nq"], m["nkv"], m["hd"]
    b, s, _ = x.shape
    density = torch.ones((), device=x.device)
    kv_block = 512
    if (dyncfg is not None and dyncfg.uses_sparse_attention
            and mode != "decode" and block_mask is None
            and s >= 2 * dyncfg.sparse_block):
        if hash_proj is None:
            hash_proj = default_hash_projection(x.shape[-1],
                                                dyncfg.sparse_nbuckets,
                                                x.device)
        block_mask, density = hash_block_mask(
            x, hash_proj, nbuckets=dyncfg.sparse_nbuckets,
            block=dyncfg.sparse_block, causal=causal)
        kv_block = dyncfg.sparse_block
    q = (x @ wq).reshape(b, s, nq, hd)
    k = (x @ wk).reshape(b, s, nkv, hd)
    v = (x @ wv).reshape(b, s, nkv, hd)

    if mode == "decode" and cache is not None and "kp" in cache:
        # block-paged cache: one physical pool per slot, per-lane page
        # tables.  Write the new K/V through the table (gated writes land in
        # the trash block), then attend over the pages.
        kp, vp = cache["kp"], cache["vp"]
        pt = cache["pt"]                      # [b, J] int32, -1 = unmapped
        page = kp.shape[1]
        trash = kp.shape[0] - 1
        cap = pt.shape[1] * page
        pvec = pos.reshape(-1).expand(b)
        if rope:
            q = apply_rope(q, pvec[:, None], cfg.rope_theta)
            k = apply_rope(k, pvec[:, None], cfg.rope_theta)
        pw = pvec.clamp(max=cap - 1)
        lanes = torch.arange(b, device=x.device)
        blk = pt[lanes, pw // page].long()
        ok = (blk >= 0) if cache["wok"] else torch.zeros_like(blk, dtype=bool)
        blk_eff = torch.where(ok, blk, torch.full_like(blk, trash))
        off = pw % page
        kp[blk_eff, off] = k[:, 0].to(kp.dtype)
        vp[blk_eff, off] = v[:, 0].to(vp.dtype)
        clen = (pvec + 1).clamp(max=cap)
        if kernel_impl == "pallas":
            out = pa_ops.paged_attention(q, kp, vp, pt, clen)
        else:
            out = paged_attention_ref(q, kp, vp, pt, clen)
    elif mode == "decode":
        kc, vc = cache["k"], cache["v"]
        cap = kc.shape[1]
        if pos.dim() == 0:
            # every lane at the same absolute position
            pvec = pos.expand(b)
        else:
            # continuous batching: each request writes its cache line and
            # masks attention at its OWN position
            pvec = pos.reshape(b)
        if rope:
            q = apply_rope(q, pvec[:, None], cfg.rope_theta)
            k = apply_rope(k, pvec[:, None], cfg.rope_theta)
        widx = (pvec % cap if cfg.sliding_window else pvec.clamp(max=cap - 1))
        lanes = torch.arange(b, device=x.device)
        kc[lanes, widx] = k[:, 0].to(kc.dtype)
        vc[lanes, widx] = v[:, 0].to(vc.dtype)
        clen = (pvec + 1).clamp(max=cap)
        out = decode_attention(q, kc, vc, clen)
    else:
        if rope:
            pq = pos[None, :].expand(b, s)
            q = apply_rope(q, pq, cfg.rope_theta)
            k = apply_rope(k, pq, cfg.rope_theta)
        out = flash_attention(q, k, v, causal=causal,
                              sliding_window=cfg.sliding_window,
                              block_mask=block_mask, kv_block=kv_block,
                              impl=kernel_impl)
        if mode == "prefill" and cache is not None:
            kc, vc = cache["k"], cache["v"]
            cap = kc.shape[1]
            if cap >= s:
                kc[:, :s] = k.to(kc.dtype)
                vc[:, :s] = v.to(vc.dtype)
            else:
                # ring buffer: keep the last `cap` positions, position q at
                # slot q % cap, where decode writes it
                kc.copy_(torch.roll(k[:, -cap:], s % cap, dims=1))
                vc.copy_(torch.roll(v[:, -cap:], s % cap, dims=1))
    out = matmul(out.reshape(b, out.shape[1], nq * hd), wo)
    return out, cache, density


# ---------------------------------------------------------------------------
# MoE FFN (GShard-style capacity dispatch, cumsum position-in-expert)
# ---------------------------------------------------------------------------
def moe_capacity(cfg: ModelConfig, s: int) -> int:
    """Rows per (batch row, expert) group for a sequence of ``s`` tokens."""
    E, K = cfg.num_experts, cfg.experts_per_token
    cf = cfg.moe_capacity_factor or MOE_CAPACITY_FACTOR
    cap = int(cf * s * K / E + 0.999)
    return max(4, min(s, (cap + 3) // 4 * 4))


def moe_ffn(p, x, cfg: ModelConfig, *, kernel_impl: str = "scan",
            expert_map=None):
    """x: [mb, s, d] -> (y, expert_load [E], aux_loss, dropped_frac), as
    ``repro.models.blocks.moe_ffn``.

    Routing (top-k, k-major cumsum position-in-expert, capacity drops) is
    the same for every impl; only the expert compute differs:

      "reference"/"scan": the dense capacity einsum over the zero-padded
        [b, E, cap, d] buffer (every expert pays full capacity).
      "pallas": the grouped ragged matmul (K4 forward, K4 + K5 backward)
        over the groups g = b * E + p; each group costs row tiles in
        proportion to its routed load.  ``expert_map`` ([E], logical
        expert -> physical group; None = identity) permutes only the
        physical group order, folded into the kernels' weight index: every
        token's math is row-wise, so y is bit-identical under any placement.

    Dispatch copies each kept (token, expert) pair into its slot (one writer
    per live slot; dropped pairs all land in a trash slot that is cut off).
    The combine is a reshape of the k-major pairs to [K, s, d] and a sum
    over k in a fixed order — no atomics, so its bits do not change from
    run to run (the reference scatter-adds; with two terms per token the
    sums are equal)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    b, s, d = x.shape
    cap = moe_capacity(cfg, s)

    logits = matmul(x, p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                       # [b,s,E]
    w, sel = torch.topk(probs, K, dim=-1)                       # [b,s,K]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    flat_e = sel.transpose(1, 2).reshape(b, K * s)              # k-major
    flat_w = w.transpose(1, 2).reshape(b, K * s)
    oh = F.one_hot(flat_e, E)                                   # [b,Ks,E]
    pos = ((oh.cumsum(1) - oh) * oh).sum(-1)                    # exclusive
    keep = pos < cap
    x_rep = x.repeat(1, K, 1)          # pair k * s + t carries token t

    def dispatch(group):
        slot = torch.where(keep, group * cap + pos,
                           torch.full_like(pos, E * cap))
        buf = x.new_zeros((b, E * cap + 1, d)).scatter(
            1, slot[..., None].expand(b, K * s, d), x_rep)
        return slot, buf[:, :E * cap]

    ewg, ewi, ewo = p["ewg"], p["ewi"], p["ewo"]
    if kernel_impl == "pallas":
        phys = flat_e if expert_map is None else expert_map.long()[flat_e]
        slot, buf = dispatch(phys)
        counts = (F.one_hot(phys, E) * keep[..., None]).sum(1).reshape(b * E)
        xg = buf.reshape(b * E, cap, d)                         # batch-major
        gmm = lambda a, wt: grouped_matmul(a, wt, counts,
                                           expert_map=expert_map)
        h = gmm(xg, ewg)
        h = F.silu(h) * gmm(xg, ewi)
        out = gmm(h.to(xg.dtype), ewo)
    else:
        slot, buf = dispatch(flat_e)
        buf = buf.reshape(b, E, cap, d)
        h = torch.einsum("becd,edf->becf", buf, ewg)
        h = F.silu(h) * torch.einsum("becd,edf->becf", buf, ewi)
        out = torch.einsum("becf,efd->becd", h, ewo)
    out = out.reshape(b, E * cap, d)
    idx = torch.clamp(slot, max=E * cap - 1)
    vals = out.gather(1, idx[..., None].expand(b, K * s, d))
    vals = vals * (flat_w * keep)[..., None].to(vals.dtype)
    y = vals.reshape(b, K, s, d).sum(1)
    load = F.one_hot(sel, E).sum(dim=(0, 1, 2)).float()         # [E]
    # capacity-overflow drops: routed (token, expert) pairs past each
    # expert's cap — the same keep mask on every impl
    dropped = 1.0 - keep.float().mean()
    # auxiliary load-balancing loss (Mixtral-style), returned via stats
    me = probs.reshape(-1, E).mean(0)
    ce = load / torch.clamp(load.sum(), min=1.0)
    aux_loss = E * (me * ce).sum()
    return y, load, aux_loss, dropped


# ---------------------------------------------------------------------------
# Per-type block forward
# ---------------------------------------------------------------------------
def _dense_block(p, x, *, cfg, mode, cache, pos, dyn, dyncfg,
                 kernel_impl="scan", hash_proj=None):
    h, cache, density = _attn_fwd(
        rms_norm(x, p["attn_norm"], cfg.norm_eps),
        p["wq"], p["wk"], p["wv"], p["wo"], cfg=cfg, mode=mode,
        cache=cache, pos=pos, dyncfg=dyncfg, kernel_impl=kernel_impl,
        hash_proj=hash_proj)
    x = x + h
    hn = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    # block-level mask: swiglu expands it for the dense impls and feeds the
    # pallas impl's tile gating directly
    ff_mask = dyn["ff_mask"] if cfg.d_ff else None
    x = x + swiglu(hn, p["wi"], p["wg"], p["wof"], ff_mask,
                   impl=kernel_impl)
    stats = {"ff_active": dyn["ff_mask"].mean(), "attn_density": density}
    return x, cache, stats, 0.0


def _moe_block(p, x, *, cfg, mode, cache, pos, dyn, dyncfg,
               kernel_impl="scan", hash_proj=None):
    h, cache, density = _attn_fwd(
        rms_norm(x, p["attn_norm"], cfg.norm_eps),
        p["wq"], p["wk"], p["wv"], p["wo"], cfg=cfg, mode=mode,
        cache=cache, pos=pos, dyncfg=dyncfg, kernel_impl=kernel_impl,
        hash_proj=hash_proj)
    x = x + h
    hn = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    y, load, aux_loss, dropped = moe_ffn(
        p, hn, cfg, kernel_impl=kernel_impl,
        expert_map=dyn.get("expert_map"))
    x = x + y
    stats = {"expert_load": load, "moe_dropped": dropped,
             "ff_active": torch.ones((), device=x.device),
             "attn_density": density}
    return x, cache, stats, aux_loss


def apply_block(cfg: ModelConfig, dyncfg, mode: str, p, shared, carry,
                tag: int, dyn, cache, pos, *, kernel_impl: str = "scan",
                hash_proj=None):
    """Apply one slot.  ``tag`` is the slot's BLOCK_* type id (a host int);
    ``carry`` is the pipeline activation dict {"x": [mb, s, d]}.

    Returns (carry', new_cache, stats, aux_loss); ``stats`` holds the
    fields the block sets (the rest of ``stats_spec`` are zeros).  PAD slots
    are the identity."""
    if tag == BLOCK_PAD:
        return carry, cache, {}, 0.0
    block = {BLOCK_DENSE: _dense_block, BLOCK_MOE: _moe_block}.get(tag)
    if block is None:
        raise NotImplementedError(
            f"block type {BLOCK_TYPE_NAMES.get(tag, tag)} is not in "
            f"repro_torch yet (ROADMAP Queue 1 [block-families])")
    x = carry["x"]
    y, c, st, aux = block(p, x, cfg=cfg, mode=mode, cache=cache, pos=pos,
                          dyn=dyn, dyncfg=dyncfg, kernel_impl=kernel_impl,
                          hash_proj=hash_proj)
    return {**carry, "x": y.to(x.dtype)}, c, st, aux
