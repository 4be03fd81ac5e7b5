"""Slot-block layer — the port of ``repro.models.blocks``.

Every architecture is a sequence of *blocks* drawn from a small type set
(``configs.base.BLOCK_*``).  A pipeline stage owns ``L_max`` slots; each
slot holds the **union** of the arch's per-type parameter fields plus a type
tag, so the layer→stage assignment can change at runtime.  The port has
every block family of the reference: DENSE (attention + SwiGLU), MOE
(attention + top-k routed experts, ``moe_ffn``), MAMBA and HYBRID_ATTN
(Mamba2 SSD, the latter followed by the model's shared attention block),
MLSTM and SLSTM (xLSTM), ENC and DEC (the whisper encoder and decoder,
LayerNorm + biased attention + GELU MLP, the decoder with cross attention
over the encoder stream), and the PAD slot.

Public interface (same names as the reference)
  slot_param_spec(cfg)            -> {field: TensorSpec}   (per slot)
  shared_param_spec(cfg)          -> {field: TensorSpec}   (per model)
  slot_cache_spec(cfg, mb, clen)  -> {field: TensorSpec}   (per slot)
  paged_slot_cache_spec(cfg, pool_pages, page_size)
  init_slot / init_shared         -> concrete params
  apply_block(...)                -> (carry, new_cache, stats, aux)

The slot's type tag is a host int: the port dispatches on it in Python, so
a PAD slot costs nothing and no device value is read back.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (BLOCK_DEC, BLOCK_DENSE, BLOCK_ENC,
                                      BLOCK_HYBRID_ATTN, BLOCK_MAMBA,
                                      BLOCK_MLSTM, BLOCK_MOE, BLOCK_PAD,
                                      BLOCK_SLSTM, BLOCK_TYPE_NAMES,
                                      ModelConfig)
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (apply_rope, decode_attention,
                                       expand_ff_mask, flash_attention,
                                       gelu_mlp, layer_norm, matmul,
                                       rms_norm, swiglu)

PRUNE_BLOCK = 128      # block-structured pruning granularity
MAMBA_HEAD = 64
HASH_PROJ_SEED = 17    # the reference draws its projection from PRNGKey(17)
MOE_CAPACITY_FACTOR = 1.25

# every block family of the reference
PORTED_BLOCK_TYPES = (BLOCK_DENSE, BLOCK_MOE, BLOCK_MAMBA, BLOCK_HYBRID_ATTN,
                      BLOCK_MLSTM, BLOCK_SLSTM, BLOCK_ENC, BLOCK_DEC)


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# Dimension helpers
# ---------------------------------------------------------------------------
def _dims(cfg: ModelConfig) -> Dict[str, int]:
    d = cfg.d_model
    d_in = 2 * d
    return dict(
        d=d, hd=cfg.resolved_head_dim, nq=cfg.num_heads,
        nkv=cfg.num_kv_heads, ff=cfg.d_ff, d_in=d_in,
        nh_m=max(1, d_in // MAMBA_HEAD), conv_dim=d_in + 2 * cfg.ssm_state,
        nh_x=cfg.num_heads, dh_x=d_in // max(1, cfg.num_heads),
        st=cfg.ssm_state, E=cfg.num_experts)


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
    """Raise for an architecture with a block type the port does not
    know."""
    unknown = [t for t in block_type_set(cfg) if t not in PORTED_BLOCK_TYPES]
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block types {unknown}")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def _attn_fields(prefix: str, d: int, nq: int, nkv: int, hd: int, dtype,
                 biased: bool) -> Dict[str, TensorSpec]:
    """q/k/v/o projections named ``{prefix}wq`` ...; with ``biased`` the q,
    v and o biases (whisper's attention has none on k)."""
    out = {f"{prefix}wq": TensorSpec((d, nq * hd), dtype),
           f"{prefix}wk": TensorSpec((d, nkv * hd), dtype),
           f"{prefix}wv": TensorSpec((d, nkv * hd), dtype),
           f"{prefix}wo": TensorSpec((nq * hd, d), dtype)}
    if biased:
        out.update({f"{prefix}bq": TensorSpec((nq * hd,), dtype),
                    f"{prefix}bv": TensorSpec((nkv * hd,), dtype),
                    f"{prefix}bo": TensorSpec((d,), dtype)})
    return out


def slot_param_spec(cfg: ModelConfig, dtype=torch.bfloat16
                    ) -> Dict[str, TensorSpec]:
    check_ported(cfg)
    m = _dims(cfg)
    types = block_type_set(cfg)
    d, hd, nq, nkv, ff = m["d"], m["hd"], m["nq"], m["nkv"], m["ff"]
    f32 = torch.float32
    spec: Dict[str, TensorSpec] = {}
    if BLOCK_DENSE in types or BLOCK_MOE in types:
        spec.update(_attn_fields("", d, nq, nkv, hd, dtype, False))
        spec.update(attn_norm=TensorSpec((d,), dtype),
                    ffn_norm=TensorSpec((d,), dtype))
    if BLOCK_DENSE in types:
        spec.update(wi=TensorSpec((d, ff), dtype),
                    wg=TensorSpec((d, ff), dtype),
                    wof=TensorSpec((ff, d), dtype))
    if BLOCK_MOE in types:
        E = m["E"]
        # the router stays fp32 whatever the param dtype, as in the reference
        spec.update(router=TensorSpec((d, E), f32),
                    ewi=TensorSpec((E, d, ff), dtype),
                    ewg=TensorSpec((E, d, ff), dtype),
                    ewo=TensorSpec((E, ff, d), dtype))
    if BLOCK_MAMBA in types or BLOCK_HYBRID_ATTN in types:
        d_in, nh, cdim, st = m["d_in"], m["nh_m"], m["conv_dim"], m["st"]
        spec.update(
            m_norm=TensorSpec((d,), dtype),
            m_in=TensorSpec((d, 2 * d_in + 2 * st + nh), dtype),
            m_convw=TensorSpec((cfg.d_conv, cdim), dtype),
            m_convb=TensorSpec((cdim,), dtype),
            m_Alog=TensorSpec((nh,), f32), m_D=TensorSpec((nh,), f32),
            m_dtb=TensorSpec((nh,), f32), m_out=TensorSpec((d_in, d), dtype))
    if BLOCK_MLSTM in types:
        d_in, nh, dh = m["d_in"], m["nh_x"], m["dh_x"]
        spec.update(
            x_norm=TensorSpec((d,), dtype),
            x_up=TensorSpec((d, 2 * d_in), dtype),
            x_q=TensorSpec((nh, dh, dh), dtype),
            x_k=TensorSpec((nh, dh, dh), dtype),
            x_v=TensorSpec((nh, dh, dh), dtype),
            x_ig=TensorSpec((d_in, nh), f32), x_fg=TensorSpec((d_in, nh), f32),
            x_down=TensorSpec((d_in, d), dtype),
            x_gnorm=TensorSpec((d_in,), dtype))
    if BLOCK_SLSTM in types:
        ffp = max(PRUNE_BLOCK, (4 * d // 3) // PRUNE_BLOCK * PRUNE_BLOCK)
        spec.update(
            s_norm=TensorSpec((d,), dtype), s_wx=TensorSpec((d, 4 * d), dtype),
            s_r=TensorSpec((4, d), f32), s_out=TensorSpec((d, d), dtype),
            s_fnorm=TensorSpec((d,), dtype),
            s_up=TensorSpec((d, 2 * ffp), dtype),
            s_down=TensorSpec((ffp, d), dtype))
    for t, pre in ((BLOCK_ENC, "e_"), (BLOCK_DEC, "d_")):
        if t not in types:
            continue
        spec.update(_attn_fields(pre, d, nq, nkv, hd, dtype, True))
        for i in (1, 2) + ((3,) if t == BLOCK_DEC else ()):
            spec.update({f"{pre}ln{i}": TensorSpec((d,), dtype),
                         f"{pre}ln{i}b": TensorSpec((d,), dtype)})
        spec.update({f"{pre}w1": TensorSpec((d, ff), dtype),
                     f"{pre}b1": TensorSpec((ff,), dtype),
                     f"{pre}w2": TensorSpec((ff, d), dtype),
                     f"{pre}b2": TensorSpec((d,), dtype)})
        if t == BLOCK_DEC:
            spec.update(_attn_fields("c_", d, nq, nkv, hd, dtype, True))
    return spec


def shared_param_spec(cfg: ModelConfig, dtype=torch.float32
                      ) -> Dict[str, TensorSpec]:
    """Model-level (non-slot) params beyond embed / head / final_norm: the
    zamba2 shared attention block (``ga_*``) and the whisper decoder's
    learned positions (``dec_pos``)."""
    m = _dims(cfg)
    spec: Dict[str, TensorSpec] = {}
    if cfg.family == "hybrid" and cfg.shared_attn_period:
        spec.update({f"ga_{k}": v for k, v in _attn_fields(
            "", m["d"], m["nq"], m["nkv"], m["hd"], dtype, False).items()})
        spec["ga_norm"] = TensorSpec((m["d"],), dtype)
    if cfg.is_encdec:
        spec["dec_pos"] = TensorSpec((cfg.max_seq_len, m["d"]), dtype)
    return spec


def slot_cache_spec(cfg: ModelConfig, mb: int, cache_len: int,
                    dtype=torch.bfloat16) -> Dict[str, TensorSpec]:
    """Per-slot decode cache (the union over the arch's type set): one K/V
    line per lane for attention, the encoder's cross K/V for the decoder,
    the conv tail and SSM state for Mamba2, the matrix memory for mLSTM and
    the cell state for sLSTM.  K/V and the conv tail are bf16 by default,
    as in the reference, whatever the param dtype; recurrent state is
    float32."""
    check_ported(cfg)
    m = _dims(cfg)
    types = block_type_set(cfg)
    f32 = torch.float32
    cap = cache_len
    if cfg.sliding_window:
        cap = min(cache_len, cfg.sliding_window)
    nkv, hd = m["nkv"], m["hd"]
    spec: Dict[str, TensorSpec] = {}
    if any(t in types for t in (BLOCK_DENSE, BLOCK_MOE, BLOCK_HYBRID_ATTN,
                                BLOCK_DEC, BLOCK_ENC)):
        spec.update(k=TensorSpec((mb, cap, nkv, hd), dtype),
                    v=TensorSpec((mb, cap, nkv, hd), dtype))
    if BLOCK_DEC in types:
        shape = (mb, cfg.encoder_seq, nkv, hd)
        spec.update(ck=TensorSpec(shape, dtype), cv=TensorSpec(shape, dtype))
    if BLOCK_MAMBA in types or BLOCK_HYBRID_ATTN in types:
        spec.update(
            conv=TensorSpec((mb, cfg.d_conv - 1, m["conv_dim"]), dtype),
            ssm=TensorSpec((mb, m["nh_m"], MAMBA_HEAD, m["st"]), f32))
    if BLOCK_MLSTM in types:
        nh, dh = m["nh_x"], m["dh_x"]
        spec.update(xC=TensorSpec((mb, nh, dh, dh), f32),
                    xn=TensorSpec((mb, nh, dh), f32),
                    xm=TensorSpec((mb, nh), f32))
    if BLOCK_SLSTM in types:
        spec.update({k: TensorSpec((mb, m["d"]), f32)
                     for k in ("sc", "sn", "sm", "sh")})
    return spec


def paged_slot_cache_spec(cfg: ModelConfig, pool_pages: int, page_size: int,
                          dtype=torch.bfloat16) -> Dict[str, TensorSpec]:
    """Per-slot block-paged decode cache ``[pool_pages + 1, page_size, n_kv,
    head_dim]``; the final block is the trash block absorbing gated writes.
    Only attention-pure decoder archs page their cache, as in the
    reference: recurrent state is O(1) per lane, and a sliding-window cache
    is already a ring."""
    types = set(block_type_set(cfg))
    if not types <= {BLOCK_DENSE, BLOCK_MOE}:
        raise ValueError(
            f"paged KV requires an attention-only arch, got types {types}")
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


def _normal(gen, shape, scale, device):
    return torch.randn(shape, generator=gen, device=device).mul_(scale)


def init_slot(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
              *, lead: Sequence[int] = (), device=None
              ) -> Dict[str, torch.Tensor]:
    """Slot params with ``lead`` leading dims (``(S, L_max)`` for a stacked
    stage tree), by the reference's name rules: norms and LayerNorm scales
    ones; biases named ``*b`` / ``*_bq`` / ``*_bv`` / ``*_bo``, ``m_convb``,
    ``m_dtb`` and ``s_r`` zeros; ``m_Alog`` = log(linspace(1, 16)),
    ``m_D`` ones; the mLSTM gates N(0, 0.02) around -1 (input) and 3
    (forget); everything else — ``e_b1`` / ``d_b2`` included, whose names
    end in a digit — N(0, fan_in^-1/2), fan_in the second-last dim (the
    last for a vector).  The numbers come from ``gen``, not jax's PRNG."""
    out = {}
    for name, sds in sorted(slot_param_spec(cfg, dtype).items()):
        shape = tuple(lead) + sds.shape
        if name.endswith(("norm", "gnorm", "fnorm")) or name.startswith(
                ("e_ln", "d_ln")) and not name.endswith("b"):
            t = torch.ones(shape, device=device)
        elif name.endswith(("b", "_bq", "_bv", "_bo")) or name in (
                "m_convb", "m_dtb", "s_r"):
            t = torch.zeros(shape, device=device)
        elif name == "m_Alog":
            t = torch.log(torch.linspace(1.0, 16.0, sds.shape[0],
                                         device=device)).expand(shape)
        elif name == "m_D":
            t = torch.ones(shape, device=device)
        elif name in ("x_ig", "x_fg"):
            base = 3.0 if name == "x_fg" else -1.0
            t = _normal(gen, shape, 0.02, device).add_(base)
        else:
            fan_in = sds.shape[-2] if len(sds.shape) >= 2 else sds.shape[-1]
            t = _normal(gen, shape, 0.02 if fan_in <= 0 else fan_in ** -0.5,
                        device)
        out[name] = t.to(sds.dtype).contiguous()
    return out


def init_shared(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                device=None) -> Dict[str, torch.Tensor]:
    """The model-level params: norms ones, the rest N(0, fan_in^-1/2)."""
    out = {}
    for name, sds in sorted(shared_param_spec(cfg, dtype).items()):
        if name.endswith("norm"):
            out[name] = torch.ones(sds.shape, dtype=sds.dtype, device=device)
        else:
            fan_in = sds.shape[-2] if len(sds.shape) >= 2 else sds.shape[-1]
            out[name] = _normal(gen, sds.shape, fan_in ** -0.5,
                                device).to(sds.dtype)
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
              causal: bool = True, block_mask=None, bq=None, bv=None,
              bo=None, kv_override=None, cache_keys=("k", "v"), dyncfg=None,
              kernel_impl: str = "scan", hash_proj=None):
    """GQA attention with optional RoPE, biases (q, v, o), a separate
    key/value stream (``kv_override``: cross attention) and a cache.
    x: [mb, s, d]; pos: [s] absolute positions (train/prefill), or a scalar
    / [mb] tensor (decode).  Returns (out, cache, density).

    The port writes caches IN PLACE (the reference returns updated copies):
    prefill writes the lane lines of ``cache``'s ``cache_keys`` fields,
    decode writes one position per lane, into the dense lines or through
    the page table into the pool.  The returned cache is the same dict.
    Projections promote mixed dtypes as jnp does (the zamba2 shared block
    keeps float32 params next to a bf16 stream)."""
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
    q = matmul(x, wq)
    if bq is not None:
        q = q + bq
    q = q.reshape(b, s, nq, hd)
    xkv = x if kv_override is None else kv_override
    sk = xkv.shape[1]
    k = matmul(xkv, wk).reshape(b, sk, nkv, hd)
    v = matmul(xkv, wv)
    if bv is not None:
        v = v + bv
    v = v.reshape(b, sk, nkv, hd)

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
        kc, vc = cache[cache_keys[0]], cache[cache_keys[1]]
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
            k = apply_rope(k, pos[None, :sk].expand(b, sk), cfg.rope_theta)
        out = flash_attention(q, k, v, causal=causal,
                              sliding_window=cfg.sliding_window,
                              block_mask=block_mask, kv_block=kv_block,
                              impl=kernel_impl)
        if mode == "prefill" and cache is not None:
            kc, vc = cache[cache_keys[0]], cache[cache_keys[1]]
            cap = kc.shape[1]
            if cap >= sk:
                kc[:, :sk] = k.to(kc.dtype)
                vc[:, :sk] = v.to(vc.dtype)
            elif cache_keys == ("k", "v"):
                # ring buffer: keep the last `cap` positions, position q at
                # slot q % cap, where decode writes it
                kc.copy_(torch.roll(k[:, -cap:], s % cap, dims=1))
                vc.copy_(torch.roll(v[:, -cap:], s % cap, dims=1))
            else:
                # cross keys: the last `cap` rows, as the reference keeps them
                kc.copy_(k[:, -cap:])
                vc.copy_(v[:, -cap:])
    out = matmul(out.reshape(b, out.shape[1], nq * hd), wo)
    if bo is not None:
        out = out + bo
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


# (sum over the data replicas, replica count) while a pipeline loss runs
# across data replicas (``data_sum``); None: the microbatch is whole here
_DATA_SUM: Optional[Tuple[Callable, int]] = None


@contextlib.contextmanager
def data_sum(fn: Optional[Callable], data: int = 1):
    """Within the block, ``moe_ffn``'s load-balancing loss is taken over
    the whole microbatch: ``fn`` sums a tensor over the ``data`` replicas
    (None: nothing to sum)."""
    global _DATA_SUM
    prev, _DATA_SUM = _DATA_SUM, (None if fn is None else (fn, data))
    try:
        yield
    finally:
        _DATA_SUM = prev


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
    sums are equal).

    Under ``data_sum`` (a replica's lanes of the microbatch) the auxiliary
    loss is the whole microbatch's: the router's probability sums and the
    loads are summed over the replicas before the product, the other
    replicas' sums entering as constants (the router's gradient stays
    local and is summed over ``data`` with every gradient).  ``load`` and
    the drop fraction stay the replica's own."""
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
    if _DATA_SUM is None:
        me = probs.reshape(-1, E).mean(0)
        ce = load / torch.clamp(load.sum(), min=1.0)
    else:
        red, data = _DATA_SUM
        sp = probs.reshape(-1, E).sum(0)
        sp = sp + (red(sp.detach()) - sp.detach())
        me = sp / float(b * s * data)
        load_all = red(load)
        ce = load_all / torch.clamp(load_all.sum(), min=1.0)
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


def _mamba_block(p, x, *, cfg, mode, cache, pos, dyn, shared=None,
                 with_shared_attn=False, dyncfg=None, kernel_impl="scan",
                 hash_proj=None):
    """Mamba2 block (SSD); HYBRID_ATTN slots follow it with the model's
    shared attention block (``shared["ga_*"]``, rms-normed, RoPE, causal)
    over the same cache dict's k/v."""
    m = _dims(cfg)
    d_in, nh, st = m["d_in"], m["nh_m"], m["st"]
    b, s, _ = x.shape
    hn = rms_norm(x, p["m_norm"], cfg.norm_eps)
    proj = matmul(hn, p["m_in"])                                # [b,s,...]
    z, xs, Bm, Cm, dt = torch.split(proj, [d_in, d_in, st, st, nh], dim=-1)
    dt = F.softplus(dt.float() + p["m_dtb"])
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, conv_state = mamba_lib.causal_conv(
        conv_in, p["m_convw"], p["m_convb"],
        state=cache["conv"] if mode == "decode" else None)
    xs, Bm, Cm = torch.split(conv_out, [d_in, st, st], dim=-1)
    xh = xs.reshape(b, s, nh, MAMBA_HEAD)
    if mode == "decode":
        y, ssm = mamba_lib.ssd_decode_step(
            xh[:, 0], dt[:, 0], p["m_Alog"], Bm[:, 0], Cm[:, 0], p["m_D"],
            cache["ssm"])
        y = y[:, None]
    else:
        y, ssm = mamba_lib.ssd_chunked(xh, dt, p["m_Alog"], Bm, Cm, p["m_D"])
    y = y.reshape(b, s, d_in) * F.silu(z)
    x = x + matmul(y, p["m_out"])
    if mode in ("decode", "prefill") and cache is not None:
        cache["conv"].copy_(conv_state.to(cache["conv"].dtype))
        cache["ssm"].copy_(ssm)
    if with_shared_attn:
        h, cache, _ = _attn_fwd(
            rms_norm(x, shared["ga_norm"], cfg.norm_eps),
            shared["ga_wq"], shared["ga_wk"], shared["ga_wv"],
            shared["ga_wo"], cfg=cfg, mode=mode, cache=cache, pos=pos,
            dyncfg=dyncfg, kernel_impl=kernel_impl, hash_proj=hash_proj)
        x = x + h
    return x, cache, {"ff_active": torch.ones((), device=x.device)}, 0.0


def _mlstm_block(p, x, *, cfg, mode, cache, pos, dyn):
    """mLSTM block: the up-projection (its two halves gated by the pruning
    mask), per-head q/k/v, exponential input / forget gates, the parallel
    (s <= 512) or chunked form, a group-normed, z-gated output.  Prefill
    rebuilds the recurrent state by the one-token recurrence over the
    prompt (``_mlstm_final_state``)."""
    m = _dims(cfg)
    d_in, nh, dh = m["d_in"], m["nh_x"], m["dh_x"]
    b, s, _ = x.shape
    hn = rms_norm(x, p["x_norm"], cfg.norm_eps)
    up = matmul(hn, p["x_up"])
    u, z = torch.chunk(up, 2, dim=-1)                           # [b,s,d_in]
    mask = expand_ff_mask(dyn["ff_mask"], 2 * d_in)
    u = u * mask[:d_in].to(u.dtype)
    z = z * mask[d_in:].to(z.dtype)
    uh = u.reshape(b, s, nh, dh)
    q = torch.einsum("bshd,hde->bshe", uh, p["x_q"].to(uh.dtype))
    k = torch.einsum("bshd,hde->bshe", uh, p["x_k"].to(uh.dtype))
    v = torch.einsum("bshd,hde->bshe", uh, p["x_v"].to(uh.dtype))
    ig = matmul(u, p["x_ig"].to(u.dtype))
    fg = matmul(u, p["x_fg"].to(u.dtype))
    if mode == "decode":
        h, C, n, mm = xlstm_lib.mlstm_decode_step(
            q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0],
            cache["xC"], cache["xn"], cache["xm"])
        h = h[:, None]
        _put(cache, xC=C, xn=n, xm=mm)
    else:
        if s <= 512:
            h = xlstm_lib.mlstm_parallel(q, k, v, ig, fg)
        else:
            h = xlstm_lib.mlstm_chunked(q, k, v, ig, fg)
        if mode == "prefill" and cache is not None:
            C, n, mm = _mlstm_final_state(q, k, v, ig, fg)
            _put(cache, xC=C, xn=n, xm=mm)
    h = h.reshape(b, s, d_in)
    h = rms_norm(h, p["x_gnorm"], cfg.norm_eps) * F.silu(z)
    x = x + matmul(h, p["x_down"])
    return x, cache, {"ff_active": dyn["ff_mask"].mean()}, 0.0


def _mlstm_final_state(q, k, v, ig, fg):
    """The mLSTM state after the whole prompt, by the one-token recurrence
    from an empty state (the reference's ``lax.scan``; a host loop over
    time here)."""
    b, s, nh, dh = q.shape
    C = torch.zeros((b, nh, dh, dh), device=q.device)
    n = torch.zeros((b, nh, dh), device=q.device)
    mm = torch.full((b, nh), float("-inf"), device=q.device)
    for t in range(s):
        _, C, n, mm = xlstm_lib.mlstm_decode_step(
            q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t], C, n, mm)
    return C, n, mm


def _slstm_block(p, x, *, cfg, mode, cache, pos, dyn):
    """sLSTM block: the recurrent scan over time (its state in the cache at
    prefill / decode), then a gated FFN."""
    b, s, d = x.shape
    hn = rms_norm(x, p["s_norm"], cfg.norm_eps)
    gates = matmul(hn, p["s_wx"]).reshape(b, s, 4, d)
    init = None
    if mode == "decode":
        init = (cache["sc"], cache["sn"], cache["sm"], cache["sh"])
    h, carry = xlstm_lib.slstm_scan(gates, p["s_r"], init=init)
    if mode in ("decode", "prefill") and cache is not None:
        _put(cache, sc=carry[0], sn=carry[1], sm=carry[2], sh=carry[3])
    x = x + matmul(h, p["s_out"])
    hn = rms_norm(x, p["s_fnorm"], cfg.norm_eps)
    a, g = torch.chunk(matmul(hn, p["s_up"]), 2, dim=-1)
    x = x + matmul(F.silu(g) * a, p["s_down"])
    return x, cache, {"ff_active": torch.ones((), device=x.device)}, 0.0


def _put(cache, **fields):
    """Write recurrent state into the cache's views in place."""
    for k, v in fields.items():
        cache[k].copy_(v.to(cache[k].dtype))


def _enc_block(p, x, *, cfg, mode, cache, pos, dyn, kernel_impl="scan"):
    """Whisper encoder block: pre-LN, non-causal biased attention without
    RoPE over the frames, pre-LN biased GELU MLP."""
    h, _, _ = _attn_fwd(
        layer_norm(x, p["e_ln1"], p["e_ln1b"], cfg.norm_eps),
        p["e_wq"], p["e_wk"], p["e_wv"], p["e_wo"], cfg=cfg, mode="train",
        cache=None, pos=None, rope=False, causal=False, bq=p["e_bq"],
        bv=p["e_bv"], bo=p["e_bo"], kernel_impl=kernel_impl)
    x = x + h
    hn = layer_norm(x, p["e_ln2"], p["e_ln2b"], cfg.norm_eps)
    x = x + gelu_mlp(hn, p["e_w1"], p["e_b1"], p["e_w2"], p["e_b2"],
                     dyn["ff_mask"], impl=kernel_impl)
    return x, cache, {"ff_active": dyn["ff_mask"].mean()}, 0.0


def _dec_block(p, x, *, cfg, mode, cache, pos, dyn, enc_out,
               kernel_impl="scan"):
    """Whisper decoder block: causal biased self attention (learned
    positions were added at the embedding), cross attention over the
    encoder stream (in decode over the ``ck`` / ``cv`` cached at prefill,
    at length ``encoder_seq``), and the biased GELU MLP."""
    h, cache, _ = _attn_fwd(
        layer_norm(x, p["d_ln1"], p["d_ln1b"], cfg.norm_eps),
        p["d_wq"], p["d_wk"], p["d_wv"], p["d_wo"], cfg=cfg, mode=mode,
        cache=cache, pos=pos, rope=False, causal=True, bq=p["d_bq"],
        bv=p["d_bv"], bo=p["d_bo"], kernel_impl=kernel_impl)
    x = x + h
    hn = layer_norm(x, p["d_ln2"], p["d_ln2b"], cfg.norm_eps)
    if mode == "decode":
        m = _dims(cfg)
        q = (matmul(hn, p["c_wq"]) + p["c_bq"]).reshape(
            hn.shape[0], 1, m["nq"], m["hd"])
        out = decode_attention(q, cache["ck"], cache["cv"], cfg.encoder_seq)
        h = matmul(out.reshape(hn.shape[0], 1, m["nq"] * m["hd"]),
                   p["c_wo"]) + p["c_bo"]
    else:
        h, cache, _ = _attn_fwd(
            hn, p["c_wq"], p["c_wk"], p["c_wv"], p["c_wo"], cfg=cfg,
            mode=mode, cache=cache, pos=pos, rope=False, causal=False,
            bq=p["c_bq"], bv=p["c_bv"], bo=p["c_bo"], kv_override=enc_out,
            cache_keys=("ck", "cv"), kernel_impl=kernel_impl)
    x = x + h
    hn = layer_norm(x, p["d_ln3"], p["d_ln3b"], cfg.norm_eps)
    x = x + gelu_mlp(hn, p["d_w1"], p["d_b1"], p["d_w2"], p["d_b2"],
                     dyn["ff_mask"], impl=kernel_impl)
    return x, cache, {"ff_active": dyn["ff_mask"].mean()}, 0.0


def apply_block(cfg: ModelConfig, dyncfg, mode: str, p, shared, carry,
                tag: int, dyn, cache, pos, *, kernel_impl: str = "scan",
                hash_proj=None):
    """Apply one slot.  ``tag`` is the slot's BLOCK_* type id (a host int);
    ``carry`` is the pipeline activation dict: {"x": [mb, s, d]} plus, for
    encoder–decoder archs, {"enc": [mb, enc_seq, d]} — the encoder stream
    rides the same carry, so encoder blocks can live on any stage.

    Returns (carry', new_cache, stats, aux_loss); ``stats`` holds the
    fields the block sets (the rest of ``stats_spec`` are zeros).  PAD
    slots are the identity, and so is an encoder block in decode or on a
    carry without the encoder stream (the reference's rule)."""
    if tag == BLOCK_PAD:
        return carry, cache, {}, 0.0
    x = carry["x"]
    kw = dict(cfg=cfg, mode=mode, cache=cache, pos=pos, dyn=dyn)
    if tag == BLOCK_ENC:
        if mode == "decode" or "enc" not in carry:
            return carry, cache, {}, 0.0
        e, c, st, aux = _enc_block(p, carry["enc"], kernel_impl=kernel_impl,
                                   **kw)
        return {**carry, "enc": e}, c, st, aux
    if tag in (BLOCK_DENSE, BLOCK_MOE):
        block = _dense_block if tag == BLOCK_DENSE else _moe_block
        y, c, st, aux = block(p, x, dyncfg=dyncfg, kernel_impl=kernel_impl,
                              hash_proj=hash_proj, **kw)
    elif tag in (BLOCK_MAMBA, BLOCK_HYBRID_ATTN):
        y, c, st, aux = _mamba_block(
            p, x, shared=shared, with_shared_attn=tag == BLOCK_HYBRID_ATTN,
            dyncfg=dyncfg, kernel_impl=kernel_impl, hash_proj=hash_proj,
            **kw)
    elif tag == BLOCK_MLSTM:
        y, c, st, aux = _mlstm_block(p, x, **kw)
    elif tag == BLOCK_SLSTM:
        y, c, st, aux = _slstm_block(p, x, **kw)
    elif tag == BLOCK_DEC:
        y, c, st, aux = _dec_block(p, x, enc_out=carry.get("enc"),
                                   kernel_impl=kernel_impl, **kw)
    else:
        raise ValueError(f"unknown block type {BLOCK_TYPE_NAMES.get(tag, tag)}")
    # shared params are float32: keep the carry in its configured dtype
    return {**carry, "x": y.to(x.dtype)}, c, st, aux
