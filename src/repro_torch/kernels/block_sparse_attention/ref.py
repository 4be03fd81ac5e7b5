"""Plain PyTorch versions of the block-sparse flash attention kernels.

The CPU path of ``ops.block_sparse_attention_fwd`` / ``_bwd`` and the
oracles the CUDA kernels (K1 forward, K2a / K2b backward) are held against
on the card: exact dense computations of the kernels' semantics (scores
masked at block granularity plus token-level causal, fp32 softmax with the
fully-masked-row guard, the recompute-from-lse backward), on the model
layout the wrappers take.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _out_dtype(x, compute_dtype):
    """The plain versions return the input dtype when they compute in fp32
    and their compute dtype otherwise (float64: the accuracy yardstick)."""
    return x.dtype if compute_dtype == torch.float32 else compute_dtype


def block_sparse_attention_ref(q, k, v, block_mask, *, causal: bool = True,
                               block: int = 128,
                               compute_dtype=torch.float32):
    """q: [b, sq, hq, d]; k, v: [b, sk, hkv, d]; block_mask: [b|1, hq|1,
    nqb, nkb] (0/1, square blocks of ``block`` tokens).

    Returns (out [b, sq, hq, d] in q.dtype, lse [b, hq, sq] float32); a row
    with no live entry gives zeros and lse ≈ -1e30.  ``compute_dtype``
    float64 computes and returns both in float64."""
    b, sq, hq, d = q.shape
    rep = hq // k.shape[2]
    qf = q.to(compute_dtype).transpose(1, 2)                      # [b,h,sq,d]
    kf = k.to(compute_dtype).repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.to(compute_dtype).repeat_interleave(rep, dim=2).transpose(1, 2)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    mask = live_elements(block_mask, sq, k.shape[1], causal, block)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ vf) / l.clamp_min(1e-30)
    out = torch.where(l > 0, out, torch.zeros_like(out))
    lse = m[..., 0] + torch.log(l[..., 0].clamp_min(1e-30))
    return out.transpose(1, 2).to(_out_dtype(q, compute_dtype)), lse


def live_elements(block_mask, sq: int, sk: int, causal: bool, block: int):
    """[b|1, hq|1, sq, sk] bool: the element predicate the kernels share
    (mask block live, and on or below the diagonal when causal)."""
    mask = (block_mask.repeat_interleave(block, dim=-2)
            .repeat_interleave(block, dim=-1)[..., :sq, :sk] > 0)
    if causal:
        mask = mask & torch.ones(sq, sk, dtype=torch.bool,
                                 device=block_mask.device).tril()
    return mask


def _recompute(q, k, v, block_mask, dout, lse, delta, causal, block,
               compute_dtype=torch.float32):
    """The backward's recomputed tiles, dense: (p, ds, q, k, dout) in
    ``compute_dtype`` with heads second ([b, h, s, ...]; k repeated over the
    GQA group)."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    rep = hq // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.to(compute_dtype).transpose(1, 2)                      # [b,h,sq,d]
    of = dout.to(compute_dtype).transpose(1, 2)
    kf = k.to(compute_dtype).repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.to(compute_dtype).repeat_interleave(rep, dim=2).transpose(1, 2)
    lse, delta = lse.to(compute_dtype), delta.to(compute_dtype)
    s = (qf @ kf.transpose(-1, -2)) * scale
    live = live_elements(block_mask, sq, sk, causal, block)
    live = live & (lse[..., None] > NEG_INF / 4)
    p = torch.where(live, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = of @ vf.transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, qf, kf, of


def _group_sum(t, hkv):
    """[b, hq, s, d] -> [b, s, hkv, d], summing each kv head's q group."""
    b, hq, s, d = t.shape
    return t.reshape(b, hkv, hq // hkv, s, d).sum(2).transpose(1, 2)


def block_sparse_attention_bwd_dq_ref(q, k, v, block_mask, dout, lse, delta,
                                      *, causal: bool = True,
                                      block: int = 128,
                                      compute_dtype=torch.float32):
    """dq alone (the plain version of the dq sweep, K2a); ``compute_dtype``
    float64 computes and returns it in float64."""
    _, ds, _, kf, _ = _recompute(q, k, v, block_mask, dout, lse, delta,
                                 causal, block, compute_dtype)
    return (ds @ kf).transpose(1, 2).to(_out_dtype(q, compute_dtype))


def block_sparse_attention_bwd_dkv_ref(q, k, v, block_mask, dout, lse,
                                       delta, *, causal: bool = True,
                                       block: int = 128):
    """(dk, dv) alone (the plain version of the dk / dv sweep, K2b)."""
    p, ds, qf, _, of = _recompute(q, k, v, block_mask, dout, lse, delta,
                                  causal, block)
    hkv = k.shape[2]
    return (_group_sum(ds.transpose(-1, -2) @ qf, hkv).to(k.dtype),
            _group_sum(p.transpose(-1, -2) @ of, hkv).to(v.dtype))


def block_sparse_attention_bwd_ref(q, k, v, block_mask, dout, lse, delta, *,
                                   causal: bool = True, block: int = 128):
    """The recompute-from-lse flash backward, dense.  q, dout [b, sq, hq,
    d]; k, v [b, sk, hkv, d]; lse, delta [b, hq, sq] float32 (delta =
    rowsum(dout * out)).  Returns (dq, dk, dv) in the input dtypes; the GQA
    group of each kv head is summed, as the transpose of the reference's
    ``jnp.repeat`` sums it."""
    p, ds, qf, kf, of = _recompute(q, k, v, block_mask, dout, lse, delta,
                                   causal, block)
    hkv = k.shape[2]
    return ((ds @ kf).transpose(1, 2).to(q.dtype),
            _group_sum(ds.transpose(-1, -2) @ qf, hkv).to(k.dtype),
            _group_sum(p.transpose(-1, -2) @ of, hkv).to(v.dtype))
