"""Plain PyTorch version of the block-sparse flash attention kernel.

The CPU path of ``ops.block_sparse_attention_fwd`` and the oracle the CUDA
kernel is held against on the card: an exact dense computation of the
kernel's semantics (scores masked at block granularity plus token-level
causal, fp32 softmax with the fully-masked-row guard), on the model layout
the wrapper takes.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def block_sparse_attention_ref(q, k, v, block_mask, *, causal: bool = True,
                               block: int = 128):
    """q: [b, sq, hq, d]; k, v: [b, sk, hkv, d]; block_mask: [b|1, hq|1,
    nqb, nkb] (0/1, square blocks of ``block`` tokens).

    Returns (out [b, sq, hq, d] in q.dtype, lse [b, hq, sq] float32); a row
    with no live entry gives zeros and lse ≈ -1e30."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qf = q.float().transpose(1, 2)                                # [b,h,sq,d]
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    mask = (block_mask.repeat_interleave(block, dim=-2)
            .repeat_interleave(block, dim=-1)[..., :sq, :sk] > 0)
    if causal:
        mask = mask & torch.ones(sq, sk, dtype=torch.bool,
                                 device=q.device).tril()
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ vf) / l.clamp_min(1e-30)
    out = torch.where(l > 0, out, torch.zeros_like(out))
    lse = m[..., 0] + torch.log(l[..., 0].clamp_min(1e-30))
    return out.transpose(1, 2).to(q.dtype), lse
