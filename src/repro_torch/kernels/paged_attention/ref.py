"""Plain PyTorch versions for paged decode attention.

``gather_pages`` + ``paged_attention_ref`` are the reference's non-kernel
path (``kernel_impl != "pallas"``): gather a lane's pages into a contiguous
row and run the unmodified dense ``decode_attention`` — bit-identical to a
contiguous cache.  ``paged_attention_fwd_ref`` is the plain version of the
kernel itself (fp32 softmax and output, unmapped pages masked): the CPU path
of ``ops.paged_attention`` and the oracle the CUDA kernel is held against.
``paged_attention_split_ref`` is the kernel's own order of arithmetic: the
same function through per-split softmax states merged in split order (the
tests hold it to the reference's Pallas kernel; the main path never runs
it).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def gather_pages(kp, vp, page_table):
    """kp/vp: [pool+1, page, n_kv, hd] (last block is trash); page_table:
    [b, J] int32, -1 = unmapped (resolved to trash).  Returns two
    [b, J*page, n_kv, hd] tensors."""
    trash = kp.shape[0] - 1
    blk = torch.where(page_table >= 0, page_table,
                      torch.full_like(page_table, trash)).long()
    k, v = kp[blk], vp[blk]                       # [b, J, page, kv, hd]
    b, j, page, kv, hd = k.shape
    return (k.reshape(b, j * page, kv, hd), v.reshape(b, j * page, kv, hd))


def paged_attention_ref(q, kp, vp, page_table, cache_len):
    """q: [b, 1, h, d]; returns [b, 1, h, d] — the contract of
    ``decode_attention(q, k_cache, v_cache, cache_len)``."""
    from repro_torch.models.layers import decode_attention  # no import cycle
    k, v = gather_pages(kp, vp, page_table)
    return decode_attention(q, k, v, cache_len)


def paged_attention_fwd_ref(q, kp, vp, page_table, cache_len):
    """q: [b, n_q, hd]; kp/vp: [pool+1, page, n_kv, hd]; page_table [b, J];
    cache_len [b].  Position t of lane i is live iff t < cache_len[i] and
    its page is mapped; returns [b, n_q, hd] in q.dtype (zeros for a lane
    with no live position)."""
    b, n_q, hd = q.shape
    page, n_kv = kp.shape[1], kp.shape[2]
    k, v = gather_pages(kp, vp, page_table)
    rep = n_q // n_kv
    kf = k.float().repeat_interleave(rep, dim=2)            # [b, T, n_q, hd]
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), kf) / math.sqrt(hd)
    t = torch.arange(k.shape[1], device=q.device)
    live = ((t[None, :] < cache_len.reshape(-1, 1))
            & (page_table >= 0).repeat_interleave(page, dim=1))[:, None, :]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bht,bthd->bhd", p, vf)
    return (out / torch.where(l > 0, l, torch.ones_like(l))).to(q.dtype)


def paged_attention_split_ref(q, kp, vp, page_table, cache_len, splits):
    """``paged_attention_fwd_ref`` in the CUDA kernel's order: lane i's live
    pages n = min(J, ceil(cache_len[i] / page)) are cut into ``splits``
    contiguous ranges of ceil(n / splits) pages; each range keeps its own
    online-softmax state (m, l, acc) — the empty state (NEG_INF, 0, 0) when
    it holds no live position — and the states are merged in split order:
    M = max m, L = sum l * exp(m - M), out = sum acc * exp(m - M) / L."""
    b, n_q, hd = q.shape
    page, n_kv = kp.shape[1], kp.shape[2]
    J = page_table.shape[1]
    k, v = gather_pages(kp, vp, page_table)
    rep = n_q // n_kv
    kf = k.float().repeat_interleave(rep, dim=2)            # [b, T, n_q, hd]
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), kf) / math.sqrt(hd)
    t = torch.arange(k.shape[1], device=q.device)
    cl = cache_len.reshape(-1, 1).long()
    live = (t[None, :] < cl) & (page_table >= 0).repeat_interleave(page,
                                                                   dim=1)
    n_pages = ((cl + page - 1) // page).clamp(0, J)
    pps = ((n_pages + splits - 1) // splits).clamp(min=1)
    split_of = (t // page)[None, :] // pps                   # [b, T]
    M = torch.full((b, n_q, 1), NEG_INF, device=q.device)
    states = []
    for sp in range(splits):
        mask = (live & (split_of == sp))[:, None, :]         # [b, 1, T]
        ss = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = ss.amax(-1, keepdim=True)
        p = torch.where(mask, torch.exp(ss - m), torch.zeros_like(s))
        states.append((m, p.sum(-1, keepdim=True),
                       torch.einsum("bht,bthd->bhd", p, vf)))
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    acc = torch.zeros((b, n_q, hd), device=q.device)
    for m, l, a in states:
        f = torch.exp(m - M)
        L = L + l * f
        acc = acc + a * f
    return (acc / torch.where(L > 0, L, torch.ones_like(L))).to(q.dtype)
