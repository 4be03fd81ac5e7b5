"""A plain model of the 3xTF32 arithmetic of ``tf32x3.cuh``.

For the tests and as documentation only: no path of the port calls it.
``split_tf32`` does on the fp32 bits what ``cvt.rna.tf32.f32`` does (round
to nearest, ties away from zero, to 10 mantissa bits) and splits x into
hi + lo; ``tf32x3_matmul_ref`` forms K3's block-pruned product from the
three TF32 terms, each exact, summed in float64 — the value the kernel's
fp32 sums approximate — and falls back to the plain fp32 product where an
operand is not finite, as the kernel does.  ``bsa_fwd_tf32x3_ref`` (K1)
and ``bsa_dq_tf32x3_ref`` (K2a) follow the attention kernels' order of
accumulation: per 64-row kv tile, every product is one tensor-core
accumulator over at most 64 terms (``tf32x3_product``: the three terms
summed from zero, rounded once to fp32), and fp32 adds the rest — the
64-deep chunks of d, the online softmax's ``o = o·corr + pv`` and dq's
sum over kv tiles.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.block_sparse_attention.ref import (NEG_INF,
                                                            live_elements)

_LOW = 0x1FFF          # the 13 mantissa bits TF32 drops
_HALF = 0x1000         # half a TF32 unit in the last place
# the largest |x| whose TF32 rounding is finite (bits 0x7f7fefff)
TF32_MAX = 3.4019927e38


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> fp32 holding the nearest TF32 value, ties away from zero
    (adding half a unit to the magnitude bits and cutting; a carry into the
    exponent rounds up, to inf past the largest finite value).  inf and
    NaN pass through."""
    x = x.float()
    bits = x.view(torch.int32)
    rounded = ((bits + _HALF) & ~_LOW).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi), so |x - hi - lo| <=
    2^-22 |x|; lo = 0 where hi is not finite (the kernel's rule: inf and
    NaN propagate as in fp32)."""
    x = x.float()
    hi = to_tf32(x)
    fin = torch.isfinite(hi)
    lo = to_tf32(torch.where(fin, x - hi, torch.zeros_like(x)))
    return hi, torch.where(fin, lo, torch.zeros_like(lo))


def tf32x3_matmul_ref(x, w, block_mask, *, mask_axis: str = "n",
                      blk: int = 128):
    """x [M, K] @ w [K, N] under K3's block mask, as the tensor-core
    variant forms it: hi·hi + (hi·lo + lo·hi) from the TF32 splits of x and
    w, in float64 (each TF32 product is exact; the kernel's chunked fp32
    sums are what it approximates).  An output entry whose row of x or
    column of w holds a value outside [-TF32_MAX, TF32_MAX] (inf, NaN, or
    one that would round to inf) is the plain fp32 product, as the kernel
    sums such a tile again in fp32 (the kernel widens this to the 128 x 128
    tile).  Returns float64."""
    m = block_mask.double().repeat_interleave(blk)
    xm = x.float() * m[None, :].float() if mask_axis == "k" else x.float()
    xh, xl = (t.double() for t in split_tf32(xm))
    wh, wl = (t.double() for t in split_tf32(w))
    out = xh @ wh + (xh @ wl + xl @ wh)
    plain = (xm @ w.float()).double()
    if mask_axis == "n":
        out, plain = out * m[None, :], plain * m[None, :].float()
    bad = ((~(xm.abs() <= TF32_MAX)).any(1)[:, None]
           | (~(w.float().abs() <= TF32_MAX)).any(0)[None, :])
    return torch.where(bad, plain, out)


# the attention kernels' kv tile and the deepest sum one accumulator takes
ATTN_TILE = 64


def tf32x3_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., m, k] @ b [..., k, n] as one tensor-core accumulator forms
    it from zero: hi·hi + (hi·lo + lo·hi) of the TF32 splits (each product
    exact), summed in float64 and rounded once to fp32.  Finite operands
    only, as the attention kernels take."""
    ah, al = (t.double() for t in split_tf32(a))
    bh, bl = (t.double() for t in split_tf32(b))
    return (ah @ bh + (ah @ bl + al @ bh)).float()


def _chunked_product(a, b):
    """a @ b over a depth cut into ATTN_TILE-deep chunks, each a
    ``tf32x3_product``, the chunk sums added in fp32 in order."""
    out = None
    for c in range(0, a.shape[-1], ATTN_TILE):
        part = tf32x3_product(a[..., c:c + ATTN_TILE],
                              b[..., c:c + ATTN_TILE, :])
        out = part if out is None else out + part
    return out


def _heads_second(q, k, v):
    """fp32 q, k, v as [b, h, s, d], k and v repeated over the GQA group."""
    rep = q.shape[2] // k.shape[2]
    return (q.float().transpose(1, 2),
            k.float().repeat_interleave(rep, dim=2).transpose(1, 2),
            v.float().repeat_interleave(rep, dim=2).transpose(1, 2))


def bsa_fwd_tf32x3_ref(q, k, v, block_mask, *, causal: bool = True,
                       block: int = 128):
    """K1's arithmetic on the tensor cores: (out [b, sq, hq, d] in q.dtype,
    lse [b, hq, sq] fp32) from the layouts of ``block_sparse_attention_fwd``.

    Per kv tile: S from 64-deep chunks of d, scale and mask in fp32, the
    online softmax in fp32 (a row with no live entry yet keeps p = 0), the
    tile's P·V from zero and ``o = o·corr + pv`` in fp32; at the end
    ``o · (1 / l)`` (zeros where l = 0) and ``lse = m + log(l)``.  A kv
    tile the kernel skips (no live element) leaves m, l and o unchanged
    here too, so every tile is visited."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    qf, kf, vf = _heads_second(q, k, v)
    live = live_elements(block_mask, sq, sk, causal, block)
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, hq, sq), NEG_INF)
    l = torch.zeros((b, hq, sq))
    o = torch.zeros((b, hq, sq, d))
    for c0 in range(0, sk, ATTN_TILE):
        kt, vt = kf[:, :, c0:c0 + ATTN_TILE], vf[:, :, c0:c0 + ATTN_TILE]
        s = _chunked_product(qf, kt.transpose(-1, -2))
        s = torch.where(live[..., c0:c0 + ATTN_TILE], s * scale,
                        torch.full_like(s, NEG_INF))
        mx = torch.maximum(m, s.amax(-1))
        p = torch.where(mx[..., None] <= NEG_INF / 2, torch.zeros_like(s),
                        torch.exp(s - mx[..., None]))
        corr = torch.exp(m - mx)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + tf32x3_product(p, vt)
        m = mx
    inv = 1.0 / l.clamp_min(1e-30)
    out = torch.where(l[..., None] > 0, o * inv[..., None],
                      torch.zeros_like(o))
    lse = m + torch.log(l.clamp_min(1e-30))
    return out.transpose(1, 2).to(q.dtype), lse


def bsa_dq_tf32x3_ref(q, k, v, block_mask, dout, lse, delta, *,
                      causal: bool = True, block: int = 128):
    """K2a's arithmetic on the tensor cores: dq [b, sq, hq, d] in q.dtype
    from the inputs of ``block_sparse_attention_bwd_dq``.

    Per kv tile: S = Q·Kᵀ and dP = dO·Vᵀ from 64-deep chunks of d, p =
    exp(S·scale − lse) on live elements (0 on a fully masked row, lse <=
    -1e30 / 4), dS = p·(dP − delta)·scale in fp32, the tile's dS·K from
    zero, and dq += that in fp32."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    qf, kf, vf = _heads_second(q, k, v)
    of = dout.float().transpose(1, 2)
    live = live_elements(block_mask, sq, sk, causal, block)
    scale = 1.0 / math.sqrt(d)
    L = torch.where(lse > NEG_INF / 4, lse, torch.full_like(lse, math.inf))
    dq = torch.zeros((b, hq, sq, d))
    for c0 in range(0, sk, ATTN_TILE):
        kt, vt = kf[:, :, c0:c0 + ATTN_TILE], vf[:, :, c0:c0 + ATTN_TILE]
        s = _chunked_product(qf, kt.transpose(-1, -2))
        dp = _chunked_product(of, vt.transpose(-1, -2))
        p = torch.where(live[..., c0:c0 + ATTN_TILE],
                        torch.exp(s * scale - L[..., None]),
                        torch.zeros_like(s))
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + tf32x3_product(ds, kt)
    return dq.transpose(1, 2).to(q.dtype)
