"""A plain model of the 3xTF32 arithmetic of ``tf32x3.cuh``.

For the tests and as documentation only: no path of the port calls it.
``split_tf32`` does on the fp32 bits what ``cvt.rna.tf32.f32`` does (round
to nearest, ties away from zero, to 10 mantissa bits) and splits x into
hi + lo; ``tf32x3_matmul_ref`` forms K3's block-pruned product from the
three TF32 terms, each exact, summed in float64 — the value the kernel's
fp32 sums approximate — and falls back to the plain fp32 product where an
operand is not finite, as the kernel does.
"""
from __future__ import annotations

import torch

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
