"""Gradient compression for the data-parallel reduce, ported from
``repro.runtime.compression``.

Two codecs with error feedback:
  * top-k sparsification (values + indices; k as a fraction),
  * int8 linear quantization (per-tensor scale).

``compressed_psum`` is the reference's psum over a named mesh axis with
lossy compression, over the ranks of a ``torch.distributed`` group:
quantize → sum → dequantize (int8, with a scale common to every rank —
the max of theirs — and the codes summed as int32), or top-k scattered
back dense before the sum; without compression it is an all-reduce.  A
group of one rank (or none) sums nothing.  The error feedback state (the
residual carried to the next step) is each rank's own and makes both
codecs convergence-safe.

Rounding: ``torch.round`` rounds half to even, as ``jnp.round`` does.
``torch.topk`` and ``jax.lax.top_k`` may order ties in |g| differently.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def compress_topk(g: torch.Tensor, frac: float = 0.05
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (values, indices, residual).  Flattens g."""
    flat = g.reshape(-1).to(torch.float32)
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(flat.abs(), k)
    picked = flat[idx]
    residual = flat.clone()
    residual[idx] = 0.0
    return picked, idx, residual.reshape(g.shape)


def decompress_topk(vals: torch.Tensor, idx: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= int(d)
    flat = torch.zeros(n, dtype=torch.float32, device=vals.device)
    flat.index_add_(0, idx, vals.to(torch.float32))
    return flat.reshape(tuple(shape)).to(dtype)


def int8_quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.to(torch.float32)
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``group`` (host-staged for gloo and a CUDA
    tensor); ``group`` None or of one rank: ``t``."""
    if group is None:
        return t
    import torch.distributed as dist
    if dist.get_world_size(group) == 1:
        return t
    from repro_torch.launch.dist import Comm
    return Comm(dist.get_backend(group), t.device).all_reduce(t, group, op)


def compressed_psum(g: torch.Tensor, group=None, method: str = "int8",
                    err: Optional[torch.Tensor] = None, frac: float = 0.05
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum over the ranks of ``group`` with lossy compression and error
    feedback.

    Returns (reduced, new_error).  ``err`` is the carried residual."""
    gf = g.to(torch.float32)
    if err is not None:
        gf = gf + err
    if method == "int8":
        _, scale = int8_quantize(gf)
        # the scale must be common across ranks: the max of theirs
        scale = _all_reduce(scale, group, "max")
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        red_q = _all_reduce(q.to(torch.int32), group)
        red = red_q.to(torch.float32) * scale
        new_err = gf - q.to(torch.float32) * scale
    elif method == "topk":
        vals, idx, new_err = compress_topk(gf, frac)
        red = _all_reduce(decompress_topk(vals, idx, gf.shape), group)
    else:
        red = _all_reduce(gf, group)
        new_err = torch.zeros_like(gf)
    return red.to(g.dtype), new_err
