"""Backward pass of the grouped expert matmul, and its tile-work
accounting (``src/repro/kernels/grouped_matmul/backward.py``).

dx is the SAME forward kernel (K4) on the per-expert transposed weights
(dx_g = g_g @ w[e]ᵀ, still row-ragged, so the same count-gated tiles
skip): a launch on the view ``w.transpose(1, 2)``, no copy.  dw runs K5,
which sums x_{b,e}ᵀ g_{b,e} over each expert's batch groups with the same
count gating — empty experts cost zero tile work in forward AND backward.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels.grouped_matmul import ops


def grouped_matmul_bwd(x, w, counts, g, *, cap: int, wmap=None, gmap=None,
                       need_dx: bool = True, need_dw: bool = True):
    """x: [G * cap, K], w: [E, K, N], counts: [G], g: [G * cap, N] upstream
    cotangent; ``wmap`` / ``gmap`` as in ``ops.placement_maps``.  Returns
    (dx [G * cap, K] in x's dtype, dw [E, K, N] in w's dtype); a gradient
    not needed comes back as None.

    Dead rows (>= count) of the cotangent are zeroed first, as the
    reference does: the forward emits zeros there, so they carry no
    gradient (the kernels also read dead rows as zero)."""
    M = x.shape[0]
    live = (torch.arange(M, device=g.device) % cap
            < counts.to(g.device).repeat_interleave(cap))
    g = (g * live[:, None].to(g.dtype)).to(x.dtype).contiguous()
    dx = dw = None
    if need_dx:
        dx = ops.grouped_product(g, w.transpose(1, 2), counts, cap, wmap,
                                 bwd=True)
    if need_dw:
        dw = ops.grouped_product_dw(x, g, counts, cap, w.shape[0], gmap,
                                    out_dtype=w.dtype)
    return dx, dw


def grouped_tile_work(counts, cap: int, *, bm: int = 8
                      ) -> Dict[str, float]:
    """Row-tile accounting at measured routed load: active vs total
    (group, row-tile) cells for the forward and the dx+dw backward (the
    reference's, unchanged)."""
    counts = np.asarray(counts)
    gpb = max(1, -(-cap // bm))
    active = int(np.sum(np.minimum(-(-counts // bm), gpb)))
    total = int(counts.size * gpb)
    return {
        "fwd_active": active, "fwd_total": total,
        "bwd_active": 2 * active, "bwd_total": 2 * total,
    }
