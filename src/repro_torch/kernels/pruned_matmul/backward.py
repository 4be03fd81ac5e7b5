"""Block-pruned matmul backward — built from the same kernel (K3).

The backward of a block-pruned matmul is itself a block-pruned matmul with
the mask moved between the "n" (output-column) and "k" (reduction) slots,
as in the reference (``src/repro/kernels/pruned_matmul/backward.py``):

  mask over N:  out = (x @ w) ⊙ m_N
      dx = (g ⊙ m_N) @ wᵀ   — m in the REDUCTION slot of a [M,N]@[N,K] GEMM
      dw = xᵀ @ (g ⊙ m_N)   — m stays in the output-column slot
  mask over K:  out = (x ⊙ m_K) @ w
      dx = (g @ wᵀ) ⊙ m_K   — m moves to the output-column slot
      dw = m_K ⊙ (xᵀ @ g)   — a row mask: computed as gᵀ @ x with m in the
                               output-column slot, written transposed

On the card all four products are K3 launches on transposed VIEWS (the
kernel reads every operand and writes its output through strides), counted
as backward launches; on the CPU they are the plain version, which masks
the operand or the result exactly where the kernel skips.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pruned_matmul import ops


def pruned_matmul_bwd(x, w, block_mask, g, *, mask_axis: str = "n",
                      blk: int = 128, need_dx: bool = True,
                      need_dw: bool = True):
    """dx [M, K], dw [K, N] (in x's / w's dtype) for out = x @ w under the
    block mask; x [M, K], w [K, N], g [M, N].  A gradient that is not
    needed (``need_dx`` / ``need_dw`` False: a frozen weight) is not
    computed and comes back as None."""
    dt = torch.promote_types(torch.promote_types(x.dtype, w.dtype), g.dtype)
    xs, ws, gs = x.to(dt), w.to(dt), g.to(dt).contiguous()
    dx = dw = None
    if mask_axis == "n":
        if need_dx:
            dx = ops.product(gs, ws.T, block_mask, "k", blk, bwd=True)
        if need_dw:
            dw = ops.product(xs.T, gs, block_mask, "n", blk, bwd=True)
    else:
        if need_dx:
            dx = ops.product(gs, ws.T, block_mask, "n", blk, bwd=True)
        if need_dw:
            # [N, K] product written into a [K, N] tensor through its
            # transposed view
            dw = torch.empty((w.shape[0], w.shape[1]), dtype=dt,
                             device=w.device)
            ops.product(gs.T, xs, block_mask, "n", blk, bwd=True, out=dw.T)
    return (None if dx is None else dx.to(x.dtype),
            None if dw is None else dw.to(w.dtype))
