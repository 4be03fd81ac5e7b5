"""Plain PyTorch version of the block-pruned matmul kernel: the CPU path of
``ops.pruned_matmul`` and the oracle the CUDA kernel is held against."""
from __future__ import annotations

import torch


def pruned_matmul_ref(x, w, block_mask, *, mask_axis: str = "n",
                      bn: int = 128, bk: int = 128):
    """x [M, K] @ w [K, N] in fp32 under a 0/1 block mask over N ("n",
    pruned output columns are zero) or over K ("k", pruned reduction rows
    are not accumulated); output in x.dtype."""
    xf, wf = x.float(), w.float()
    if mask_axis == "n":
        m = block_mask.float().repeat_interleave(bn)
        out = (xf @ wf) * m[None, :]
    else:
        m = block_mask.float().repeat_interleave(bk)
        out = (xf * m[None, :]) @ wf
    return out.to(x.dtype)
