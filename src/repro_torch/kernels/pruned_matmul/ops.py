"""Block-pruned matmul: the CUDA kernel's wrapper, and the block-pruned
SwiGLU composed from it.

``pruned_matmul`` flattens the leading dims and, on a CUDA tensor, launches
``csrc/pruned_matmul.cu`` (ragged M / N / K bounds-checked in the kernel, no
padding copies); on a CPU tensor it runs the plain version in ``ref.py``.
``pruned_swiglu`` is three such calls with ``silu(a)·b`` between them,
exactly as the reference composes it.  ``matmul_tile_work`` is the
reference's tile accounting, unchanged.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels._build import Kernel, dtype_code, require
from repro_torch.kernels.pruned_matmul.ref import pruned_matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel(
    "pruned_matmul", "pruned_matmul/csrc/pruned_matmul.cu",
    replaces="src/repro/kernels/pruned_matmul/pruned_matmul.py:63",
    functions={"pm_fwd": [_P] * 4 + [_I] * 6 + [_P]})

_DTYPES = (torch.float32, torch.bfloat16)


def pruned_matmul(x, w, block_mask, *, mask_axis: str = "n", bn: int = 128,
                  bk: int = 128):
    """x: [..., K] @ w: [K, N] under a block mask of N // bn ("n") or
    K // bk ("k") entries; the masked dim must be a block multiple."""
    lead = x.shape[:-1]
    K, N = x.shape[-1], w.shape[1]
    if mask_axis not in ("n", "k"):
        raise ValueError(f"mask_axis must be 'n' or 'k', got {mask_axis!r}")
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"w {tuple(w.shape)} does not match x's K = {K}")
    dim, blk = (N, bn) if mask_axis == "n" else (K, bk)
    if dim % blk or tuple(block_mask.shape) != (dim // blk,):
        raise ValueError(f"mask {tuple(block_mask.shape)} does not tile the "
                         f"masked dim {dim} in blocks of {blk}")
    x2 = x.reshape(-1, K)
    if not x.is_cuda:
        out = pruned_matmul_ref(x2, w, block_mask, mask_axis=mask_axis,
                                bn=bn, bk=bk)
        return out.reshape(*lead, N)
    x2 = x2.contiguous()
    require(x2, "x", _DTYPES, 2)
    require(w, "w", (x.dtype,), 2)
    mask = block_mask.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty((x2.shape[0], N), dtype=x.dtype, device=x.device)
    KERNEL.launch("pm_fwd", x2.data_ptr(), w.data_ptr(), mask.data_ptr(),
                  out.data_ptr(), x2.shape[0], K, N, int(mask_axis == "n"),
                  blk, dtype_code(x.dtype))
    return out.reshape(*lead, N)


def pruned_swiglu(x, wi, wg, wo, block_mask, *, bf: int = 128):
    """Block-pruned SwiGLU MLP: the up-projections mask output blocks
    ('n'), the down-projection skips the same blocks as reduction blocks
    ('k').  silu runs in fp32 and h is cast back to x.dtype before the
    down-projection, as in the reference."""
    a = pruned_matmul(x, wg, block_mask, mask_axis="n", bn=bf)
    b = pruned_matmul(x, wi, block_mask, mask_axis="n", bn=bf)
    h = F.silu(a.float()) * b.float()
    return pruned_matmul(h.to(x.dtype), wo, block_mask, mask_axis="k",
                         bk=bf)


def matmul_tile_work(M: int, K: int, N: int, block_mask, *,
                     mask_axis: str = "n", bm: int = 128, bn: int = 128,
                     bk: int = 128):
    """MXU tile-work accounting mirroring the kernels' pl.when gating.

    Forward grid is (M/bm, N/bn, K/bk); a pruned block kills the whole
    row/column of tiles it gates.  Backward = dx product + dw product, each
    gated by the same mask (see pruned_matmul_bwd_p)."""
    keep = float((np.asarray(block_mask) > 0).mean())
    nmb = -(-M // bm)
    nnb = -(-N // bn)
    nkb = -(-K // bk)
    fwd_total = nmb * nnb * nkb
    # both mask positions gate the same fraction of the K-sweep tiles
    fwd_active = fwd_total * keep
    # dx: [M,N]x[N,K] grid nmb*nkb*nnb; dw: [K,M]x[M,N] grid nkb*nnb*nmb
    bwd_total = 2 * fwd_total
    bwd_active = bwd_total * keep
    return {
        "fwd_active": fwd_active, "fwd_total": fwd_total,
        "bwd_active": bwd_active, "bwd_total": bwd_total,
    }
