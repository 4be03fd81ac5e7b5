"""Block-pruned matmul: the CUDA kernel's wrapper, the differentiable op
built from it, and the block-pruned SwiGLU composed from that.

``product`` is one K3 launch (on CUDA tensors, ``csrc/pruned_matmul.cu``,
reading x and w and writing the output through their strides, so a
transposed view costs no copy) or its plain version in ``ref.py`` (on CPU
tensors).  ``pruned_matmul`` flattens the leading dims and goes through an
autograd Function whose backward is the reference's ``pruned_matmul_bwd_p``
(``backward.py``): four more K3 products with the mask in the other slot.
``pruned_swiglu`` is three such calls with ``silu(a)·b`` between them,
exactly as the reference composes it, and differentiable through them.
``matmul_tile_work`` is the reference's tile accounting, unchanged.

Each CUDA product goes to one of two variants of K3, chosen by
``pm_variant`` from dtype, mask block and strides alone, before the
launch:

- ``"tc"`` — the tensor-core variant (``pm_fwd_tc``: 3xTF32 ``mma.sync``
  on a ``cp.async`` ring, fp32-accurate; one pass for bf16): a mask block
  that is a multiple of the 128-wide output tile (mask over N) or of the
  64-deep k chunk (mask over K), x and w 16-byte aligned, each with a
  unit-stride axis and its other stride a multiple of 16 bytes.  Every
  product of the forward and backward main paths meets these.  An fp32
  product whose grid would leave the card's last wave mostly idle is cut
  along K (``pm_splits``) into fp32 slices summed in a fixed order.
- ``"simt"`` — the CUDA-core kernel (``pm_fwd``): any other mask block
  (64 over N, 32 or 48 over K) or stride.

A call that meets the tensor-core conditions launches that variant or
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import accounting
from repro_torch.kernels._build import Kernel, dtype_code
from repro_torch.kernels.pruned_matmul.ref import pruned_matmul_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = Kernel(
    "pruned_matmul", "pruned_matmul/csrc/pruned_matmul.cu",
    replaces="src/repro/kernels/pruned_matmul/pruned_matmul.py:83",
    functions={"pm_fwd": [_P] * 4 + [_I] * 5 + [_L] * 6 + [_I, _P],
               "pm_fwd_tc": [_P] * 4 + [_I] * 5 + [_L] * 6
               + [_P, _I, _I, _P]})

_DTYPES = (torch.float32, torch.bfloat16)
TC_TILE, TC_CHUNK_K = 128, 64        # pm_tc_kernel's TBM = TBN and TBK
TC_SMS = 132                         # an H100 SXM's SMs: one tile each


def pm_variant(dtype, mask_axis: str, blk: int, x_stride, w_stride,
               aligned: bool = True) -> str:
    """Which variant of K3 serves a CUDA product (module docstring): "tc"
    or "simt".  ``x_stride`` / ``w_stride``: the (row, column) strides of
    x [M, K] and w [K, N] in elements; ``aligned``: x and w start on 16
    bytes."""
    if dtype not in _DTYPES or not aligned or blk <= 0:
        return "simt"
    if blk % (TC_TILE if mask_axis == "n" else TC_CHUNK_K):
        return "simt"
    vec = 16 // (4 if dtype == torch.float32 else 2)

    def unit_axis(rows, cols):   # one unit-stride axis, the other 16-byte
        return ((cols == 1 and rows % vec == 0)
                or (rows == 1 and cols % vec == 0))

    return "tc" if unit_axis(*x_stride) and unit_axis(*w_stride) else "simt"


def pm_splits(M: int, K: int, N: int, dtype) -> int:
    """How many ranges of k chunks a tensor-core product is cut into (fp32
    only; each range's sum goes to an fp32 slice, added in order by a
    second kernel).  The card runs one 128 x 128 tile a SM, so a grid that
    leaves most of its last wave empty (dw of the SwiGLU backward: 160
    tiles on 132 SMs) is cut along K: the split with the fewest chunk
    steps on the busiest SM, when that saves at least a fifth."""
    if dtype != torch.float32:
        return 1
    tiles = -(-M // TC_TILE) * -(-N // TC_TILE)
    nch = -(-K // TC_CHUNK_K)

    def steps(s):
        return -(-tiles * s // TC_SMS) * -(-nch // s)

    best = min(range(1, 5), key=lambda s: (steps(s), s))
    return best if steps(best) <= 0.8 * steps(1) else 1


def product(x, w, block_mask, mask_axis: str, blk: int, *,
            bwd: bool = False, out=None):
    """One block-pruned product x [M, K] @ w [K, N] (any strides) under a
    mask over N ("n") or K ("k") in blocks of ``blk``; fp32 accumulation,
    output in x's dtype, written into ``out`` (any strides) when given.
    ``bwd`` counts the launch as a backward one."""
    M, K = x.shape
    N = w.shape[1]
    if not x.is_cuda:
        def run():
            res = pruned_matmul_ref(x, w, block_mask, mask_axis=mask_axis,
                                    bn=blk, bk=blk)
            return res if out is None else out.copy_(res)

        def work():
            keep = (1.0 if block_mask.is_meta else
                    float((np.asarray(block_mask.cpu()) > 0).mean()))
            return {"K3.bwd" if bwd else "K3": (
                2.0 * M * K * N * keep,
                accounting.nbytes(x, w, block_mask)
                + M * N * x.element_size())}
        return accounting.plain(
            work, run, lambda: (x.new_empty((M, N)) if out is None else out),
            x)
    for name, t in (("x", x), ("w", w)):
        if not t.is_cuda or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-d CUDA tensor, got "
                             f"{tuple(t.shape)} on {t.device}")
        if t.dtype not in _DTYPES or t.dtype != x.dtype:
            raise TypeError(f"{name}: dtype {t.dtype} (x is {x.dtype})")
    if out is None:
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    elif out.shape != (M, N) or out.dtype != x.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} != "
                         f"{(M, N)} {x.dtype}")
    mask = block_mask.to(device=x.device, dtype=torch.int32).contiguous()
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    args = (x.data_ptr(), w.data_ptr(), mask.data_ptr(), out.data_ptr(), M,
            K, N, int(mask_axis == "n"), blk, *x.stride(), *w.stride(),
            *out.stride())
    if pm_variant(x.dtype, mask_axis, blk, x.stride(), w.stride(),
                  aligned) == "simt":
        KERNEL.launch("pm_fwd", *args, dtype_code(x.dtype), bwd=bwd)
        return out
    splits = pm_splits(M, K, N, x.dtype)
    part = (torch.empty((splits, M, N), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    KERNEL.launch("pm_fwd_tc", *args,
                  None if part is None else part.data_ptr(), splits,
                  dtype_code(x.dtype), bwd=bwd, tc=True)
    return out


class _PrunedMatmul(torch.autograd.Function):
    """K3 forward; K3 backward products (the reference's ``_pm_flat``)."""

    @staticmethod
    def forward(ctx, x, w, block_mask, mask_axis, blk):
        ctx.save_for_backward(x, w, block_mask)
        ctx.mask_axis, ctx.blk = mask_axis, blk
        return product(x, w, block_mask, mask_axis, blk)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.pruned_matmul.backward import (
            pruned_matmul_bwd)
        x, w, block_mask = ctx.saved_tensors
        dx, dw = pruned_matmul_bwd(
            x, w, block_mask, g.float(), mask_axis=ctx.mask_axis,
            blk=ctx.blk, need_dx=ctx.needs_input_grad[0],
            need_dw=ctx.needs_input_grad[1])
        return dx, dw, None, None, None


def pruned_matmul(x, w, block_mask, *, mask_axis: str = "n", bn: int = 128,
                  bk: int = 128):
    """x: [..., K] @ w: [K, N] under a block mask of N // bn ("n") or
    K // bk ("k") entries; the masked dim must be a block multiple.
    Differentiable in x and w."""
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
    out = _PrunedMatmul.apply(x.reshape(-1, K), w, block_mask, mask_axis,
                              blk)
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
