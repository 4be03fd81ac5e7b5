"""Grouped expert matmul: the CUDA kernels' wrappers (K4, K5) and the
differentiable op built from them.

``grouped_product`` is one K4 launch (on CUDA tensors,
``csrc/grouped_matmul.cu``, reading w through its strides, so a transposed
view costs no copy) or its plain version in ``ref.py`` (on CPU tensors);
``grouped_product_dw`` is one K5 launch or its plain version.
``grouped_matmul`` keeps the reference's shape policy (``ops.py``): each
group's rows are padded to a multiple of ``bm`` and the dead rows of x are
zeroed, both outside the autograd boundary; the autograd Function's
backward is the reference's ``grouped_matmul_bwd_p`` (``backward.py``).
The expert placement (``expert_map``: logical expert -> physical group) is
folded into the kernels' weight index instead of gathering the weights.
Counts stay an int32 tensor on the device (the reference's float32 counts
were a ``custom_vjp`` workaround) and are not a gradient input.

Each CUDA call goes to one of two variants of its kernel, chosen by
``gm_variant`` from dtype, shape and strides alone:

- ``"tc"`` — the tensor-core variant (``gm_fwd_tc`` / ``gm_dw_tc``:
  wgmma on TMA-fed shared memory): bf16 operands, ``cap > 16``, K and N
  multiples of 8 (TMA needs rows of 16 bytes), every pointer 16-byte
  aligned, and for K4 w either N-contiguous (the forward) or K-contiguous
  (the dx view ``w.transpose(1, 2)``) with its other strides multiples of
  8.  ``wgmma`` has no fp32 form, and TF32 would change fp32's numerics.
- ``"simt"`` — the CUDA-core variant (``gm_fwd`` / ``gm_dw``): every fp32
  call, the decode tile (``cap <= 16``), and any other shape or stride.

A call that meets the tensor-core conditions launches that variant or
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import accounting
from repro_torch.kernels._build import Kernel, dtype_code
from repro_torch.kernels.grouped_matmul.ref import (grouped_product_dw_ref,
                                                    grouped_product_ref)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SRC = "grouped_matmul/csrc/grouped_matmul.cu"
KERNEL = Kernel(
    "grouped_matmul", _SRC,
    replaces="src/repro/kernels/grouped_matmul/grouped_matmul.py:67",
    functions={"gm_fwd": [_P] * 5 + [_I] * 5 + [_L] * 3 + [_I, _P],
               "gm_fwd_tc": [_P] * 5 + [_I] * 5 + [_L] * 3 + [_P]})
KERNEL_DW = Kernel(
    "grouped_matmul_dw", _SRC,
    replaces="src/repro/kernels/grouped_matmul/grouped_matmul.py:115",
    functions={"gm_dw": [_P] * 5 + [_I] * 5 + [_I, _I, _P],
               "gm_dw_tc": [_P] * 5 + [_I] * 5 + [_I, _P]})

_DTYPES = (torch.float32, torch.bfloat16)


def gm_variant(dtype, cap: int, K: int, N: int, w_stride=None,
               aligned: bool = True) -> str:
    """Which variant of K4 (``w_stride`` = w's (expert, k, n) strides in
    elements) or K5 (``w_stride`` None) serves a CUDA call: "tc" or
    "simt" (module docstring).  ``aligned``: every pointer of the call is
    16-byte aligned."""
    if not (dtype == torch.bfloat16 and cap > 16 and K > 0 and N > 0
            and K % 8 == 0 and N % 8 == 0 and aligned):
        return "simt"
    if w_stride is None:
        return "tc"
    se, sk, sn = w_stride
    if sn == 1 and sk % 8 == 0 and se % 8 == 0 and sk > 0 and se > 0:
        return "tc"
    if sk == 1 and sn % 8 == 0 and se % 8 == 0 and sn > 0 and se > 0:
        return "tc"
    return "simt"


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _shapes(x, cap: int, E: int) -> Tuple[int, int]:
    M = x.shape[0]
    if cap <= 0 or M % cap:
        raise ValueError(f"{M} rows do not split into groups of {cap}")
    G = M // cap
    if G % E:
        raise ValueError(f"{G} groups are not a multiple of {E} experts")
    return M, G


def _check_cuda(name: str, t, dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPES or t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} (x is {dtype})")


def _index(t: Optional[torch.Tensor], device):
    """(int32 tensor on ``device`` or None, its pointer or None)."""
    if t is None:
        return None, None
    t = t.to(device=device, dtype=torch.int32).contiguous()
    return t, t.data_ptr()


def grouped_product(x, w, counts, cap: int, wmap=None, *,
                    bwd: bool = False):
    """One K4 product.  x: [G * cap, K] (groups of ``cap`` rows, rows at or
    past ``counts[g]`` dead), w: [E, K, N] (any strides; a transposed view
    is read in place), counts: [G] int; group g uses ``w[wmap[g % E]]``
    (``wmap`` None: ``w[g % E]``).  Returns [G * cap, N] in x's dtype, dead
    rows 0.  ``bwd`` counts the launch as a backward one (dx)."""
    E, K, N = w.shape
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match w "
                         f"{tuple(w.shape)}")
    M, G = _shapes(x, cap, E)
    if not x.is_cuda:
        return accounting.plain(
            lambda: {"K4.dx" if bwd else "K4": (
                2.0 * M * K * N, accounting.nbytes(x, w, counts, wmap)
                + M * N * x.element_size())},
            lambda: grouped_product_ref(x, w, counts, cap, wmap),
            lambda: x.new_empty((M, N)), x)
    _check_cuda("x", x, x.dtype)
    _check_cuda("w", w, x.dtype)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    c, c_ptr = _index(counts, x.device)
    m, m_ptr = _index(wmap, x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), c_ptr, m_ptr, out.data_ptr(), G, cap,
            K, N, E, *w.stride())
    if gm_variant(x.dtype, cap, K, N, w.stride(), _aligned(x, w)) == "tc":
        KERNEL.launch("gm_fwd_tc", *args, bwd=bwd, tc=True)
    else:
        KERNEL.launch("gm_fwd", *args, dtype_code(x.dtype), bwd=bwd)
    return out


def grouped_product_dw(x, g, counts, cap: int, num_experts: int,
                       gmap=None, *, out_dtype=torch.float32):
    """One K5 product: dw[e] = sum over batch rows b of x_{b,e}ᵀ g_{b,e},
    group (b, e) = b * E + gmap[e] (``gmap`` None: b * E + e), dead rows as
    zero.  x: [G * cap, K], g: [G * cap, N] -> [E, K, N] in ``out_dtype``,
    rounded once from the fp32 sum."""
    E = num_experts
    K, N = x.shape[1], g.shape[1]
    M, G = _shapes(x, cap, E)
    if g.shape[0] != M:
        raise ValueError(f"g {tuple(g.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        return accounting.plain(
            lambda: {"K5": (2.0 * M * K * N,
                            accounting.nbytes(x, g, counts, gmap)
                            + E * K * N * out_dtype.itemsize)},
            lambda: grouped_product_dw_ref(x, g, counts, cap, E, gmap,
                                           out_dtype),
            lambda: x.new_empty((E, K, N), dtype=out_dtype), x)
    _check_cuda("x", x, x.dtype)
    _check_cuda("g", g, x.dtype)
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("x and g must be contiguous")
    c, c_ptr = _index(counts, x.device)
    m, m_ptr = _index(gmap, x.device)
    dw = torch.empty((E, K, N), dtype=out_dtype, device=x.device)
    args = (x.data_ptr(), g.data_ptr(), c_ptr, m_ptr, dw.data_ptr(), G, cap,
            K, N, E)
    if gm_variant(x.dtype, cap, K, N, aligned=_aligned(x, g)) == "tc":
        KERNEL_DW.launch("gm_dw_tc", *args, dtype_code(out_dtype), bwd=True,
                         tc=True)
    else:
        KERNEL_DW.launch("gm_dw", *args, dtype_code(x.dtype),
                         dtype_code(out_dtype), bwd=True)
    return dw


def placement_maps(expert_map):
    """(wmap, gmap) int32 from ``expert_map`` [E] (logical expert ->
    physical group, any numeric dtype): wmap[p] is the logical expert of
    physical group p (K4's weight index), gmap[e] the physical group of
    logical expert e (K5's group index).  None -> (None, None): identity."""
    if expert_map is None:
        return None, None
    gmap = expert_map.to(torch.int32)
    wmap = torch.empty_like(gmap).scatter_(
        0, gmap.long(), torch.arange(gmap.shape[0], dtype=torch.int32,
                                     device=gmap.device))
    return wmap, gmap


class _GroupedMatmul(torch.autograd.Function):
    """K4 forward; dx as K4 on the transposed weights and dw as K5 (the
    reference's ``_gm_flat``)."""

    @staticmethod
    def forward(ctx, x, w, counts, cap, wmap, gmap):
        ctx.save_for_backward(x, w, counts, wmap, gmap)
        ctx.cap = cap
        return grouped_product(x, w, counts, cap, wmap)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.grouped_matmul.backward import (
            grouped_matmul_bwd)
        x, w, counts, wmap, gmap = ctx.saved_tensors
        dx, dw = grouped_matmul_bwd(
            x, w, counts, g, cap=ctx.cap, wmap=wmap, gmap=gmap,
            need_dx=ctx.needs_input_grad[0],
            need_dw=ctx.needs_input_grad[1])
        return dx, dw, None, None, None, None


def grouped_matmul(x, w, counts, *, expert_map=None, bm: int = 8):
    """Ragged grouped matmul: x [G, cap, K] (G groups of up to
    ``counts[g]`` live rows each), w [E, K, N] with G % E == 0, counts [G]
    int.  Group g (= batch row b, physical group p) uses the weights of the
    logical expert placed on p by ``expert_map`` ([E], logical -> physical;
    None: identity, ``w[g % E]``).  Returns [G, cap, N]; rows past each
    group's count are zero.  Differentiable in x and w; empty groups skip
    all tile work in forward and backward."""
    G, cap, K = x.shape
    E = w.shape[0]
    if G % E:
        raise ValueError(f"{G} groups are not a multiple of {E} experts")
    counts = counts.to(device=x.device, dtype=torch.int32)
    cap_g = cap + (-cap) % bm
    live = torch.arange(cap, device=x.device)[None, :] < counts[:, None]
    x = x * live[..., None].to(x.dtype)
    if cap_g != cap:
        x = F.pad(x, (0, 0, 0, cap_g - cap))
    wmap, gmap = placement_maps(expert_map)
    out = _GroupedMatmul.apply(x.reshape(G * cap_g, K), w, counts, cap_g,
                               wmap, gmap)
    return out.reshape(G, cap_g, -1)[:, :cap]
