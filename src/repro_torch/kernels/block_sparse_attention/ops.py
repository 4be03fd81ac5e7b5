"""Block-sparse flash attention: the CUDA kernels' wrappers and the
differentiable op built from them.

``block_sparse_attention_fwd`` (K1) takes the model layout (q [b, sq, hq,
d], k/v [b, sk, hkv, d]) and a [b|1, hq|1, nqb, nkb] block mask;
``block_sparse_attention_bwd`` runs the two backward sweeps, K2a (dq) and
K2b (dk, dv).  On CUDA tensors they launch ``csrc/block_sparse_attention.cu``
and ``csrc/block_sparse_attention_bwd.cu`` (GQA by index, ragged edges
bounds-checked in the kernels, a broadcast mask passed by stride — no
repeat, pad or copy); on CPU tensors they run the plain versions in
``ref.py``.  ``block_sparse_attention`` is differentiable: its autograd
Function saves (q, k, v, out, lse), computes ``delta = rowsum(dout ⊙ out)``
in torch and hands the rest to the backward sweeps, as the reference's
``_bsa_flat`` custom VJP does.  ``attention_tile_work`` is the reference's
tile accounting, unchanged.

All three run on the TF32 tensor cores at fp32 accuracy (3xTF32
``mma.sync``, ``kernels/tf32x3.cuh``; one pass for bf16 operands), for every
head dim the kernels take (16, 32, 64, 128) and both dtypes, so every launch
counts as a tensor-core launch (``launch(..., tc=True)``).  K1 and K2a run
one block per (q head, batch, 64-row q tile) over the live kv tiles.  K2b
runs over a work schedule that ``dkv_schedule`` computes from the shapes
and causality alone (never from the mask's values, so nothing is copied
from the device): each item is a run of (q head of the GQA group, q tile)
steps of one kv tile, the items near-equal in steps and run longest first.
Each item writes fp32 partial dk / dv into a scratch buffer the wrapper
allocates; a second kernel of the same launch sums each kv tile's partials
in a fixed order.  fp32 operands are read with 16-byte ``cp.async``
copies, so their data must be 16-byte aligned (a wrapper raises if not).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import accounting
from repro_torch.kernels._build import Kernel, dtype_code, require
from repro_torch.kernels.block_sparse_attention.ref import (
    block_sparse_attention_bwd_ref, block_sparse_attention_ref)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_TAIL = [_I] * 8 + [_L] * 2 + [_I, _F, _I, _P]
_SRC = "src/repro/kernels/block_sparse_attention/"
# K2a / K2b's source builds as this many translation units (its sweeps'
# (dtype, head dim) variants split by compile time): as one unit it was
# the build's slowest compile
BWD_UNITS = 5
KERNEL = Kernel(
    "block_sparse_attention",
    "block_sparse_attention/csrc/block_sparse_attention.cu",
    replaces=_SRC + "block_sparse_attention.py:143",
    functions={"bsa_fwd": [_P] * 6 + _TAIL})
KERNEL_DQ = Kernel(
    "block_sparse_attention_bwd_dq",
    "block_sparse_attention/csrc/block_sparse_attention_bwd.cu",
    replaces=_SRC + "backward.py:144",
    functions={"bsa_bwd_dq": [_P] * 8 + _TAIL}, units=BWD_UNITS)
KERNEL_DKV = Kernel(
    "block_sparse_attention_bwd_dkv",
    "block_sparse_attention/csrc/block_sparse_attention_bwd.cu",
    replaces=_SRC + "backward.py:164",
    functions={"bsa_bwd_dkv": [_P] * 13 + [_I] + _TAIL}, units=BWD_UNITS)

_DTYPES = (torch.float32, torch.bfloat16)

# K2b's tiles (bsa_dkv_tc_kernel's BQ, BK) and how finely its schedule cuts
# the work: about 8 items per SM of an H100 (132 SMs, 2 blocks each: four
# waves), so that no SM waits long on the last wave
DKV_TILE = 64
DKV_ITEMS_PER_SM, DKV_SMS = 8, 132


class DkvSchedule(NamedTuple):
    """K2b's work items and where their partials go.

    ``items`` int32 [n, 4]: (kv tile id, first step, end step, slot),
    longest first; kv tile id = (batch * hkv + kv head) * n_kv_tiles + kv
    tile, and step s of a kv tile is (q head of the group s // nq, q tile
    qt0 + s % nq), where q tiles before qt0 lie wholly above the causal
    diagonal.  ``offsets`` int32 [tiles + 1]: the slots of kv tile i are
    offsets[i] .. offsets[i + 1] - 1, in step order.  Both arrays are
    read-only: the schedule is cached and shared."""
    items: np.ndarray
    offsets: np.ndarray


def dkv_tile_steps(sq: int, sk: int, rep: int, causal: bool):
    """[(kv tile, first live q tile qt0, steps)] for every kv tile: the
    group's ``rep`` q heads times the q tiles that reach the kv tile."""
    n_qt, n_kt = -(-sq // DKV_TILE), -(-sk // DKV_TILE)
    out = []
    for kt in range(n_kt):
        qt0 = min(kt, n_qt) if causal else 0     # BQ == BK
        out.append((kt, qt0, rep * (n_qt - qt0)))
    return out


@functools.lru_cache(maxsize=64)
def dkv_schedule(b: int, sq: int, sk: int, hq: int, hkv: int,
                 causal: bool) -> DkvSchedule:
    """Cut K2b's work into near-equal items (the module docstring): each kv
    tile's steps are split into ceil(steps / T) runs as equal as possible,
    T chosen so that the whole has about DKV_ITEMS_PER_SM items per SM."""
    per_tile = dkv_tile_steps(sq, sk, hq // hkv, causal)
    n_tiles = b * hkv * len(per_tile)
    total = b * hkv * sum(n for _, _, n in per_tile)
    T = max(1, -(-total // (DKV_ITEMS_PER_SM * DKV_SMS)))
    items, offsets, slot = [], [0], 0
    for tile in range(n_tiles):
        steps = per_tile[tile % len(per_tile)][2]
        parts = -(-steps // T)
        s0 = 0
        for p in range(parts):
            n = steps // parts + (p < steps % parts)
            items.append((tile, s0, s0 + n, slot))
            s0, slot = s0 + n, slot + 1
        offsets.append(slot)
    items.sort(key=lambda it: (it[1] - it[2], it[0], it[1]))
    arrays = (np.asarray(items, np.int32).reshape(-1, 4),
              np.asarray(offsets, np.int32))
    for a in arrays:
        a.setflags(write=False)
    return DkvSchedule(*arrays)


@functools.lru_cache(maxsize=64)
def _dkv_schedule_on(device, *shape):
    """The schedule's int32 tensors on ``device`` (copied there once)."""
    sch = dkv_schedule(*shape)
    return (torch.tensor(sch.items, device=device),
            torch.tensor(sch.offsets, device=device), sch.items.shape[0],
            int(sch.offsets[-1]))


def _check_shapes(q, k, v, block_mask, block):
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    nqb, nkb = -(-sq // block), -(-sk // block)
    if block_mask.shape[-2:] != (nqb, nkb) or block_mask.dim() != 4:
        raise ValueError(f"block_mask {tuple(block_mask.shape)} does not "
                         f"tile [{nqb}, {nkb}] blocks of {block}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if k.shape != (b, sk, hkv, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    return nkb


def _check_operands(named, dtype):
    """Device, dtype, rank and contiguity of each operand, one dtype for
    all, and the 16-byte alignment the fp32 tile loads need."""
    for name, t in named:
        require(t, name, _DTYPES, 4)
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {dtype}")
        if t.dtype == torch.float32 and t.data_ptr() % 16:
            raise ValueError(f"{name}: fp32 data must be 16-byte aligned")


def _device_mask(block_mask, q):
    """int32 mask on q's device with its batch / head strides (0 where the
    mask broadcasts)."""
    b, hq = q.shape[0], q.shape[2]
    nkb = block_mask.shape[-1]
    mask = block_mask.to(device=q.device, dtype=torch.int32)
    if mask.shape[0] not in (1, b) or mask.shape[1] not in (1, hq):
        raise ValueError(f"block_mask {tuple(mask.shape)} does not "
                         f"broadcast to [{b}, {hq}, ...]")
    if mask.stride(-1) != 1 or mask.stride(-2) != nkb:
        mask = mask.contiguous()
    msb = mask.stride(0) if mask.shape[0] > 1 else 0
    msh = mask.stride(1) if mask.shape[1] > 1 else 0
    return mask, msb, msh


def _dims(q, k, block, nkb):
    b, sq, hq, d = q.shape
    return [b, sq, k.shape[1], hq, k.shape[2], d, block, nkb]


def block_sparse_attention_fwd(q, k, v, block_mask, *, causal: bool = True,
                               block: int = 128):
    """Returns (out [b, sq, hq, d] in q.dtype, lse [b, hq, sq] float32)."""
    nkb = _check_shapes(q, k, v, block_mask, block)
    if not q.is_cuda:
        b, sq, hq = q.shape[:3]
        return accounting.plain(
            lambda: {"K1": (attention_flops(q, block_mask, causal, block, 2),
                            accounting.nbytes(q, k, v, block_mask, q)
                            + 4.0 * b * hq * sq)},
            lambda: block_sparse_attention_ref(q, k, v, block_mask,
                                               causal=causal, block=block),
            lambda: (torch.empty_like(q),
                     q.new_empty((b, hq, sq), dtype=torch.float32)), q)
    _check_operands((("q", q), ("k", k), ("v", v)), q.dtype)
    mask, msb, msh = _device_mask(block_mask, q)
    b, sq, hq = q.shape[:3]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    KERNEL.launch("bsa_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  *_dims(q, k, block, nkb), msb, msh, int(causal),
                  1.0 / math.sqrt(q.shape[-1]), dtype_code(q.dtype), tc=True)
    return out, lse


def _bwd_prep(q, k, v, block_mask, dout, lse, delta, block):
    """Checks shared by both sweeps; returns (dout, mask, msb, msh, nkb)."""
    nkb = _check_shapes(q, k, v, block_mask, block)
    dout = dout.to(q.dtype).contiguous()
    _check_operands((("q", q), ("k", k), ("v", v), ("dout", dout)), q.dtype)
    b, sq, hq = q.shape[:3]
    for name, t in (("lse", lse), ("delta", delta)):
        require(t, name, (torch.float32,), 3)
        if t.shape != (b, hq, sq):
            raise ValueError(f"{name} {tuple(t.shape)} != {(b, hq, sq)}")
    mask, msb, msh = _device_mask(block_mask, q)
    return dout, mask, msb, msh, nkb


def _sweep(kernel, symbol, outs, extra, q, k, v, block_mask, dout, lse,
           delta, causal, block):
    dout, mask, msb, msh, nkb = _bwd_prep(q, k, v, block_mask, dout, lse,
                                          delta, block)
    if q.shape[1] == 0:
        return outs
    kernel.launch(symbol, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  mask.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), *(t.data_ptr() for t in outs), *extra,
                  *_dims(q, k, block, nkb), msb, msh, int(causal),
                  1.0 / math.sqrt(q.shape[-1]), dtype_code(q.dtype),
                  tc=True)
    return outs


def block_sparse_attention_bwd_dq(q, k, v, block_mask, dout, lse, delta, *,
                                  causal: bool = True, block: int = 128):
    """K2a, the dq sweep (CUDA tensors only)."""
    return _sweep(KERNEL_DQ, "bsa_bwd_dq", (torch.empty_like(q),), (), q, k,
                  v, block_mask, dout, lse, delta, causal, block)[0]


def block_sparse_attention_bwd_dkv(q, k, v, block_mask, dout, lse, delta, *,
                                   causal: bool = True, block: int = 128):
    """K2b, the dk / dv sweep (CUDA tensors only): one launch of the
    tensor-core item kernel and its fixed-order sum over ``dkv_schedule``;
    the fp32 partials live in scratch allocated here."""
    b, sq, hq, d = q.shape
    if sq == 0:
        return torch.zeros_like(k), torch.zeros_like(v)
    items, offsets, n_items, slots = _dkv_schedule_on(
        q.device, b, sq, k.shape[1], hq, k.shape[2], bool(causal))
    part = torch.empty((2, max(slots, 1), DKV_TILE, d), dtype=torch.float32,
                       device=q.device)
    extra = (items.data_ptr(), offsets.data_ptr(), part[0].data_ptr(),
             part[1].data_ptr(), n_items)
    return _sweep(KERNEL_DKV, "bsa_bwd_dkv",
                  (torch.empty_like(k), torch.empty_like(v)), extra, q, k,
                  v, block_mask, dout, lse, delta, causal, block)


def block_sparse_attention_bwd(q, k, v, block_mask, dout, lse, delta, *,
                               causal: bool = True, block: int = 128):
    """The flash backward: (dq, dk, dv) in the input dtypes from the
    forward's inputs, its lse, ``dout`` and ``delta = rowsum(dout ⊙ out)``
    ([b, hq, sq] float32).  On CUDA: K2a then K2b."""
    if not q.is_cuda:
        _check_shapes(q, k, v, block_mask, block)
        read = accounting.nbytes(q, k, v, block_mask, dout, lse, delta)
        return accounting.plain(
            lambda: {"K2a": (attention_flops(q, block_mask, causal, block, 3),
                             read + accounting.nbytes(q)),
                     "K2b": (attention_flops(q, block_mask, causal, block, 4),
                             read + accounting.nbytes(k, v))},
            lambda: block_sparse_attention_bwd_ref(
                q, k, v, block_mask, dout.to(q.dtype), lse, delta,
                causal=causal, block=block),
            lambda: (torch.empty_like(q), torch.empty_like(k),
                     torch.empty_like(v)), q)
    kw = dict(causal=causal, block=block)
    dq = block_sparse_attention_bwd_dq(q, k, v, block_mask, dout, lse,
                                       delta, **kw)
    dk, dv = block_sparse_attention_bwd_dkv(q, k, v, block_mask, dout, lse,
                                            delta, **kw)
    return dq, dk, dv


class _BlockSparseAttention(torch.autograd.Function):
    """K1 forward; K2a + K2b backward (the reference's ``_bsa_flat``)."""

    @staticmethod
    def forward(ctx, q, k, v, block_mask, causal, block):
        out, lse = block_sparse_attention_fwd(q, k, v, block_mask,
                                              causal=causal, block=block)
        ctx.save_for_backward(q, k, v, block_mask, out, lse)
        ctx.causal, ctx.block = causal, block
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, block_mask, out, lse = ctx.saved_tensors
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        dq, dk, dv = block_sparse_attention_bwd(
            q, k, v, block_mask, dout, lse, delta.contiguous(),
            causal=ctx.causal, block=ctx.block)
        return dq, dk, dv, None, None, None


def block_sparse_attention(q, k, v, block_mask, *, causal: bool = True,
                           block: int = 128):
    """Attention output only ([b, sq, hq, d]); differentiable in q, k, v
    through the flash backward (K2a / K2b on the card)."""
    return _BlockSparseAttention.apply(q, k, v, block_mask, causal, block)


def attention_flops(q, block_mask, causal: bool, block: int,
                    products: int) -> float:
    """FLOPs of ``products`` block x block x d products on each tile the
    kernels visit (``attention_tile_work``'s forward count, over every
    (batch, head) pair).  A mask on the ``meta`` device has no values and
    counts as dense (every causally reachable tile)."""
    b, _, hq, d = q.shape
    mask = (np.ones(tuple(block_mask.shape)) if block_mask.is_meta
            else block_mask.cpu())
    bm = np.broadcast_to(np.asarray(mask), (b, hq) + tuple(mask.shape[-2:]))
    tiles = attention_tile_work(bm, causal=causal, block_q=block,
                                block_k=block)["fwd_active"] * b * hq
    return float(products * 2 * tiles * block * block * d)


def attention_tile_work(block_mask, *, causal: bool = True,
                        block_q: int = 128, block_k: int = 128):
    """MXU tile-work accounting using the kernels' own gating predicates.

    block_mask: [..., nqb, nkb] (0/1).  Returns a dict with mean active and
    total (q-block × kv-block) tile counts per head for the forward and the
    backward (dq sweep + dk/dv sweep — each revisits the active tiles once).

    This is ACCOUNTING, not instrumentation: it recomputes the same
    (mask & causal-reachable) predicate the kernels gate on, so by
    construction bwd_ratio == fwd_ratio.
    """
    m = np.asarray(block_mask) > 0
    nqb, nkb = m.shape[-2], m.shape[-1]
    if causal:
        qi = np.arange(nqb)[:, None] * block_q + (block_q - 1)
        ki = np.arange(nkb)[None, :] * block_k
        reachable = ki <= qi
        m = m & reachable
        total = int(reachable.sum())
    else:
        total = nqb * nkb
    lead = int(np.prod(m.shape[:-2])) or 1
    active = float(m.sum()) / lead
    return {
        "fwd_active": active, "fwd_total": total,
        "bwd_active": 2.0 * active, "bwd_total": 2 * total,
    }
