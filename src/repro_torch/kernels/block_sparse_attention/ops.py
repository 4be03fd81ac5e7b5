"""Block-sparse flash attention forward: the CUDA kernel's wrapper.

``block_sparse_attention_fwd`` takes the model layout (q [b, sq, hq, d],
k/v [b, sk, hkv, d]) and a [b|1, hq|1, nqb, nkb] block mask.  On a CUDA
tensor it launches ``csrc/block_sparse_attention.cu`` (GQA by index, ragged
edges bounds-checked in the kernel, a broadcast mask passed by stride — no
repeat, pad or copy); on a CPU tensor it runs the plain version in
``ref.py``.  ``attention_tile_work`` is the reference's tile accounting,
unchanged.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels._build import Kernel, dtype_code, require
from repro_torch.kernels.block_sparse_attention.ref import (
    block_sparse_attention_ref)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
KERNEL = Kernel(
    "block_sparse_attention",
    "block_sparse_attention/csrc/block_sparse_attention.cu",
    replaces="src/repro/kernels/block_sparse_attention/"
             "block_sparse_attention.py:120",
    functions={"bsa_fwd": [_P] * 6 + [_I] * 8 + [_L] * 2 + [_I, _F, _I, _P]})

_DTYPES = (torch.float32, torch.bfloat16)


def block_sparse_attention_fwd(q, k, v, block_mask, *, causal: bool = True,
                               block: int = 128):
    """Returns (out [b, sq, hq, d] in q.dtype, lse [b, hq, sq] float32)."""
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
    if not q.is_cuda:
        return block_sparse_attention_ref(q, k, v, block_mask, causal=causal,
                                          block=block)
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t, name, _DTYPES, 4)
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    mask = block_mask.to(device=q.device, dtype=torch.int32)
    if mask.shape[0] not in (1, b) or mask.shape[1] not in (1, hq):
        raise ValueError(f"block_mask {tuple(mask.shape)} does not "
                         f"broadcast to [{b}, {hq}, ...]")
    if mask.stride(-1) != 1 or mask.stride(-2) != nkb:
        mask = mask.contiguous()
    msb = mask.stride(0) if mask.shape[0] > 1 else 0
    msh = mask.stride(1) if mask.shape[1] > 1 else 0
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    KERNEL.launch("bsa_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  mask.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, sk,
                  hq, hkv, d, block, nkb, msb, msh, int(causal),
                  1.0 / math.sqrt(d), dtype_code(q.dtype))
    return out, lse


def block_sparse_attention(q, k, v, block_mask, *, causal: bool = True,
                           block: int = 128):
    """Attention output only ([b, sq, hq, d]); see the ``_fwd`` variant."""
    return block_sparse_attention_fwd(q, k, v, block_mask, causal=causal,
                                      block=block)[0]


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
