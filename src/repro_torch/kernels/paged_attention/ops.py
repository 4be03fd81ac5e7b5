"""Paged decode attention: the CUDA kernel's wrapper.

``paged_attention`` keeps the ``decode_attention`` calling convention
(``q [b, 1, h, d]`` in, ``[b, 1, h, d]`` out) so ``blocks._attn_fwd`` can
swap it in behind ``kernel_impl="pallas"``.  On a CUDA tensor it launches
``csrc/paged_attention.cu``, which reads the page table and lengths itself;
on a CPU tensor it runs ``ref.paged_attention_fwd_ref``.
``paged_tile_work`` is the reference's host-side accounting, unchanged.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels._build import Kernel, dtype_code, require
from repro_torch.kernels.paged_attention.ref import paged_attention_fwd_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel(
    "paged_attention", "paged_attention/csrc/paged_attention.cu",
    replaces="src/repro/kernels/paged_attention/paged_attention.py:77",
    functions={"paged_attn_fwd": [_P] * 6 + [_I] * 6 + [_F, _I, _I, _P]})

_DTYPES = (torch.float32, torch.bfloat16)


def paged_attention_fwd(q, kp, vp, page_table, cache_len):
    """q: [b, n_q, hd]; kp/vp: [pool+1, page, n_kv, hd] (last block trash);
    page_table: [b, J] int32 (-1 unmapped); cache_len: [b] int32."""
    b, n_q, hd = q.shape
    _, page, n_kv, _ = kp.shape
    if n_q % n_kv:
        raise ValueError(f"n_q={n_q} not a multiple of n_kv={n_kv}")
    if kp.shape[3] != hd or vp.shape != kp.shape:
        raise ValueError(f"kp {tuple(kp.shape)} / vp {tuple(vp.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if not q.is_cuda:
        return paged_attention_fwd_ref(q, kp, vp, page_table, cache_len)
    q = q.contiguous()
    require(q, "q", _DTYPES, 3)
    require(kp, "kp", _DTYPES, 4)
    require(vp, "vp", (kp.dtype,), 4)
    pt = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    cl = cache_len.to(device=q.device, dtype=torch.int32).contiguous()
    if pt.shape[0] != b or cl.shape != (b,):
        raise ValueError(f"page_table {tuple(pt.shape)} / cache_len "
                         f"{tuple(cl.shape)} do not match {b} lanes")
    out = torch.empty_like(q)
    KERNEL.launch("paged_attn_fwd", q.data_ptr(), kp.data_ptr(),
                  vp.data_ptr(), pt.data_ptr(), cl.data_ptr(), out.data_ptr(),
                  b, n_q, n_kv, hd, page, pt.shape[1], math.sqrt(hd),
                  dtype_code(q.dtype), dtype_code(kp.dtype))
    return out


def paged_attention(q, kp, vp, page_table, cache_len):
    """q: ``[b, 1, h, d]``; kp/vp: ``[pool+1, page, n_kv, d]``; page_table:
    ``[b, J]`` (-1 unmapped); cache_len: scalar or ``[b]``."""
    b = q.shape[0]
    cl = torch.as_tensor(cache_len, dtype=torch.int32,
                         device=q.device).reshape(-1).expand(b)
    return paged_attention_fwd(q[:, 0], kp, vp, page_table, cl)[:, None]


def paged_tile_work(page_table, cache_len, page_size: int):
    """(live, total) kernel tiles for one decode call: a tile is live iff
    its page starts before the lane's ``cache_len`` AND is mapped."""
    pt = np.asarray(page_table)
    jtot = pt.shape[-1]
    pt2 = pt.reshape(-1, jtot)
    cl = np.broadcast_to(np.asarray(cache_len).reshape(-1),
                         (pt2.shape[0],))[:, None]
    j = np.arange(jtot)[None, :]
    live = (j * page_size < cl) & (pt2 >= 0)
    return int(live.sum()), int(pt2.shape[0] * jtot)
