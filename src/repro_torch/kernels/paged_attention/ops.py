"""Paged decode attention: the CUDA kernel's wrapper.

``paged_attention`` keeps the ``decode_attention`` calling convention
(``q [b, 1, h, d]`` in, ``[b, 1, h, d]`` out) so ``blocks._attn_fwd`` can
swap it in behind ``kernel_impl="pallas"``.  On a CUDA tensor it launches
``csrc/paged_attention.cu``, which reads the page table and lengths itself
and cuts each lane's live pages into ``pa_splits`` ranges, one block each,
merged in a fixed order inside the same launch; on a CPU tensor it runs
``ref.paged_attention_fwd_ref``.  ``paged_tile_work`` is the reference's
host-side accounting, unchanged.

K6 launches must not overlap: the split counters are one buffer per device,
shared by every launch, so two K6 launches in flight at once (on two streams,
or a graph replayed beside an eager call on another stream) would mix their
counts and could merge splits that have not finished.  Every K6 call of the
port runs on the current stream, one after another.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, List

import numpy as np
import torch

from repro_torch.kernels._build import Kernel, dtype_code, require
from repro_torch.kernels.paged_attention.ref import paged_attention_fwd_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel(
    "paged_attention", "paged_attention/csrc/paged_attention.cu",
    replaces="src/repro/kernels/paged_attention/paged_attention.py:77",
    functions={"paged_attn_fwd": [_P] * 8 + [_I] * 7 + [_F, _I, _I, _P]})

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (16, 32, 64, 128)
SMS = 132                 # streaming multiprocessors of an H100 SXM
# per device: the kernel's split counters (int32, 0 between launches; the
# last block of each (lane, head chunk) resets its own).  A buffer is only
# ever grown, never freed, so a captured CUDA graph keeps valid pointers.
# Shared by every launch on the device: K6 launches must run one at a time.
_COUNTERS: Dict[int, List[torch.Tensor]] = {}


def pa_splits(b: int, n_kv: int, J: int, page: int) -> int:
    """How many blocks each lane's live pages are cut into, from the static
    shapes alone: about 1.5 blocks of (kv head, lane, split) an SM on the
    132 SMs (10 splits, 200 blocks at the serve's b 4, n_kv 5), each split
    at least 2 pages and 32 tokens long (J pages a lane at most), and 1
    when the lanes alone fill the card.  Fewer splits leave SMs idle, more
    add blocks whose fixed cost (page table, merge, combine) outweighs
    their share of the pages (``chip_smoke.py --k6-time .`` sweeps it)."""
    min_pages = max(2, -(-32 // page))
    want = -(-3 * SMS // (2 * max(1, b * n_kv)))
    return max(1, min(want, J // min_pages))


def pa_blocks(b: int, n_q: int, n_kv: int, splits: int) -> int:
    """The kernel's grid: one block per (kv head, head chunk, lane, split),
    a head chunk being the group's G = n_q / n_kv q heads when G <= 4 and
    up to 8 of them otherwise."""
    G = n_q // n_kv
    return b * n_kv * -(-G // (G if G <= 4 else 8)) * splits


def _counters(device: torch.device, n: int) -> torch.Tensor:
    bufs = _COUNTERS.setdefault(device.index, [])
    if not bufs or bufs[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_attention_fwd: call it once at this shape before "
                "capturing a CUDA graph (its split counters must exist "
                "first)")
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32,
                                device=device))
    return bufs[-1]


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
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {_HEAD_DIMS}")
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("kp / vp must be 16-byte aligned: the kernel reads "
                         "them with 16-byte cp.async copies")
    pt = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    cl = cache_len.to(device=q.device, dtype=torch.int32).contiguous()
    if pt.shape[0] != b or cl.shape != (b,):
        raise ValueError(f"page_table {tuple(pt.shape)} / cache_len "
                         f"{tuple(cl.shape)} do not match {b} lanes")
    J = pt.shape[1]
    splits = pa_splits(b, n_kv, J, page)
    out = torch.empty_like(q)
    ws = cnt = None
    if splits > 1:
        ws = torch.empty(b * n_q * splits * (hd + 2), dtype=torch.float32,
                         device=q.device)
        cnt = _counters(q.device, pa_blocks(b, n_q, n_kv, 1))
    KERNEL.launch("paged_attn_fwd", q.data_ptr(), kp.data_ptr(),
                  vp.data_ptr(), pt.data_ptr(), cl.data_ptr(), out.data_ptr(),
                  None if ws is None else ws.data_ptr(),
                  None if cnt is None else cnt.data_ptr(),
                  b, n_q, n_kv, hd, page, J, splits, math.sqrt(hd),
                  dtype_code(q.dtype), dtype_code(kp.dtype), split=splits > 1)
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
