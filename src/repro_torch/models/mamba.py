"""Mamba2 (SSD) block internals — a port of ``repro.models.mamba``: the
chunked parallel form for train / prefill, the O(1) recurrent form for
decode.  Single group (G=1), expand factor 2.

The parallel form is the minimal-SSD decomposition: an intra-chunk
quadratic, attention-like term plus an inter-chunk state recurrence.  The
reference's inter-chunk ``lax.scan`` is a Python loop over the chunks here.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., L] -> [..., L, L] lower-tri cumulative sums: out[i, j] =
    sum_{k=j+1..i} x[k] for i >= j, -inf above the diagonal (masked with a
    select before any ``exp``, so no gradient meets an infinity)."""
    L = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    out = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, torch.full_like(out, float("-inf")))


def ssd_chunked(x, dt, A_log, B, C, D, *, chunk: int = 128,
                init_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: [b, s, nh, dh]; dt: [b, s, nh] (softplus-ed); A_log: [nh];
    B, C: [b, s, state]; D: [nh].  Returns (y [b, s, nh, dh] in x's dtype,
    final_state [b, nh, dh, state] float32)."""
    b, s, nh, dh = x.shape
    st = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    A = -torch.exp(A_log.float())                               # [nh] < 0

    xc = x.reshape(b, nc, chunk, nh, dh)
    dtc = dt.reshape(b, nc, chunk, nh).float()
    Bc = B.reshape(b, nc, chunk, st).float()
    Cc = C.reshape(b, nc, chunk, st).float()
    dA_t = (dtc * A).transpose(2, 3)                            # [b,nc,nh,cl]

    # intra-chunk (diagonal blocks): attention-like with a decay mask
    Lmat = torch.exp(_segsum(dA_t))                             # [b,nc,nh,cl,cl]
    scores = torch.einsum("bcls,bcms->bclm", Cc, Bc)            # [b,nc,cl,cl]
    gated = scores[:, :, None] * Lmat                           # [b,nc,nh,cl,cl]
    xdt = xc.float() * dtc[..., None]                           # [b,nc,cl,nh,dh]
    y_diag = torch.einsum("bchlm,bcmhd->bclhd", gated, xdt)

    # chunk-final states: S_c = sum_t exp(sum_{t..end} dA) dt_t x_t B_t^T
    decay_to_end = torch.exp(
        torch.cumsum(dA_t.flip(-1), dim=-1).flip(-1) - dA_t)    # [b,nc,nh,cl]
    S_chunk = torch.einsum("bchl,bclhd,bcls->bchds",
                           decay_to_end, xdt, Bc)               # [b,nc,nh,dh,st]
    chunk_decay = torch.exp(dA_t.sum(-1))                       # [b,nc,nh]

    # inter-chunk recurrence over the chunks
    S = (torch.zeros((b, nh, dh, st), device=x.device) if init_state is None
         else init_state.float())
    S_in = []
    for c in range(nc):
        S_in.append(S)                                          # entering chunk c
        S = S * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    S_in = torch.stack(S_in, dim=1)                             # [b,nc,nh,dh,st]

    # the incoming state's contribution to each position
    decay_from_start = torch.exp(torch.cumsum(dA_t, dim=-1))    # [b,nc,nh,cl]
    y_off = torch.einsum("bcls,bchds,bchl->bclhd", Cc, S_in,
                         decay_from_start)

    y = y_diag + y_off + xc.float() * D.float()[None, None, None, :, None]
    y = y.reshape(b, nc * chunk, nh, dh)[:, :s]
    return y.to(x.dtype), S


def ssd_decode_step(x, dt, A_log, B, C, D, state):
    """One-token recurrent update.  x: [b, nh, dh]; dt: [b, nh];
    B, C: [b, state]; state: [b, nh, dh, st]."""
    A = -torch.exp(A_log.float())
    dA = torch.exp(dt.float() * A)                              # [b, nh]
    xdt = x.float() * dt.float()[..., None]
    state = (state * dA[..., None, None]
             + torch.einsum("bhd,bs->bhds", xdt, B.float()))
    y = torch.einsum("bs,bhds->bhd", C.float(), state)
    y = y + x.float() * D.float()[None, :, None]
    return y.to(x.dtype), state


def causal_conv(x, w, b, *, state=None):
    """Depthwise causal conv1d.  x: [b, s, c]; w: [k, c]; b: [c].  With
    ``state`` [b, k-1, c] it is the streaming update (decode).  Returns
    (silu(conv + b), the last k-1 inputs)."""
    k = w.shape[0]
    if state is not None:
        xin = torch.cat([state.to(x.dtype), x], dim=1)          # [b, k-1+s, c]
    else:
        xin = F.pad(x, (0, 0, k - 1, 0))
    new_state = xin[:, -(k - 1):]
    s = x.shape[1]
    out = xin[:, 0:s] * w[0][None, None]
    for i in range(1, k):
        out = out + xin[:, i:i + s] * w[i][None, None]
    return F.silu(out + b[None, None]), new_state
