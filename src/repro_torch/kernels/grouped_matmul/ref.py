"""Plain PyTorch versions of the grouped expert matmul (K4) and its weight
gradient (K5): the CPU path of ``ops`` and the oracle the CUDA kernels are
held against on the card.

Same semantics as the kernels: rows at or past a group's count are dead
(treated as zero whatever they hold), group g uses expert weight
``w[g % E]``, accumulation in float32."""
from __future__ import annotations

import torch


def _live(counts, cap: int, device) -> torch.Tensor:
    """[G, cap] bool: row r of group g is live iff r < counts[g]."""
    return (torch.arange(cap, device=device)[None, :]
            < counts.to(device)[:, None])


def grouped_matmul_ref(x, w, counts):
    """x: [G, cap, K], w: [E, K, N] (G % E == 0), counts: [G] ->
    [G, cap, N] in x's dtype (the reference's ``ref.grouped_matmul_ref``)."""
    G, cap, _ = x.shape
    E = w.shape[0]
    live = _live(counts, cap, x.device)
    xm = x * live[..., None].to(x.dtype)
    wg = w[torch.arange(G, device=w.device) % E]
    out = torch.einsum("gck,gkn->gcn", xm.float(), wg.float())
    return out.to(x.dtype)


def grouped_matmul_dw_ref(x, g, counts, num_experts: int):
    """dw[e] = sum over the groups b * E + e of x_gᵀ g_g, dead rows as zero.
    x: [G, cap, K], g: [G, cap, N], counts: [G] -> [E, K, N] float32."""
    G, cap, K = x.shape
    N = g.shape[-1]
    E = num_experts
    live = _live(counts, cap, x.device)[..., None]
    xm = torch.where(live, x.float(), 0.0).reshape(G // E, E, cap, K)
    gm = torch.where(live, g.float(), 0.0).reshape(G // E, E, cap, N)
    return torch.einsum("beck,becn->ekn", xm, gm)


def grouped_product_ref(x, w, counts, cap: int, wmap=None):
    """K4's flat layout: x [G * cap, K], w [E, K, N] (any view), group g
    uses ``w[wmap[g % E]]`` (``wmap`` None: ``w[g % E]``) -> [G * cap, N]."""
    G, K = x.shape[0] // cap, x.shape[1]
    we = w if wmap is None else w[wmap.long()]
    return grouped_matmul_ref(x.reshape(G, cap, K), we,
                              counts).reshape(G * cap, -1)


def grouped_product_dw_ref(x, g, counts, cap: int, num_experts: int,
                           gmap=None, out_dtype=torch.float32):
    """K5's flat layout: x [G * cap, K], g [G * cap, N]; expert e sums the
    groups b * E + gmap[e] (``gmap`` None: b * E + e) -> [E, K, N] in
    ``out_dtype``."""
    G = x.shape[0] // cap
    dw = grouped_matmul_dw_ref(x.reshape(G, cap, -1), g.reshape(G, cap, -1),
                               counts, num_experts)
    if gmap is not None:
        dw = dw[gmap.long()]
    return dw.to(out_dtype)
