"""xLSTM block internals — a port of ``repro.models.xlstm``: the mLSTM
(parallel, attention-like with exponential gating; chunked with a running
state; one-token recurrent) and the sLSTM (a recurrent scan with stabilized
exponential gates).  The reference's ``lax.scan`` loops are Python loops
over chunks (mLSTM) and over time steps (sLSTM) here.

One change of arithmetic, not of function: the mLSTM's normalizer
``h / (max(|n·q|, exp(-m)) + 1e-6)`` is computed by ``_normalize`` as ``h``
times the smaller reciprocal, with ``exp(-m)`` entering as ``exp(-|m|)``.
At published widths the input gate's pre-activations reach -100, so the
reference's ``exp(-m)`` overflows to inf: its quotient is 0 there, as here,
but its gradient is NaN (0 · inf), which ends training at the first step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _tril(n: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((n, n), dtype=torch.bool, device=device))


def _normalize(h, denom, m):
    """``h / (max(|denom|, exp(-m)) + 1e-6)`` (h: [..., dh]; denom, m:
    [...]) as ``h`` times ``min(1 / (|denom| + 1e-6), 1 / (exp(-m) +
    1e-6))``, the second reciprocal from ``e = exp(-|m|)`` (``1 / (e +
    1e-6)`` for m >= 0, ``e / (1 + 1e-6 e)`` below): the same value up to
    rounding, and neither it nor its gradient meets an infinity."""
    e = torch.exp(-m.abs())
    inv_b = torch.where(m >= 0, 1.0 / (e + 1e-6), e / (1.0 + 1e-6 * e))
    inv_a = 1.0 / (denom.abs() + 1e-6)
    return h * torch.minimum(inv_a, inv_b)[..., None]


def mlstm_parallel(q, k, v, ig, fg):
    """Stabilized parallel mLSTM.

    q, k, v: [b, s, nh, dh]; ig, fg: [b, s, nh] pre-activation gates.
    Returns h: [b, s, nh, dh] in q's dtype."""
    b, s, nh, dh = q.shape
    logf = F.logsigmoid(fg.float())                             # [b,s,nh]
    logf_cum = torch.cumsum(logf, dim=1)
    # D[t, s'] = logf_cum[t] - logf_cum[s'] + ig[s']   for s' <= t
    D = (logf_cum[:, :, None, :] - logf_cum[:, None, :, :]
         + ig.float()[:, None, :, :])                           # [b,t,s',nh]
    mask = _tril(s, q.device)[None, :, :, None]
    D = torch.where(mask, D, torch.full_like(D, float("-inf")))
    m = D.amax(dim=2, keepdim=True)                             # [b,t,1,nh]
    Dp = torch.exp(D - m)
    scores = torch.einsum("bthd,bshd->btsh", q.float(),
                          k.float()) / math.sqrt(dh)
    w = scores * Dp
    h = torch.einsum("btsh,bshd->bthd", w, v.float())
    return _normalize(h, w.sum(dim=2), m[:, :, 0]).to(q.dtype)


def mlstm_chunked(q, k, v, ig, fg, *, chunk: int = 256):
    """Memory-sane mLSTM: queries in chunks with a running state.  The same
    math as ``mlstm_parallel`` (used for long sequences)."""
    b, s, nh, dh = q.shape
    pad = (-s) % chunk
    if pad:
        def zf(a):
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        q, k, v, ig, fg = map(zf, (q, k, v, ig, fg))
    nc = q.shape[1] // chunk
    dev = q.device
    C = torch.zeros((b, nh, dh, dh), device=dev)
    n = torch.zeros((b, nh, dh), device=dev)
    m_run = torch.full((b, nh), float("-inf"), device=dev)
    f_run = torch.zeros((b, nh), device=dev)
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        h, C, n, m_run, f_run = _mlstm_chunk_step(
            q[:, sl], k[:, sl], v[:, sl], ig[:, sl], fg[:, sl], C, n, m_run,
            f_run)
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :s].to(q.dtype)


def _mlstm_chunk_step(q, k, v, ig, fg, C, n, m_run, f_run):
    """One chunk with incoming state (C, n) at stabilizer m_run; f_run is
    the cumulative log-forget up to the chunk start."""
    b, L, nh, dh = q.shape
    logf = F.logsigmoid(fg.float())
    lc = torch.cumsum(logf, dim=1)                              # [b,L,nh]
    igf = ig.float()
    # intra-chunk decay matrix
    D = lc[:, :, None, :] - lc[:, None, :, :] + igf[:, None, :, :]
    mask = _tril(L, q.device)[None, :, :, None]
    D = torch.where(mask, D, torch.full_like(D, float("-inf")))
    # inter contribution decay for each position t: lc[t] (+ the state's
    # stabilizer)
    m_intra = D.amax(dim=2)                                     # [b,L,nh]
    m_inter = lc + m_run[:, None, :]                            # [b,L,nh]
    m_new = torch.maximum(m_intra, m_inter)
    Dp = torch.exp(D - m_new[:, :, None, :])
    scores = torch.einsum("bthd,bshd->btsh", q.float(),
                          k.float()) / math.sqrt(dh)
    w = scores * Dp
    h_intra = torch.einsum("btsh,bshd->bthd", w, v.float())
    denom_intra = w.sum(dim=2)                                  # [b,t,nh]
    inter_scale = torch.exp(m_inter - m_new)                    # [b,t,nh]
    qf = q.float() / math.sqrt(dh)
    h_inter = torch.einsum("bthd,bhde->bthe", qf, C) * inter_scale[..., None]
    denom_inter = torch.einsum("bthd,bhd->bth", qf, n) * inter_scale
    h = _normalize(h_intra + h_inter, denom_intra + denom_inter, m_new)
    # the running state at the end of the chunk
    lc_end = lc[:, -1]                                          # [b,nh]
    m_state_new = torch.maximum(
        m_run + lc_end, (igf + lc_end[:, None] - lc).amax(dim=1))
    decay_state = torch.exp(m_run + lc_end - m_state_new)
    kv_decay = torch.exp(igf + lc_end[:, None] - lc - m_state_new[:, None])
    C = (C * decay_state[..., None, None]
         + torch.einsum("bsh,bshd,bshe->bhde", kv_decay, k.float(),
                        v.float()))
    n = (n * decay_state[..., None]
         + torch.einsum("bsh,bshd->bhd", kv_decay, k.float()))
    return h.to(q.dtype), C, n, m_state_new, f_run + lc_end


def mlstm_decode_step(q, k, v, ig, fg, C, n, m):
    """One-token recurrent mLSTM.  q, k, v: [b, nh, dh]; ig, fg: [b, nh];
    state C: [b, nh, dh, dh], n: [b, nh, dh], m: [b, nh]."""
    logf = F.logsigmoid(fg.float())
    igf = ig.float()
    m_new = torch.maximum(logf + m, igf)
    fdec = torch.exp(logf + m - m_new)
    idec = torch.exp(igf - m_new)
    C = (C * fdec[..., None, None]
         + idec[..., None, None]
         * torch.einsum("bhd,bhe->bhde", k.float(), v.float()))
    n = n * fdec[..., None] + idec[..., None] * k.float()
    qf = q.float() / math.sqrt(q.shape[-1])
    h = torch.einsum("bhd,bhde->bhe", qf, C)
    h = _normalize(h, torch.einsum("bhd,bhd->bh", qf, n), m_new)
    return h.to(q.dtype), C, n, m_new


def slstm_scan(x_gates, r, *, init=None):
    """Sequential sLSTM over time with a diagonal recurrence.

    x_gates: [b, s, 4, d] input pre-activations (i, f, z, o); r: [4, d]
    per-channel recurrent weights (g_t = x_proj_t + r * h_{t-1}).
    Returns h: [b, s, d] in x_gates' dtype and the final state (c, n, m, h),
    float32."""
    b, s, _, d = x_gates.shape
    if init is None:
        z = torch.zeros((b, d), device=x_gates.device)
        init = (z, z, torch.full((b, d), float("-inf"),
                                 device=x_gates.device), z)
    c, n, m, h = init
    hs = []
    for t in range(s):
        g = x_gates[:, t] + r[None] * h[:, None, :].to(x_gates.dtype)
        gi, gf, gz, go = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
        logf = F.logsigmoid(gf.float())
        m_new = torch.maximum(logf + m, gi.float())
        i = torch.exp(gi.float() - m_new)
        f = torch.exp(logf + m - m_new)
        c = f * c + i * torch.tanh(gz.float())
        n = f * n + i
        h = torch.sigmoid(go.float()) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1).to(x_gates.dtype), (c, n, m, h)
