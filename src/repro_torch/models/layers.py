"""Primitive layers shared by the blocks (PyTorch port of
``repro.models.layers``).

Everything is a plain function of (params, inputs) on tensors.  Attention
has the reference's three impls: "reference" (the O(s^2) oracle), "scan"
(the online-softmax loop over kv blocks) and "pallas", which on the port
means the hand-written CUDA kernels of ``repro_torch.kernels`` (their plain
PyTorch versions on a CPU tensor).  The "pallas" ops are differentiable
through the kernels' own backward (K2a / K2b for attention, K3's backward
products for the SwiGLU).  "scan" (and "pallas" attention with a sliding
window or a query offset, which falls back to it) differentiates through
``_FlashScan``, the reference's flash backward (``_flash_vjp``): the
forward keeps only (q, k, v, block_mask, out, lse) and the backward
recomputes each kv block's scores from ``lse``, so no per-block score or
probability tensor outlives its block.  "reference" differentiates through
torch autograd of its forward, as in the reference.
"""
from __future__ import annotations

import math
import torch
import torch.nn.functional as F

from repro_torch.kernels.block_sparse_attention import ops as bsa_ops
from repro_torch.kernels.pruned_matmul import ops as pm_ops

NEG_INF = -1e30
KERNEL_IMPLS = ("reference", "scan", "pallas")


def matmul(a, b):
    """``a @ b`` with jnp's type promotion (a bf16 x f32 product runs in
    f32 on the exactly upcast operand); torch refuses mixed operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def expand_ff_mask(ff_mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Block-level [n_blocks] -> feature-level [dim] pruning mask (no-op if
    already expanded)."""
    if ff_mask.shape[0] != dim:
        ff_mask = ff_mask.repeat_interleave(dim // ff_mask.shape[0])
    return ff_mask


def rms_norm(x, scale, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale.float()
    return out.to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)                 # [hd/2]
    angles = positions[..., None].float() * freqs                 # [..., seq, hd/2]
    angles = angles[..., None, :]                                 # broadcast heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, wi, wg, wo, ff_mask=None, *, impl: str = "scan"):
    """SwiGLU MLP.  ``ff_mask`` zeroes pruned feature blocks — either
    block-level [n_blocks] or expanded [d_ff].

    ``impl="pallas"`` routes through the block-pruned SwiGLU
    (kernels.pruned_matmul), which needs the block-level mask.  Single-token
    calls (decode) stay dense, as in the reference."""
    assert impl in KERNEL_IMPLS, impl
    d_ff = wi.shape[1]
    if impl == "pallas" and x.shape[-2] > 1:
        if ff_mask is None:
            bmask, bf = torch.ones(1, device=x.device), d_ff
        else:
            nb = ff_mask.shape[0]
            if not (nb < d_ff and d_ff % nb == 0):
                raise ValueError(("pallas swiglu needs a block-level ff_mask",
                                  tuple(ff_mask.shape), d_ff))
            bmask, bf = ff_mask, d_ff // nb
        return pm_ops.pruned_swiglu(x, wi, wg, wo, bmask, bf=bf)
    h = F.silu(x @ wg) * (x @ wi)
    if ff_mask is not None:
        h = h * expand_ff_mask(ff_mask, d_ff).to(h.dtype)
    return h @ wo


def gelu_mlp(x, w1, b1, w2, b2, ff_mask=None, *, impl: str = "scan"):
    """Biased GELU MLP (the whisper encoder / decoder FFN) with
    block-structured pruning; GELU is the tanh approximation, as
    ``jax.nn.gelu`` defaults.

    The same dispatch as ``swiglu``: the dense impls take a block-level or
    expanded ``ff_mask``; ``impl="pallas"`` needs the block-level mask and
    runs both matmuls through the block-pruned product (K3): mask over "n"
    for the up-projection, then the bias, GELU and the re-zeroed mask, and
    mask over "k" for the down-projection, then its bias.  Single-token
    calls (decode) stay dense, as in the reference."""
    assert impl in KERNEL_IMPLS, impl
    d_ff = w1.shape[1]
    if impl == "pallas" and x.shape[-2] > 1:
        bmask = (torch.ones(1, device=x.device) if ff_mask is None
                 else ff_mask)
        nb = bmask.shape[0]
        if not (nb < d_ff and d_ff % nb == 0):
            raise ValueError(("pallas gelu_mlp needs a block-level ff_mask",
                              tuple(bmask.shape), d_ff))
        bf = d_ff // nb
        h = pm_ops.pruned_matmul(x, w1, bmask, mask_axis="n", bn=bf) + b1
        h = F.gelu(h, approximate="tanh") * bmask.repeat_interleave(bf).to(
            x.dtype)
        return pm_ops.pruned_matmul(h.to(x.dtype), w2, bmask, mask_axis="k",
                                    bk=bf) + b2
    h = F.gelu(matmul(x, w1) + b1, approximate="tanh")
    if ff_mask is not None:
        h = h * expand_ff_mask(ff_mask, d_ff).to(x.dtype)
    return matmul(h, w2) + b2


def layer_norm(x, scale, bias, eps: float):
    """LayerNorm in float32 with a scale and a bias, returned in x's dtype
    (``repro.models.blocks._layer_norm``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale.float()
            + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _repeat_kv(k, num_q_heads: int):
    """[b, s, kv, d] -> [b, s, q, d] by repeating groups."""
    return k.repeat_interleave(num_q_heads // k.shape[2], dim=2)


def _einsum(eq, a, b, dtype=None):
    """einsum in ``dtype`` (default: the operands' promoted dtype), computed
    as XLA computes a dot on the host: operands rounded to ``dtype``,
    products accumulated in fp32, the result rounded to ``dtype`` once."""
    dtype = dtype or torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dtype).float(), b.to(dtype).float()).to(dtype)


def attention_reference(q, k, v, *, causal: bool, sliding_window: int = 0,
                        q_offset: int = 0, block_mask=None,
                        block_size: int = 128):
    """Naive O(s^2) attention; oracle for tests.  q:[b,sq,h,d]
    k,v:[b,sk,kv,d].  ``block_mask`` [h, sq//bs, sk//bs] (or
    [b, h|1, ..]) enables hash-based block sparsity."""
    b, sq, h, d = q.shape
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scores = _einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    dev = q.device
    pq = torch.arange(sq, device=dev) + q_offset
    pk = torch.arange(k.shape[1], device=dev)
    neg = torch.full_like(scores, NEG_INF)
    if causal:
        scores = torch.where(pq[:, None] >= pk[None, :], scores, neg)
    if sliding_window:
        scores = torch.where(pq[:, None] - pk[None, :] < sliding_window,
                             scores, neg)
    if block_mask is not None:
        bs = block_size
        bm = block_mask if block_mask.dim() == 4 else block_mask[None]
        m = bm.repeat_interleave(bs, dim=-2).repeat_interleave(bs, dim=-1)
        sk = k.shape[1]
        if m.shape[-2] < sq or m.shape[-1] < sk:
            # trailing partial blocks reuse the last mask row/col
            m = F.pad(m.float(), (0, max(0, sk - m.shape[-1]),
                                  0, max(0, sq - m.shape[-2])),
                      mode="replicate")
        scores = torch.where(m[..., :sq, :sk] > 0, scores, neg)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(scores.amax(-1, keepdim=True) <= NEG_INF / 2,
                        torch.zeros_like(probs), probs)
    return _einsum("bhqk,bkhd->bqhd", probs, v, v.dtype)


def flash_attention(q, k, v, *, causal: bool, sliding_window: int = 0,
                    q_offset: int = 0, block_mask=None, kv_block: int = 512,
                    impl: str = "scan"):
    """Flash attention forward.  ``impl`` selects the inner implementation:
      * "reference" — the O(s^2) dense oracle;
      * "scan"      — the online-softmax loop over kv blocks;
      * "pallas"    — the block-skipping CUDA kernel
        (kernels.block_sparse_attention).  Sliding-window / offset queries
        are not expressible as block masks — those fall back to the scan,
        as in the reference.
    """
    assert impl in KERNEL_IMPLS, impl
    if impl == "pallas" and sliding_window == 0 and q_offset == 0:
        return _pallas_attention(q, k, v, block_mask, causal, kv_block)
    if impl == "reference":
        return attention_reference(
            q, k, v, causal=causal, sliding_window=sliding_window,
            q_offset=q_offset, block_mask=block_mask, block_size=kv_block)
    return _FlashScan.apply(q, k, v, block_mask, causal, sliding_window,
                            q_offset, kv_block)


def _pallas_attention(q, k, v, block_mask, causal, kv_block):
    """Route through the block-sparse kernel (dense = all-ones mask).

    Accepts the model's mask layouts ([h, nqb, nkb] or [b, h|1, nqb, nkb])
    and edge-extends them to the kernel's [b|1, hq|1, nqb, nkb]."""
    b, sq, hq, _ = q.shape
    sk = k.shape[1]
    block = kv_block if block_mask is not None else min(kv_block, 128)
    nqb = -(-sq // block)
    nkb = -(-sk // block)
    if block_mask is None:
        bm = torch.ones((1, 1, nqb, nkb), dtype=torch.int32, device=q.device)
    else:
        bm = block_mask if block_mask.dim() == 4 else block_mask[None]
        # trailing partial blocks reuse the last mask row/col
        qb = torch.arange(nqb, device=q.device).clamp(0, bm.shape[2] - 1)
        kb = torch.arange(nkb, device=q.device).clamp(0, bm.shape[3] - 1)
        bm = bm[:, :, qb][:, :, :, kb]
    return bsa_ops.block_sparse_attention(q, k, v, bm, causal=causal,
                                          block=block)


class _FlashScan(torch.autograd.Function):
    """The scan's forward with the reference's flash backward
    (``_flash_vjp``): the forward runs without a graph and saves
    (q, k, v, block_mask, out, lse); the backward recomputes the scores
    kv block by kv block from ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, block_mask, causal, sliding_window, q_offset,
                kv_block):
        out, lse = _flash_fwd_impl(q, k, v, block_mask, causal,
                                   sliding_window, q_offset, kv_block)
        ctx.save_for_backward(q, k, v, block_mask, out, lse)
        ctx.args = (causal, sliding_window, q_offset, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, block_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, block_mask, out, lse, dout,
                                *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def _flash_bwd(q, k, v, block_mask, out, lse, dout, causal, sliding_window,
               q_offset, kv_block):
    """(dq, dk, dv) in the inputs' dtypes, the reference's
    ``_flash_vjp_bwd``: per kv block, s = q k^T / sqrt(d) in fp32 from the
    fp32 operands, p = exp(s - lse) (0 where masked and on fully masked
    rows, whose lse is ~NEG_INF), ds = p (dout v^T - D) / sqrt(d) with
    D = rowsum(dout * out); dq += ds k, and the block's dk = ds^T q and
    dv = p^T dout, each summed over its GQA group."""
    b, sq, h, d = q.shape
    sk, kv_heads = k.shape[1], k.shape[2]
    rep = h // kv_heads
    pad = (-sk) % kv_block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nkb = k.shape[1] // kv_block
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    pq = torch.arange(sq, device=dev) + q_offset
    qb_ids = torch.arange(sq, device=dev) // kv_block
    if block_mask is not None:
        qb_ids = qb_ids.clamp(max=block_mask.shape[-2] - 1)
    doutf = dout.float().transpose(1, 2)                       # [b,h,sq,d]
    D = (doutf * out.float().transpose(1, 2)).sum(-1)          # [b,h,sq]
    qh = q.float().transpose(1, 2)                             # [b,h,sq,d]
    dead_row = (lse <= NEG_INF / 4)[..., None]
    dq = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, nkb * kv_block, kv_heads, d), dtype=torch.float32,
                     device=dev)
    dv = torch.zeros_like(dk)
    for jb in range(nkb):
        blk = slice(jb * kv_block, (jb + 1) * kv_block)
        krep = k[:, blk].float().repeat_interleave(rep, dim=2)
        vrep = v[:, blk].float().repeat_interleave(rep, dim=2)
        s = torch.einsum("bhqd,bkhd->bhqk", qh, krep) * scale
        pk = jb * kv_block + torch.arange(kv_block, device=dev)
        mask = (pk[None, :] <= sk - 1).expand(sq, kv_block)
        if causal:
            mask = mask & (pq[:, None] >= pk[None, :])
        if sliding_window:
            mask = mask & (pq[:, None] - pk[None, :] < sliding_window)
        neg = torch.full_like(s, NEG_INF)
        if block_mask is not None:
            kb = min(jb, block_mask.shape[-1] - 1)
            if block_mask.dim() == 3:
                bm = block_mask[:, qb_ids, kb]                    # [h, sq]
                s = torch.where(bm[None, :, :, None] > 0, s, neg)
            else:
                bm = block_mask[:, :, qb_ids, kb]                 # [b, h, sq]
                s = torch.where(bm[..., None] > 0, s, neg)
        s = torch.where(mask[None, None], s, neg)
        p = torch.exp(s - lse[..., None])
        p = torch.where((s <= NEG_INF / 2) | dead_row,
                        torch.zeros_like(p), p)
        dp = torch.einsum("bhqd,bkhd->bhqk", doutf, vrep)
        ds = p * (dp - D[..., None]) * scale
        dq += torch.einsum("bhqk,bkhd->bhqd", ds, krep)
        dk[:, blk] = torch.einsum("bhqk,bhqd->bkhd", ds, qh).reshape(
            b, kv_block, kv_heads, rep, d).sum(3)
        dv[:, blk] = torch.einsum("bhqk,bhqd->bkhd", p, doutf).reshape(
            b, kv_block, kv_heads, rep, d).sum(3)
    return (dq.transpose(1, 2).to(q.dtype), dk[:, :sk].to(k.dtype),
            dv[:, :sk].to(v.dtype))


def _flash_fwd_impl(q, k, v, block_mask, causal, sliding_window, q_offset,
                    kv_block):
    """Forward online-softmax loop; returns (out, lse [b,h,sq])."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    kv_heads = k.shape[2]
    if sk % kv_block:
        pad = kv_block - sk % kv_block
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nkb = k.shape[1] // kv_block
    rep = h // kv_heads
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    pq = torch.arange(sq, device=dev) + q_offset
    qb_ids = torch.arange(sq, device=dev) // kv_block
    if block_mask is not None:
        # rows / columns past the mask's last block reuse it (jnp's clamped
        # gather in the reference)
        qb_ids = qb_ids.clamp(max=block_mask.shape[-2] - 1)

    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    m_prev = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l_prev = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    for jb in range(nkb):
        kblk = k[:, jb * kv_block:(jb + 1) * kv_block].repeat_interleave(
            rep, dim=2)
        vblk = v[:, jb * kv_block:(jb + 1) * kv_block].repeat_interleave(
            rep, dim=2)
        pk = jb * kv_block + torch.arange(kv_block, device=dev)
        s = _einsum("bqhd,bkhd->bhqk", q, kblk).float() * scale
        mask = (pk[None, :] <= sk - 1).expand(sq, kv_block)
        if causal:
            mask = mask & (pq[:, None] >= pk[None, :])
        if sliding_window:
            mask = mask & (pq[:, None] - pk[None, :] < sliding_window)
        neg = torch.full_like(s, NEG_INF)
        if block_mask is not None:
            kb = min(jb, block_mask.shape[-1] - 1)
            if block_mask.dim() == 3:
                bm = block_mask[:, qb_ids, kb]                    # [h, sq]
                s = torch.where(bm[None, :, :, None] > 0, s, neg)
            else:
                bm = block_mask[:, :, qb_ids, kb]                 # [b, h, sq]
                s = torch.where(bm[..., None] > 0, s, neg)
        s = torch.where(mask[None, None], s, neg)
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_prev - m_new)
        l_prev = l_prev * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _einsum(
            "bhqk,bkhd->bhqd", p, vblk, vblk.dtype).float()
        m_prev = m_new
    out = acc / l_prev[..., None].clamp_min(1e-30)
    out = torch.where(m_prev[..., None] <= NEG_INF / 2,
                      torch.zeros_like(out), out)
    lse = m_prev + torch.log(l_prev.clamp_min(1e-30))              # [b,h,sq]
    return out.transpose(1, 2).to(q.dtype), lse


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     sliding_window: int = 0):
    """Single-token decode attention over a cache.

    q: [b, 1, h, d]; k_cache/v_cache: [b, S, kv, d]; cache_len: count of
    valid entries — a scalar or a [b] tensor (each request at its own
    position).  As in the reference, the probabilities are cast to the
    cache's dtype before the P·V product."""
    b, s, kv, d = k_cache.shape
    h = q.shape[2]
    k = _repeat_kv(k_cache, h)
    v = _repeat_kv(v_cache, h)
    scores = _einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    idx = torch.arange(s, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device)
    if cl.dim() == 0:
        valid = idx < cl                                       # [s]
        if sliding_window:
            valid = valid & (idx >= cl - sliding_window)
        vmask = valid[None, None, None, :]
    else:
        valid = idx[None, :] < cl[:, None]                     # [b, s]
        if sliding_window:
            valid = valid & (idx[None, :] >= cl[:, None] - sliding_window)
        vmask = valid[:, None, None, :]
    scores = torch.where(vmask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return _einsum("bhqk,bkhd->bqhd", probs, v, v.dtype)


def gqa_project(x, wq, wk, wv, num_heads, num_kv_heads, head_dim):
    b, s, _ = x.shape
    q = (x @ wq).reshape(b, s, num_heads, head_dim)
    k = (x @ wk).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ wv).reshape(b, s, num_kv_heads, head_dim)
    return q, k, v


def cross_entropy_with_head(h, head_w, labels, *, label_mask=None,
                            vocab_offset: int = 0, group=None, comm=None):
    """Cross-entropy over a (possibly vocab-sharded) head: h [..., d],
    head_w [d, V_local], labels [...] int.  With ``comm`` (a
    ``launch.dist.Comm``) the head is this rank's vocab shard starting at
    ``vocab_offset`` and ``group`` holds the shards (Megatron-style
    vocab-parallel loss, the reference's ``axis_name``): a max all-reduce,
    then sums of the shards' ``sumexp`` and in-shard label logits.  The
    collectives carry values; the gradient of each rank's shard is the
    local term's (the max is a constant of the log-sum-exp)."""
    logits = matmul(h, head_w).float()
    if comm is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    else:
        gmax = comm.all_reduce(logits.detach().amax(dim=-1), group,
                               op="max")
        sumexp = torch.exp(logits - gmax[..., None]).sum(dim=-1)
        sumexp = _sum_over(sumexp, comm, group)
        lse = gmax + torch.log(sumexp)
        local = labels.long() - vocab_offset
        in_shard = (local >= 0) & (local < logits.shape[-1])
        safe = local.clamp(0, logits.shape[-1] - 1)
        ll = logits.gather(-1, safe[..., None])[..., 0]
        ll = _sum_over(torch.where(in_shard, ll, torch.zeros_like(ll)),
                       comm, group)
    nll = lse - ll
    if label_mask is not None:
        nll = nll * label_mask
        denom = torch.clamp(label_mask.sum(), min=1.0)
    else:
        denom = float(nll.numel())
    return nll.sum() / denom


class _GroupSum(torch.autograd.Function):
    """All-reduce sum whose backward passes the gradient through: every
    rank computes the same loss from the sum, so each shard's term gets the
    loss's gradient once (the reference's psum transposes the same way)."""

    @staticmethod
    def forward(ctx, x, comm, group):
        return comm.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _sum_over(x, comm, group):
    return _GroupSum.apply(x, comm, group)
