"""Plain PyTorch reference of a dense decoder's training step (Llama
style, as SmolLM publishes it): token embedding, per layer RMSNorm, GQA
attention with rotary positions (half-split) and a causal softmax,
RMSNorm, SwiGLU FFN whose hidden blocks a prune mask may zero, a final
RMSNorm, the head (the embedding's transpose where the configuration
ties them), mean cross-entropy over every token of the step; global-norm
clipping and AdamW.

It computes in fp32 with TF32 off (``prec="fp32"``).  ``prec="tf32"``
rounds every product's operands to TF32 first: the control, one
precision below the configuration's.  Rows run in chunks so that the
step fits beside nothing else; the gradients add over the chunks.

It follows the program's stated semantics where the model leaves a
choice: the loss is the token mean over the whole step; AdamW decays
every per-layer leaf (norm scales included) and the embedding and head,
not the final norm; the clip norm runs over every leaf; a tied
embedding's gradient is the sum of its two uses."""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

OPT = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "wd": 0.1, "clip": 1.0}
# the leaves outside the layers (``head`` only where it is untied)
TOP = ("embed", "head", "final_norm")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest), kept in fp32."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``torch.einsum(eq, a, b)`` with both operands rounded to TF32, and
    the backward's two products likewise, as TF32 tensor cores run all
    three."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return torch.einsum(eq, tf32(a), tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        sa, sb = ins.split(",")
        ga = torch.einsum(f"{out},{sb}->{sa}", tf32(g), tf32(b))
        gb = torch.einsum(f"{sa},{out}->{sb}", tf32(a), tf32(g))
        return None, ga, gb


class Precision:
    def __init__(self, kind: str):
        if kind not in ("fp32", "tf32"):
            raise ValueError(kind)
        self.kind = kind

    def mm(self, a, b):
        """a [..., K] @ b [K, N]."""
        if self.kind == "fp32":
            return a @ b
        return _TF32Product.apply("...k,kn->...n", a, b)

    def einsum(self, eq, a, b):
        if self.kind == "fp32":
            return torch.einsum(eq, a, b)
        return _TF32Product.apply(eq, a, b)


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x [b, s, h, hd]; position p rotates the pair (i, i + hd/2) by
    p * theta^(-2i/hd)."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def nll_sum(P, c, tokens, labels, masks, pr: Precision):
    """Summed next-token NLL of ``tokens`` [b, s] (long, on the device)."""
    b, s = tokens.shape
    hq, hkv, hd = c["hq"], c["hkv"], c["hd"]
    x = P["embed"][tokens]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    for i, lp in enumerate(P["layers"]):
        h = rms_norm(x, lp["attn_norm"], c["eps"])
        q = rope(pr.mm(h, lp["wq"]).view(b, s, hq, hd), c["theta"])
        k = rope(pr.mm(h, lp["wk"]).view(b, s, hkv, hd), c["theta"])
        v = pr.mm(h, lp["wv"]).view(b, s, hkv, hd)
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
        sc = pr.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(hd))
        p = torch.softmax(sc.masked_fill(causal, float("-inf")), dim=-1)
        o = pr.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, hq * hd)
        x = x + pr.mm(o, lp["wo"])
        h = rms_norm(x, lp["ffn_norm"], c["eps"])
        z = F.silu(pr.mm(h, lp["wg"])) * pr.mm(h, lp["wi"])
        if masks is not None:
            z = z * masks[i]
        x = x + pr.mm(z, lp["wof"])
    head = P["head"] if "head" in P else P["embed"].T
    logits = pr.mm(rms_norm(x, P["final_norm"], c["eps"]), head)
    ll = logits.gather(-1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - ll).sum()


class Trainer:
    """A dense decoder's weights and AdamW moments, stepped in fp32.

    ``W``: {"embed", "head" (untied only), "final_norm", per-layer fields
    [L, ...]} (the layout ``weights.make`` gives), taken over.  ``rows``:
    "all", or "half" (the fault that leaves half of the batch out)."""

    def __init__(self, c: Dict, W: Dict[str, torch.Tensor], *,
                 prec: str = "fp32", chunk_rows: int = 2, rows: str = "all"):
        self.c, self.pr, self.chunk = c, Precision(prec), int(chunk_rows)
        self.rows = rows
        self.W = {k: v.float() for k, v in W.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.W.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.W.items()}
        self.count = 0

    def leaves(self):
        """{leaf name: fp32 tensor view}: ``embed``, ``head`` (untied
        only), ``final_norm`` and ``layers.<i>.<field>``."""
        return leaf_views(self.W, self.c["layers"])

    def _params(self, leaves):
        L = self.c["layers"]
        layers = [{f: leaves[f"layers.{i}.{f}"] for f in fields(self.W)}
                  for i in range(L)]
        out = {k: leaves[k] for k in TOP if k in leaves}
        out["layers"] = layers
        return out

    def step(self, batch, lr: float, masks: Optional[torch.Tensor] = None):
        """One step on ``batch`` (numpy ``tokens`` / ``labels``
        [m, b, s]); ``masks``: [L, ff] 0/1 or None.  Returns (loss, {leaf:
        norm of the clipped gradient the optimizer got})."""
        dev = self.W["embed"].device
        toks = np.asarray(batch["tokens"]).reshape(-1, batch["tokens"]
                                                   .shape[-1])
        labs = np.asarray(batch["labels"]).reshape(toks.shape)
        if self.rows == "half":
            toks, labs = toks[:len(toks) // 2], labs[:len(labs) // 2]
        count = float(toks.size)
        views = self.leaves()
        leaves = {k: t.detach().requires_grad_(True)
                  for k, t in views.items()}
        P = self._params(leaves)
        total = 0.0
        for r0 in range(0, len(toks), self.chunk):
            t = torch.as_tensor(toks[r0:r0 + self.chunk], device=dev).long()
            y = torch.as_tensor(labs[r0:r0 + self.chunk], device=dev).long()
            nll = nll_sum(P, self.c, t, y, masks, self.pr)
            (nll / count).backward()
            total += float(nll.detach())
        grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t))
                 for k, t in leaves.items()}
        del P, leaves
        with torch.no_grad():
            norm = torch.stack([g.square().sum() for g in grads.values()]
                               ).sum().sqrt()
            scale = torch.clamp(OPT["clip"] / torch.clamp(norm, min=1e-12),
                                max=1.0)
            self.count += 1
            t = torch.tensor(float(self.count), device=dev)
            bc1 = 1 - torch.tensor(OPT["b1"], device=dev) ** t
            bc2 = 1 - torch.tensor(OPT["b2"], device=dev) ** t
            gnorms = {}
            mv = leaf_views(self.m, self.c["layers"])
            vv = leaf_views(self.v, self.c["layers"])
            for k, p in views.items():
                g = grads[k] * scale
                gnorms[k] = float(torch.linalg.vector_norm(g))
                m, v = mv[k], vv[k]
                m.mul_(OPT["b1"]).add_(g, alpha=1 - OPT["b1"])
                v.mul_(OPT["b2"]).addcmul_(g, g, value=1 - OPT["b2"])
                upd = (m / bc1) / ((v / bc2).sqrt() + OPT["eps"])
                if k != "final_norm":
                    upd = upd + p * OPT["wd"]
                p.sub_(upd * lr)
        return total / count, gnorms


def fields(W):
    return sorted(k for k in W if k not in TOP)


def leaf_views(W, L: int) -> Dict[str, torch.Tensor]:
    """{leaf name: view} of weights (or a moment) in the reference's
    layout."""
    out = {k: W[k] for k in TOP if k in W}
    for f in fields(W):
        for i in range(L):
            out[f"layers.{i}.{f}"] = W[f][i]
    return out


def masks_from_blocks(blocks: torch.Tensor, ff: int) -> torch.Tensor:
    """[L, n_blocks] 0/1 -> [L, ff] (each block's width repeated)."""
    return blocks.float().repeat_interleave(ff // blocks.shape[1], dim=1)


def block_magnitudes(W, npb: int) -> torch.Tensor:
    """Each FFN block's L2 magnitude, [L, npb] float64: the up and gate
    projections' columns and the down projection's rows of the block."""
    out = []
    for i in range(W["wi"].shape[0]):
        cols = sum(W[f][i].double().square().reshape(W[f].shape[1], npb, -1)
                   .sum(dim=(0, 2)) for f in ("wi", "wg"))
        rows = W["wof"][i].double().square().reshape(npb, -1).sum(dim=1)
        out.append((cols + rows).sqrt())
    return torch.stack(out)
