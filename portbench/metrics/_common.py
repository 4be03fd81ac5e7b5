"""What the per-layer readers share: the traced steps and the kernels'
least times by the frozen formulas.  A reader returns None when its run
gave it nothing to read."""
from __future__ import annotations

from typing import Dict, List

from reference import formulas


def traced_steps(ctx) -> List[int]:
    if ctx["prof_at"] is None:
        return []
    return list(range(ctx["prof_at"] + 1, ctx["prof_at"] + ctx["prof_n"] + 1))


def per_step(ctx, seconds: float) -> float:
    return seconds / ctx["trace"]["steps"]


def k3_least_s(ctx) -> float:
    """Least seconds of K3's work in the traced steps: per layer and
    microbatch the SwiGLU's three products forward and their dx and dw
    backward, each over the layer's live FFN blocks, in FLOPs and in
    bytes."""
    c, masks = ctx["widths"], ctx["masks"]
    M = ctx["rows_per_micro"] * ctx["seq"]
    d, ff = c["d"], c["ff"]
    esize = 2 if ctx["dtype"] == "bfloat16" else 4
    total = 0.0
    for keep in masks.float().mean(dim=1).tolist():
        one = formulas.least_seconds(
            formulas.matmul_flops(M, d, ff, keep),
            formulas.pruned_ffn_bytes(M, d, ff, keep, esize), ctx["dtype"])
        total += 9 * one
    return total * ctx["micro"] * ctx["trace"]["steps"]


def attn_least_s(ctx) -> float:
    """Least seconds of K1 + K2a + K2b's work in the traced steps: the
    forward's two products and the backward's four over the exact causal
    pairs, per layer and microbatch."""
    c = ctx["widths"]
    b, s = ctx["rows_per_micro"], ctx["seq"]
    esize = 2 if ctx["dtype"] == "bfloat16" else 4
    fl = formulas.attention_flops(b, c["hq"], c["hd"],
                                  formulas.causal_pairs(s), 6)
    by = sum(formulas.attention_bytes(k, b, s, s, c["hq"], c["hkv"], c["hd"],
                                      esize) for k in ("K1", "K2a", "K2b"))
    one = formulas.least_seconds(fl, by, ctx["dtype"])
    return one * c["layers"] * ctx["micro"] * ctx["trace"]["steps"]


def kernel_seconds(ctx, ids) -> Dict[str, float]:
    from devtrace import by_kernel
    got = by_kernel(ctx["trace"])
    return sum(got.get(k, [0, 0.0])[1] for k in ids)
