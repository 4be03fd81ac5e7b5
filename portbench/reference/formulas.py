"""The yardstick's arithmetic: the card's peaks, the FLOPs and bytes a
kernel's work needs, and the FLOPs a training step needs.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, 700 W): 989 TFLOP/s
in bf16, 495 TFLOP/s in TF32 (the fastest the card multiplies fp32
operands, so no fp32-accurate path can beat it), 3.35 TB/s of HBM3.

The per-kernel formulas are frozen copies of the port's
(``repro_torch.kernels`` ``work()``): a tests holds them equal at sample
shapes.  The harness calls them with the work the inputs need: attention
over the exact causal (query, key) pairs, K3 over the live blocks, in
FLOPs and in bytes (``pruned_ffn_bytes``; the port's K3 accounting counts
the whole weight's bytes whatever the mask)."""
from __future__ import annotations

from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12

# the port's CUDA kernels by function name (as the profiler shows them),
# and the kernel each is part of
KERNEL_IDS: Dict[str, str] = {
    "bsa_fwd_tc_kernel": "K1", "bsa_dq_tc_kernel": "K2a",
    "bsa_dkv_tc_kernel": "K2b", "bsa_dkv_sum_kernel": "K2b",
    "pm_kernel": "K3", "pm_tc_kernel": "K3", "pm_sum_kernel": "K3",
    "gm_kernel": "K4", "gm_tc_kernel": "K4", "gm_dw_kernel": "K5",
    "gm_dw_tc_kernel": "K5", "paged_attn_kernel": "K6"}


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card needs for this work."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def causal_pairs(seq: int) -> int:
    """(query, key) pairs causal attention over ``seq`` tokens needs."""
    return seq * (seq + 1) // 2


def attention_flops(b: int, hq: int, d: int, pairs: float,
                    products: int) -> float:
    """``products`` [pairs x d] products per (batch row, query head)."""
    return float(products * 2 * b * hq * pairs * d)


def attention_bytes(kernel: str, b: int, sq: int, sk: int, hq: int,
                    hkv: int, d: int, esize: int, mask_bytes: float = 0.0
                    ) -> float:
    """Bytes K1 / K2a / K2b read and write once each: q, k, v (and for
    the backward dout, lse, delta) in, the outputs out."""
    q = b * sq * hq * d * esize
    kv = b * sk * hkv * d * esize
    rows = 4.0 * b * hq * sq                    # one fp32 per query row
    if kernel == "K1":
        return q + 2 * kv + mask_bytes + q + rows
    read = q + 2 * kv + mask_bytes + q + 2 * rows     # + dout, lse, delta
    return read + (q if kernel == "K2a" else 2 * kv)


def matmul_flops(M: int, K: int, N: int, keep: float = 1.0) -> float:
    """One block-pruned product [M, K] @ [K, N] with ``keep`` of the
    masked dimension's blocks live."""
    return 2.0 * M * K * N * keep


def matmul_bytes(M: int, K: int, N: int, esize: int,
                 mask_bytes: float = 0.0) -> float:
    """x and w read once, the output written once."""
    return float((M * K + K * N + M * N) * esize + mask_bytes)


def pruned_ffn_bytes(M: int, d: int, ff: int, keep: float, esize: int,
                     mask_bytes: float = 0.0) -> float:
    """Bytes one of the FFN's block-pruned products needs (x [M, d] @ w
    [d, ff], or its dx / dw / down-projection forms over the same three
    operands): the [M, d] side whole, the weight and the [M, ff] side
    only in their ``keep`` share of live blocks.  ``matmul_bytes`` at
    ``keep`` 1."""
    return float((M * d + (d * ff + M * ff) * keep) * esize + mask_bytes)


def dense_step_flops(*, layers: int, d: int, hq: int, hkv: int, hd: int,
                     vocab: int, rows: int, seq: int,
                     live_ff: float) -> float:
    """FLOPs one training step of a dense decoder needs: forward plus
    backward (twice the forward), no recomputation, no embedding lookup.
    ``live_ff``: the FFN width summed over the layers that the prune keeps
    (blocks x block width)."""
    tokens = rows * seq
    proj = 2.0 * d * (2 * hq * hd + 2 * hkv * hd) * layers * tokens
    ffn = 3 * 2.0 * d * live_ff * tokens
    head = 2.0 * d * vocab * tokens
    attn = attention_flops(rows, hq, hd, causal_pairs(seq), 2) * layers
    return 3.0 * (proj + ffn + head + attn)
