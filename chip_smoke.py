#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero without the
final line:
  1. device  — require CUDA; the card's name and power limit (nvidia-smi),
               torch and CUDA versions;
  2. build   — compile every kernel from ``src/repro_torch/kernels/*/csrc``
               with nvcc for sm_90a (one nvcc per source, in parallel);
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               card at the main path's full-width shapes and at edge shapes,
               with the tolerance stated; kernel / plain / library times
               (CUDA events, warmed up, L2 warm) and the roofline bound;
  3c.        the backward sweeps K2a (dq) and K2b (dk/dv) at the training
               shapes (dense causal, a 512-block mask with dead tiles,
               partial blocks, fully masked rows, bf16);
  3d.        K3's backward products (dx, dw for a mask over N and over K,
               dense and 87 % pruned) against torch.matmul;
  3e.        the grouped expert matmul K4 (forward and as dx on a
               transposed weight view) and its weight gradient K5 at the
               Mixtral-8x7B training shapes (b 2, s 1024, cap 320, 16
               groups; K / N = 4096 / 14336 and 14336 / 4096; counts from
               a seeded router), at the serve prefill and decode shapes
               (cap 4, counts 0/1), and at edge cases (empty and full
               groups, cap off the row tile, a placement, garbage in dead
               rows), fp32 and bf16;
  4. serve   — the port's serving path through its CLI entry point:
               full-width smollm-360m, one stage, paged KV + prefix cache,
               sparse attention, kernel_impl "pallas"; launch counters are
               zeroed just before and read just after, and every kernel of
               the path must have launched;
  4b. profile — device time by kernel over a shorter serve (4 requests)
               under torch.profiler, and the device's busy share against
               the same serve's wall time without the profiler;
  4c. train  — the port's training path through its CLI entry point:
               full-width smollm-360m (32 layers), two stage buffers, 4
               microbatches of 2 x 1024 tokens, 15 steps with the prune at
               step 10 and a rebalance cadence every 5 steps under a 2x
               straggler; counters zeroed just before and read just after:
               per step K1 128, K2a 128, K2b 128, K3 384 forward + 768
               backward launches; a migration must move layers;
  4d. profile — two train steps under torch.profiler: busy share and
               device time by kernel;
  4e. moe train — the training CLI on full-width Mixtral-8x7B cut to 2
               layers (2 stage buffers of one layer, --slot-slack 0, bf16
               params, AdamW), 4 microbatches of 2 x 1024 tokens, 8 steps,
               --dynamism moe with live expert re-layout (watermark 1.01,
               min tokens 1, cadence 3); counters zeroed just before and
               read just after: per step K4 48 (24 forward + 24 as dx), K5
               24, K1 / K2 / K3 0 (the sliding window sends attention down
               the scan path); a re-layout must move experts;
  4f. moe serve — the serving CLI on full-width Mixtral-8x7B cut to 4
               layers, fp32, one stage, 2 x 4 lanes, 8 requests, prompts
               512–1024, up to 16 generated, contiguous KV (the sliding
               window forbids paging); K4 in every prefill and decode;
               moe_dropped_mean in [0, 1);
  4g. profile — two MoE train steps under torch.profiler;
  5. parity  — one prefill and 8 teacher-forced decode steps from one engine
               state, through the kernels and through the plain versions;
  5b. train parity — loss and every gradient of one training step (full
               widths, 4 layers, 2 stages, half the FFN blocks pruned)
               through the kernels and through the plain versions;
  5c. moe parity — full-width Mixtral-8x7B cut to 2 layers, fp32: one
               train step's loss and gradients, and one prefill plus 8
               teacher-forced decode steps, kernels vs plain versions;
               moe_ffn under the identity and two expert placements, y,
               load and drop fraction bitwise equal;
  6. the kernels line (JSON), the card line, and the last line
     {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet) used for the roofline bound
PEAK_FP32_FLOPS = 67e12      # fp32 on the CUDA cores
PEAK_BF16_FLOPS = 989e12     # bf16 on the tensor cores (dense)
PEAK_BYTES = 3.35e12         # HBM3

def serve_args(requests: int):
    """The main path's CLI flags: full-width smollm-360m on one stage."""
    return ["--elastic", "--stages", "1", "--micro", "2", "--mb-global", "4",
            "--prompt-len", "1024", "--gen", "32", "--requests",
            str(requests), "--kv-page-size", "16", "--prefix-cache",
            "--dynamism", "sparse_attention", "--kernel-impl", "pallas",
            "--param-dtype", "float32", "--seed", "0"]


def train_args(steps: int = 15):
    """The training path's CLI flags: full-width smollm-360m, two stage
    buffers on the card, the prune at step 10, a rebalance cadence every 5
    steps under a 2x straggler on stage 1."""
    return ["--stages", "2", "--num-micro", "4", "--mb-global", "2",
            "--seq", "1024", "--steps", str(steps), "--rebalance-every", "5",
            "--straggler", "1:2.0", "--balancer", "diffusion",
            "--dynamism", "pruning", "--kernel-impl", "pallas",
            "--param-dtype", "float32", "--seed", "0", "--log-every", "5"]


# launches per train step at train_args(): 32 layers x 4 microbatches
TRAIN_LAUNCHES_PER_STEP = {"block_sparse_attention": 128,
                           "block_sparse_attention_bwd_dq": 128,
                           "block_sparse_attention_bwd_dkv": 128,
                           "pruned_matmul": 384 + 768}
TRAIN_K3_BWD_PER_STEP = 768

# launches per MoE train step at moe_train_args(): 2 layers x 4
# microbatches x 3 expert projections, each once forward (K4), once as dx
# (K4) and once as dw (K5); attention takes the scan path (sliding window)
MOE_TRAIN_LAUNCHES_PER_STEP = {"grouped_matmul": 48,
                               "grouped_matmul_dw": 24,
                               "block_sparse_attention": 0,
                               "block_sparse_attention_bwd_dq": 0,
                               "block_sparse_attention_bwd_dkv": 0,
                               "pruned_matmul": 0}
MOE_SERVE_PATH = ("grouped_matmul",)


def moe_arch(layers: int) -> str:
    """Register full-width Mixtral-8x7B cut to ``layers`` layers (depth is
    the only cut: 32 layers are 93 GB in bf16) and return its name."""
    from repro_torch.configs import get_config, register
    name = f"mixtral-8x7b-{layers}l"
    register(dataclasses.replace(get_config("mixtral-8x7b"), name=name,
                                 num_layers=layers))
    return name


def moe_train_args(steps: int = 8):
    """The MoE training path's CLI flags: 2 layers, one per stage buffer,
    bf16 params, 8192 tokens a step, live expert re-layout."""
    return ["--arch", moe_arch(2), "--stages", "2", "--slot-slack", "0",
            "--param-dtype", "bfloat16", "--num-micro", "4", "--mb-global",
            "2", "--seq", "1024", "--steps", str(steps), "--dynamism", "moe",
            "--dynamics.expert_relayout", "--dynamics.expert_watermark",
            "1.01", "--dynamics.expert_min_tokens", "1",
            "--rebalance-every", "3", "--kernel-impl", "pallas", "--seed",
            "0", "--log-every", "1"]


def moe_serve_args(requests: int = 8):
    """The MoE serving path's CLI flags: 4 layers, fp32, contiguous KV."""
    return ["--elastic", "--arch", moe_arch(4), "--stages", "1",
            "--slot-slack", "0", "--micro", "2", "--mb-global", "4",
            "--prompt-len", "1024", "--gen", "16", "--requests",
            str(requests), "--kernel-impl", "pallas", "--param-dtype",
            "float32", "--seed", "0"]


def check_launches(label: str, launched, per_step, steps: int) -> None:
    """Every kernel of ``per_step`` launched exactly its count a step."""
    for name, n in per_step.items():
        got = launched.get(name, 0)
        if got != n * steps:
            raise AssertionError(f"{label}: {name} launched {got} times in "
                                 f"{steps} steps, expected {n} a step")


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_close(name: str, got, want, atol: float, rtol: float) -> float:
    import torch
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    if not bool((err <= lim).all()):
        raise AssertionError(f"{name}: max |err| {float(err.max()):.3e} "
                             f"exceeds atol {atol} + rtol {rtol}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 3: kernels vs their plain versions
# ---------------------------------------------------------------------------
def check_block_sparse_attention(torch, F):
    from repro_torch.kernels.block_sparse_attention import ops, ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)

    def inputs(b, s, hq, hkv, d, dtype=torch.float32):
        q = torch.randn((b, s, hq, d), generator=g, device=dev) * 0.5
        k = torch.randn((b, s, hkv, d), generator=g, device=dev) * 0.5
        v = torch.randn((b, s, hkv, d), generator=g, device=dev) * 0.5
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def mask(b, s, block, density):
        n = -(-s // block)
        return (torch.rand((b, 1, n, n), generator=g, device=dev)
                < density).to(torch.int32)

    # (label, b, s, hq, hkv, d, block, density, causal, dtype, atol, path)
    cases = [
        ("main s1024 blk512", 4, 1024, 15, 5, 64, 512, 1.0, True,
         torch.float32, 1e-4, True),
        ("nomask blk128", 4, 1024, 15, 5, 64, 128, 1.0, True,
         torch.float32, 1e-4, True),
        ("ragged s1000 half", 2, 1000, 15, 5, 64, 128, 0.5, True,
         torch.float32, 1e-4, True),
        ("noncausal s300", 2, 300, 15, 5, 64, 128, 0.5, False,
         torch.float32, 1e-4, True),
        ("blk32 per-elem", 2, 100, 4, 2, 32, 32, 0.5, True,
         torch.float32, 1e-4, True),
        ("d16 s77", 2, 77, 4, 2, 16, 64, 1.0, True, torch.float32, 1e-4,
         True),
        ("bf16 s256", 2, 256, 15, 5, 64, 128, 0.7, True, torch.bfloat16,
         2e-2, False),
    ]
    worst = 0.0
    timed = None
    for (label, b, s, hq, hkv, d, block, dens, causal, dt, atol,
         path) in cases:
        q, k, v = inputs(b, s, hq, hkv, d, dt)
        bm = mask(b, s, block, dens)
        if label.startswith("ragged"):
            bm[:, :, 1, :] = 0                  # fully masked q rows
        out, lse = ops.block_sparse_attention_fwd(q, k, v, bm, causal=causal,
                                                  block=block)
        torch.cuda.synchronize()
        rout, rlse = ref.block_sparse_attention_ref(q, k, v, bm,
                                                    causal=causal,
                                                    block=block)
        e = check_close(f"K1 {label} out", out, rout, atol, atol)
        live = rlse > -1e29
        check_close(f"K1 {label} lse", lse[live], rlse[live], atol, atol)
        if not bool((lse[~live] < -1e29).all()):
            raise AssertionError(f"K1 {label}: masked rows lost the lse "
                                 f"sentinel")
        if label.startswith("ragged") and float(
                out[:, 128:256].abs().max()) != 0.0:
            raise AssertionError("K1 fully masked rows are not zero")
        if path:
            worst = max(worst, e)
        say("kernels", kernel="K1", case=label.replace(" ", "_"),
            max_abs_err=f"{e:.3e}", tol=atol)
        if timed is None:
            timed = (q, k, v, bm, block)
    q, k, v, bm, block = timed
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    ms = cuda_ms(lambda: ops.block_sparse_attention_fwd(q, k, v, bm,
                                                        block=block))
    plain_ms = cuda_ms(lambda: ref.block_sparse_attention_ref(q, k, v, bm,
                                                              block=block))
    # library yardstick: SDPA on the same inputs, kv heads repeated
    # beforehand (not timed)
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
              for t in (k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    pairs = b * hq * s * (s + 1) / 2            # live causal (q, k) pairs
    flops = 4.0 * d * pairs
    nbytes = 4.0 * (2 * b * s * hq * d + 2 * b * s * hkv * d + b * hq * s)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                max_abs_err=worst, tol=1e-4, bound=bound(flops, nbytes),
                shape=f"b{b} s{s} hq{hq} hkv{hkv} d{d} block{block} fp32")


def check_pruned_matmul(torch, F):
    from repro_torch.kernels.pruned_matmul import ops, ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)

    def run_case(label, M, K, N, axis, blk, density, dt, atol, path):
        x = (torch.randn((M, K), generator=g, device=dev)).to(dt)
        w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(dt)
        nb = (N if axis == "n" else K) // blk
        bm = (torch.rand((nb,), generator=g, device=dev) < density).to(
            torch.float32)
        if density < 1.0:
            bm[0] = 1.0
        kw = dict(mask_axis=axis, bn=blk, bk=blk)
        out = ops.pruned_matmul(x, w, bm, **kw)
        torch.cuda.synchronize()
        want = ref.pruned_matmul_ref(x, w, bm, **kw)
        e = check_close(f"K3 {label}", out, want, atol, atol)
        say("kernels", kernel="K3", case=label.replace(" ", "_"),
            max_abs_err=f"{e:.3e}", tol=atol)
        return (e if path else 0.0), (x, w, bm, kw)

    cases = [
        ("main up M4096 K960 N2560", 4096, 960, 2560, "n", 128, 1.0,
         torch.float32, 2e-4, True),
        ("main down M4096 K2560 N960", 4096, 2560, 960, "k", 128, 1.0,
         torch.float32, 2e-4, True),
        ("ragged n half", 1000, 960, 2560, "n", 128, 0.5, torch.float32,
         2e-4, True),
        ("ragged k half", 333, 2560, 960, "k", 128, 0.5, torch.float32,
         2e-4, True),
        ("bn64", 77, 100, 192, "n", 64, 0.6, torch.float32, 2e-4, True),
        ("bk48 per-elem", 50, 96, 70, "k", 48, 0.5, torch.float32, 2e-4,
         True),
        ("bf16", 256, 960, 512, "n", 128, 0.5, torch.bfloat16, 5e-2,
         False),
    ]
    worst, timed = 0.0, None
    for c in cases:
        e, inp = run_case(*c)
        worst = max(worst, e)
        timed = timed or inp
    x, w, bm, kw = timed
    M, K = x.shape
    N = w.shape[1]
    ms = cuda_ms(lambda: ops.pruned_matmul(x, w, bm, **kw))
    plain_ms = cuda_ms(lambda: ref.pruned_matmul_ref(x, w, bm, **kw))
    lib_ms = cuda_ms(lambda: torch.matmul(x, w))
    flops = 2.0 * M * K * N * float(bm.mean())
    nbytes = 4.0 * (M * K + K * N + M * N)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                max_abs_err=worst, tol=2e-4, bound=bound(flops, nbytes),
                shape=f"M{M} K{K} N{N} mask n all-live fp32")


def check_paged_attention(torch, F):
    from repro_torch.kernels.paged_attention import ops, ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)

    def run_case(label, clens, n_q, n_kv, hd, page, J, pool, kv_dt, holes,
                 atol, path):
        b = len(clens)
        q = torch.randn((b, n_q, hd), generator=g, device=dev)
        kp = torch.randn((pool + 1, page, n_kv, hd), generator=g,
                         device=dev).to(kv_dt)
        vp = torch.randn((pool + 1, page, n_kv, hd), generator=g,
                         device=dev).to(kv_dt)
        perm = torch.randperm(pool, generator=g, device=dev).cpu()
        pt = torch.full((b, J), -1, dtype=torch.int32)
        n = 0
        for i, cl in enumerate(clens):
            for j in range(-(-cl // page)):
                pt[i, j] = int(perm[n])
                n += 1
        if holes:
            pt[0, 1] = -1                     # an unmapped page inside clen
        pt = pt.to(dev)
        cl = torch.tensor(clens, dtype=torch.int32, device=dev)
        out = ops.paged_attention_fwd(q, kp, vp, pt, cl)
        torch.cuda.synchronize()
        want = ref.paged_attention_fwd_ref(q, kp, vp, pt, cl)
        e = check_close(f"K6 {label}", out, want, atol, atol)
        for i, c in enumerate(clens):
            if c == 0 and float(out[i].abs().max()) != 0.0:
                raise AssertionError("K6: a lane with no live page is not 0")
        say("kernels", kernel="K6", case=label.replace(" ", "_"),
            max_abs_err=f"{e:.3e}", tol=atol)
        return (e if path else 0.0), (q, kp, vp, pt, cl)

    cases = [
        ("main b4 J66 page16", [1056, 700, 1024, 513], 15, 5, 64, 16, 66,
         528, torch.bfloat16, False, 1e-4, True),
        ("holes empty-lane", [37, 0, 1, 64], 15, 5, 64, 16, 66, 528,
         torch.bfloat16, True, 1e-4, True),
        ("page4 hd16 fp32", [4, 7, 13, 16], 4, 2, 16, 4, 4, 12,
         torch.float32, False, 1e-4, True),
        ("page64 hd128", [300, 129], 8, 1, 128, 64, 8, 16, torch.bfloat16,
         False, 1e-4, True),
    ]
    worst, timed = 0.0, None
    for c in cases:
        e, inp = run_case(*c)
        worst = max(worst, e)
        timed = timed or inp
    q, kp, vp, pt, cl = timed
    b, n_q, hd = q.shape
    page, n_kv = kp.shape[1], kp.shape[2]
    ms = cuda_ms(lambda: ops.paged_attention_fwd(q, kp, vp, pt, cl))
    plain_ms = cuda_ms(lambda: ref.paged_attention_fwd_ref(q, kp, vp, pt,
                                                           cl))
    # library yardstick: SDPA over the pages gathered beforehand (the
    # gather itself is not timed), lengths as a boolean mask
    kg, vg = (t.float().repeat_interleave(n_q // n_kv, dim=2).transpose(1, 2)
              for t in ref.gather_pages(kp, vp, pt))
    T = kg.shape[2]
    am = (torch.arange(T, device=dev)[None, :] < cl[:, None])[:, None, None]
    qs = q[:, :, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=am))
    live_tok = float(cl.sum())
    live_pages = float(sum(-(-int(c) // page) for c in cl.tolist()))
    kv_bytes = 2.0 * live_pages * page * n_kv * hd * kp.element_size()
    nbytes = kv_bytes + 4.0 * (2 * b * n_q * hd + pt.numel() + b)
    flops = 4.0 * hd * n_q * live_tok
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                max_abs_err=worst, tol=1e-4, bound=bound(flops, nbytes),
                shape=f"b{b} nq{n_q} nkv{n_kv} hd{hd} page{page} "
                      f"J{pt.shape[1]} q fp32 pool bf16")


# ---------------------------------------------------------------------------
# phase 3c / 3d: the backward kernels vs their plain versions
# ---------------------------------------------------------------------------
def rel_err(name: str, got, want, rtol: float) -> float:
    """Max |got - want| after checking it against ``rtol`` x max|want| (the
    backward sums over up to 2048 rows; entries near 0 carry the absolute
    rounding of the large ones)."""
    import torch
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    lim = rtol * float(want.abs().max())
    if err > lim:
        raise AssertionError(f"{name}: max |err| {err:.3e} exceeds "
                             f"{rtol} x max|plain| = {lim:.3e}")
    return err


def check_attention_backward(torch, F):
    """K2a and K2b at the training shapes (q [2, 1024, 15, 64], kv [2, 1024,
    5, 64]) and at edge cases, each against the plain backward."""
    from repro_torch.kernels.block_sparse_attention import ops, ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4)
    # (label, b, s, hq, hkv, d, block, density, dtype, rtol, main path)
    cases = [
        ("main dense-causal blk128", 2, 1024, 15, 5, 64, 128, 1.0,
         torch.float32, 2e-4, True),
        ("blk512 dead-tiles", 2, 1024, 15, 5, 64, 512, 0.5, torch.float32,
         2e-4, True),
        ("partial s1000 masked-rows", 2, 1000, 15, 5, 64, 128, 0.6,
         torch.float32, 2e-4, True),
        ("bf16 s1024", 2, 1024, 15, 5, 64, 128, 1.0, torch.bfloat16, 3e-2,
         False),
    ]
    worst = {"dq": 0.0, "dkv": 0.0}
    timed = None
    for label, b, s, hq, hkv, d, block, dens, dt, rtol, path in cases:
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev)
                   .mul(0.5).to(dt) for h in (hq, hkv, hkv))
        n = -(-s // block)
        m = (torch.rand((b, 1, n, n), generator=g, device=dev)
             < dens).to(torch.int32)
        if dens < 1.0:
            m[..., 0, 0] = 1
        if label.startswith("partial"):
            m[:, :, 2, :] = 0                     # fully masked q rows
        out, lse = ops.block_sparse_attention_fwd(q, k, v, m, block=block)
        dout = torch.randn(out.shape, generator=g, device=dev).to(dt)
        delta = ((dout.float() * out.float()).sum(-1).transpose(1, 2)
                 .contiguous())
        dq = ops.block_sparse_attention_bwd_dq(q, k, v, m, dout, lse, delta,
                                               block=block)
        dk, dv = ops.block_sparse_attention_bwd_dkv(q, k, v, m, dout, lse,
                                                    delta, block=block)
        torch.cuda.synchronize()
        rdq, rdk, rdv = ref.block_sparse_attention_bwd_ref(
            q, k, v, m, dout, lse, delta, block=block)
        e_dq = rel_err(f"K2a {label} dq", dq, rdq, rtol)
        e_dkv = max(rel_err(f"K2b {label} dk", dk, rdk, rtol),
                    rel_err(f"K2b {label} dv", dv, rdv, rtol))
        if label.startswith("partial") and bool(
                dq[:, 256:384].abs().max() != 0):
            raise AssertionError("K2a: fully masked rows have nonzero dq")
        if path:
            worst["dq"] = max(worst["dq"], e_dq)
            worst["dkv"] = max(worst["dkv"], e_dkv)
        say("kernels", kernel="K2a/K2b", case=label.replace(" ", "_"),
            dq_err=f"{e_dq:.3e}", dkv_err=f"{e_dkv:.3e}",
            tol=f"{rtol}*max|plain|")
        if timed is None:
            timed = (q, k, v, m, dout, lse, delta, block)
    q, k, v, m, dout, lse, delta, block = timed
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    args = (q, k, v, m, dout, lse, delta)
    ms_dq = cuda_ms(lambda: ops.block_sparse_attention_bwd_dq(
        *args, block=block))
    ms_dkv = cuda_ms(lambda: ops.block_sparse_attention_bwd_dkv(
        *args, block=block))
    plain_dq = cuda_ms(lambda: ref.block_sparse_attention_bwd_dq_ref(
        *args, block=block))
    plain_dkv = cuda_ms(lambda: ref.block_sparse_attention_bwd_dkv_ref(
        *args, block=block))
    # library yardstick: SDPA forward + backward through autograd minus its
    # forward, kv heads repeated beforehand (not timed); it computes dq,
    # dk and dv together, so it stands beside both sweeps
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt, vt = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
              .detach().requires_grad_(True) for t in (k, v))
    dot = dout.transpose(1, 2)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    lib_ms = cuda_ms(fwd_bwd) - fwd_ms
    pairs = b * hq * s * (s + 1) / 2            # live causal (q, k) pairs
    flop = 2.0 * d * pairs                      # one d-long product
    # each sweep reads q, k, v, dout, lse, delta once and writes its output
    in_bytes = 4.0 * (2 * b * s * hq * d + 2 * b * s * hkv * d
                      + 2 * b * hq * s)
    shape = f"b{b} s{s} hq{hq} hkv{hkv} d{d} block{block} causal fp32"
    common = dict(library_ms=lib_ms, library_covers="K2a+K2b (SDPA bwd)",
                  tol="2e-4*max|plain|", shape=shape)
    return {
        # K2a needs s, dp and dq: three products per live pair
        "block_sparse_attention_bwd_dq": dict(
            ms=ms_dq, plain_ms=plain_dq, max_abs_err=worst["dq"],
            bound=bound(3 * flop, in_bytes + 4.0 * b * s * hq * d),
            **common),
        # K2b needs s, dp, dk and dv: four
        "block_sparse_attention_bwd_dkv": dict(
            ms=ms_dkv, plain_ms=plain_dkv, max_abs_err=worst["dkv"],
            bound=bound(4 * flop, in_bytes + 8.0 * b * s * hkv * d),
            **common),
    }


def check_pruned_matmul_backward(torch):
    """K3's backward products at the training shapes (M = 2048 tokens per
    microbatch; the up projection masks N = 2560, the down projection K =
    2560), dense and 87 % pruned, against torch.matmul on the same inputs."""
    from repro_torch.kernels.pruned_matmul import ops
    from repro_torch.kernels.pruned_matmul.backward import pruned_matmul_bwd
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    M, D, FF = 2048, 960, 2560
    worst, times = 0.0, {}
    for axis in ("n", "k"):
        K, N = (D, FF) if axis == "n" else (FF, D)
        x = torch.randn((M, K), generator=g, device=dev)
        w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
        gr = torch.randn((M, N), generator=g, device=dev)
        for dens in (1.0, 0.13):
            m = (torch.rand((FF // 128,), generator=g, device=dev)
                 < dens).float()
            m[0] = 1.0
            b0 = ops.KERNEL.launches_bwd
            dx, dw = pruned_matmul_bwd(x, w, m, gr, mask_axis=axis, blk=128)
            torch.cuda.synchronize()
            if ops.KERNEL.launches_bwd != b0 + 2:
                raise AssertionError("K3 backward did not launch twice")
            me = m.repeat_interleave(128)
            if axis == "n":
                wx, ww = (gr * me) @ w.T, x.T @ (gr * me)
            else:
                wx, ww = (gr @ w.T) * me, (x.T @ gr) * me[:, None]
            e = max(rel_err(f"K3 bwd {axis} {dens} dx", dx, wx, 2e-4),
                    rel_err(f"K3 bwd {axis} {dens} dw", dw, ww, 2e-4))
            worst = max(worst, e)
            say("kernels", kernel="K3-bwd", case=f"mask_{axis}_keep{dens}",
                max_abs_err=f"{e:.3e}", tol="2e-4*max|plain|")
            if axis == "n":
                kw = dict(mask_axis=axis, blk=128)
                keep = float(m.mean())
                times[dens] = dict(
                    ms=cuda_ms(lambda: pruned_matmul_bwd(x, w, m, gr, **kw)),
                    plain_ms=cuda_ms(lambda: ((gr * me) @ w.T,
                                              x.T @ (gr * me))),
                    library_ms=cuda_ms(lambda: (gr @ w.T, x.T @ gr)),
                    bound=bound(2 * 2.0 * M * K * N * keep,
                                4.0 * (2 * M * K + 2 * K * N + M * N)),
                    keep=keep)
    dense, pruned = times[1.0], times[0.13]
    return dict(bwd_ms=dense["ms"], bwd_plain_ms=dense["plain_ms"],
                bwd_library_ms=dense["library_ms"],
                bwd_bound=dense["bound"], bwd_max_abs_err=worst,
                bwd_pruned_ms=pruned["ms"],
                bwd_pruned_bound=pruned["bound"],
                bwd_pruned_keep=pruned["keep"],
                bwd_shape=f"dx+dw M{M} K{D} N{FF} mask n fp32")


# ---------------------------------------------------------------------------
# phase 3e: the grouped expert matmul (K4) and its weight gradient (K5)
# ---------------------------------------------------------------------------
def route_counts(torch, g, b: int, s: int, E: int, K: int, cap: int):
    """Live rows per (batch row, expert) group from a seeded top-K router:
    each group keeps its first ``cap`` routed pairs."""
    import torch.nn.functional as F
    logits = torch.randn((b, s, E), generator=g, device="cuda")
    sel = logits.topk(K, dim=-1).indices
    load = F.one_hot(sel, E).sum(dim=(1, 2))                   # [b, E]
    return load.clamp(max=cap).reshape(b * E).to(torch.int32)


def gm_close(name: str, got, want) -> float:
    """fp32 outputs within 1e-4 of the plain version's largest entry (sums
    over up to 14336 terms); bf16 outputs within one bf16 rounding of it
    (both round the same fp32 sum once: 2^-7 relative, 1e-2 near 0)."""
    import torch
    if got.dtype == torch.float32:
        return rel_err(name, got, want, 1e-4)
    return check_close(name, got, want, 1e-2, 2 ** -7)


def check_grouped_matmul(torch):
    """K4 and K5 against their plain versions at the MoE paths' shapes and
    at edge shapes, each case with its kernel / plain / library times and
    its bound: the train shapes (bf16, the 4e path), the serve prefill and
    decode shapes (fp32, the 4f path), edge cases (empty and full groups,
    cap off the row tile, a placement, garbage in dead rows)."""
    from repro_torch.kernels.grouped_matmul import ops, ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(8)
    E, TOPK, D, FF = 8, 2, 4096, 14336
    TOL = "1e-4*max|plain| fp32; 2^-7 rel + 1e-2 bf16"

    def live_mask(counts, cap):
        return (torch.arange(counts.numel() * cap, device=dev) % cap
                < counts.repeat_interleave(cap))

    def peak(dt):
        return PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_FP32_FLOPS

    def timed(fn, big):
        return cuda_ms(fn, warmup=2, iters=5) if big else cuda_ms(fn)

    times, worst = {}, {"k4": 0.0, "k5": 0.0}

    # K4: (label, b, s, cap, K, N, dtype, placement, transposed w, path)
    k4_cases = [
        ("train ewg fwd", 2, 1024, 320, D, FF, torch.bfloat16, False, False,
         True),
        ("train ewo fwd", 2, 1024, 320, FF, D, torch.bfloat16, False, False,
         True),
        ("train ewg dx", 2, 1024, 320, FF, D, torch.bfloat16, False, True,
         True),
        ("serve prefill ewg fwd fp32", 4, 1024, 320, D, FF, torch.float32,
         False, False, True),
        ("decode fp32", 4, 1, 8, D, FF, torch.float32, False, False, True),
        ("train ewg fwd fp32 placement", 2, 1024, 320, D, FF,
         torch.float32, True, False, False),
        ("edges cap200 fp32 placement", 2, 640, 200, 512, 640,
         torch.float32, True, False, False),
    ]
    for label, b, s, cap, K, N, dt, placed, trans, path in k4_cases:
        counts = route_counts(torch, g, b, s, E, TOPK, cap)
        if label.startswith("edges"):
            counts[0], counts[1] = 0, cap          # empty and full groups
        G = b * E
        x = torch.randn((G * cap, K), generator=g, device=dev).to(dt)
        x[~live_mask(counts, cap)] = 1e3           # garbage in dead rows
        # dx reads w [E, D, FF] through its transposed view [E, FF, D]
        w = (torch.randn((E, N, K) if trans else (E, K, N), generator=g,
                         device=dev) * K ** -0.5).to(dt)
        if trans:
            w = w.transpose(1, 2)
        wmap = (torch.randperm(E, generator=g, device=dev).to(torch.int32)
                if placed else None)
        out = ops.grouped_product(x, w, counts, cap, wmap)
        torch.cuda.synchronize()
        want = ref.grouped_product_ref(x, w, counts, cap, wmap)
        e = gm_close(f"K4 {label}", out, want)
        if bool(out[~live_mask(counts, cap)].any()):
            raise AssertionError(f"K4 {label}: dead rows are not zero")
        if path:
            worst["k4"] = max(worst["k4"], e)
        del out, want
        big = K * N > 1 << 24
        # library yardstick: one bmm over [G, cap, K] x w[g % E], the
        # weights gathered beforehand (not timed); it pays full capacity
        idx = torch.arange(G, device=dev) % E
        wg = w[idx if wmap is None else wmap.long()[idx]]
        x3 = x.view(G, cap, K)
        live = float(counts.sum())
        elt = x.element_size()
        experts = int((counts.reshape(b, E).sum(0) > 0).sum())
        nbytes = (elt * (live * K + experts * K * N + G * cap * N)
                  + 4 * G)
        times[label] = r = dict(
            ms=timed(lambda: ops.grouped_product(x, w, counts, cap, wmap),
                     big),
            plain_ms=timed(lambda: ref.grouped_product_ref(
                x, w, counts, cap, wmap), big),
            library_ms=timed(lambda: torch.bmm(x3, wg), big),
            bound=bound(2.0 * live * K * N, nbytes, peak(dt)),
            shape=f"G{G} cap{cap} K{K} N{N} live{int(live)} "
                  f"{str(dt)[6:]}" + (" w^T view" if trans else "")
                  + (" placement" if placed else ""))
        say("kernels", kernel="K4", case=label.replace(" ", "_"),
            shape=repr(r["shape"]), ms=f"{r['ms']:.4f}",
            plain_ms=f"{r['plain_ms']:.4f}",
            library_ms=f"{r['library_ms']:.4f}",
            bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1],
            max_abs_err=f"{e:.3e}", tol=repr(TOL))
        del x, w, wg, x3

    # K5: (label, b, s, cap, K, N, dtype, out dtype, placement, path)
    k5_cases = [
        ("train ewg dw", 2, 1024, 320, D, FF, torch.bfloat16,
         torch.float32, False, True),
        ("train ewo dw", 2, 1024, 320, FF, D, torch.bfloat16,
         torch.float32, False, True),
        ("train ewg dw bf16-out placement", 2, 1024, 320, D, FF,
         torch.bfloat16, torch.bfloat16, True, True),
        ("edges cap200 fp32 placement", 2, 640, 200, 512, 640,
         torch.float32, torch.float32, True, False),
        ("decode cap8 fp32", 4, 1, 8, 512, 640, torch.float32,
         torch.float32, False, False),
    ]
    for label, b, s, cap, K, N, dt, out_dt, placed, path in k5_cases:
        counts = route_counts(torch, g, b, s, E, TOPK, cap)
        if label.startswith("edges"):
            counts[0], counts[1] = 0, cap
        G = b * E
        dead = ~live_mask(counts, cap)
        x = torch.randn((G * cap, K), generator=g, device=dev).to(dt)
        gr = torch.randn((G * cap, N), generator=g, device=dev).to(dt)
        x[dead], gr[dead] = 1e3, -1e3              # garbage in dead rows
        gmap = (torch.randperm(E, generator=g, device=dev).to(torch.int32)
                if placed else None)
        dw = ops.grouped_product_dw(x, gr, counts, cap, E, gmap,
                                    out_dtype=out_dt)
        torch.cuda.synchronize()
        want = ref.grouped_product_dw_ref(x, gr, counts, cap, E, gmap,
                                          out_dtype=out_dt)
        e = gm_close(f"K5 {label}", dw, want)
        if not torch.equal(ops.grouped_product_dw(x, gr, counts, cap, E,
                                                  gmap, out_dtype=out_dt),
                           dw):
            raise AssertionError(f"K5 {label}: two runs differ")
        if path:
            worst["k5"] = max(worst["k5"], e)
        del dw, want
        big = K * N > 1 << 24
        # library yardstick: one bmm over the [E, b*cap, K]^T x [E, b*cap,
        # N] views, made beforehand with dead rows zeroed (not timed); it
        # pays full capacity
        xz = torch.where(dead[:, None], 0, x)
        gz = torch.where(dead[:, None], 0, gr)
        xe = (xz.view(b, E, cap, K).transpose(0, 1).reshape(E, b * cap, K)
              .transpose(1, 2))
        ge = gz.view(b, E, cap, N).transpose(0, 1).reshape(E, b * cap, N)
        live = float(counts.sum())
        nbytes = (x.element_size() * live * (K + N)
                  + (2 if out_dt == torch.bfloat16 else 4) * E * K * N)
        times[label] = r = dict(
            ms=timed(lambda: ops.grouped_product_dw(
                x, gr, counts, cap, E, gmap, out_dtype=out_dt), big),
            plain_ms=timed(lambda: ref.grouped_product_dw_ref(
                x, gr, counts, cap, E, gmap, out_dtype=out_dt), big),
            library_ms=timed(lambda: torch.bmm(xe, ge), big),
            bound=bound(2.0 * live * K * N, nbytes, peak(dt)),
            shape=f"E{E} b{b} cap{cap} K{K} N{N} live{int(live)} "
                  f"{str(dt)[6:]} -> {str(out_dt)[6:]}"
                  + (" placement" if placed else ""))
        say("kernels", kernel="K5", case=label.replace(" ", "_"),
            shape=repr(r["shape"]), ms=f"{r['ms']:.4f}",
            plain_ms=f"{r['plain_ms']:.4f}",
            library_ms=f"{r['library_ms']:.4f}",
            bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1],
            max_abs_err=f"{e:.3e}", tol=repr(TOL), bitwise_repeat=True)
        del x, gr, xz, gz, xe, ge
    free_cuda(torch)

    def entry(main, worst_err, cases):
        r = times[main]
        return dict(ms=r["ms"], plain_ms=r["plain_ms"],
                    library_ms=r["library_ms"], max_abs_err=worst_err,
                    tol=TOL, bound=r["bound"], shape=r["shape"],
                    library_covers="torch.bmm at full capacity",
                    cases={k: {"ms": times[k]["ms"],
                               "plain_ms": times[k]["plain_ms"],
                               "library_ms": times[k]["library_ms"],
                               "bound_ms": times[k]["bound"][0],
                               "bound_by": times[k]["bound"][1],
                               "shape": times[k]["shape"]} for k in cases})
    return {
        "grouped_matmul": entry(
            "train ewg fwd", worst["k4"],
            [c[0] for c in k4_cases]),
        "grouped_matmul_dw": entry(
            "train ewg dw", worst["k5"], [c[0] for c in k5_cases]),
    }


# ---------------------------------------------------------------------------
# phase 4b: device time by kernel over a short serve
# ---------------------------------------------------------------------------
OURS = re.compile(r"\b(bsa_fwd_kernel|bsa_dq_kernel|bsa_dkv_kernel|"
                  r"pm_kernel|paged_attn_kernel|gm_kernel|gm_dw_kernel)<")


def device_times(events):
    """{kernel name: device ms} over the DEVICE-side entries of a
    profiler's key averages.  A host op (``aten::mm``, an autograd
    Function such as ``_PrunedMatmul``) also carries the device time of the
    kernels it launched; counting it beside the kernels would count that
    time twice."""
    from torch.autograd import DeviceType
    dev = {}
    for e in events:
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            dev[e.key] = dev.get(e.key, 0.0) + t / 1e3          # ms
    return dev


def profile_serve(torch):
    """Device time by kernel over a 4-request serve under torch.profiler,
    against the wall time of the same serve run without the profiler (whose
    own host overhead would otherwise swamp the busy share)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import run as serve_run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_run(serve_args(4))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep = serve_run(serve_args(4))
        torch.cuda.synchronize()
    dev = device_times(prof.key_averages())
    busy = sum(dev.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    ours = sum(v for k, v in dev.items() if OURS.search(k))
    return {"requests": len(rep["completions"]),
            "wall_ms_unprofiled": f"{wall_ms:.1f}",
            "device_busy_ms": f"{busy:.1f}",
            "busy_share": f"{busy / wall_ms:.3f}",
            "port_kernels_ms": f"{ours:.1f}",
            "top": json.dumps([[k[:48], round(v, 2)] for k, v in top])
            .replace(" ", "")}


def profile_train(torch, args_fn=None):
    """Device time by kernel over two train steps (``args_fn(2)``'s flags,
    smollm's by default) under torch.profiler, against the wall time of
    the same two steps without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train import run as train_run
    args_fn = args_fn or train_args
    rep = train_run(args_fn(2))
    torch.cuda.synchronize()
    wall_ms = rep["wall_s"] * 1e3
    del rep
    free_cuda(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep = train_run(args_fn(2))
        torch.cuda.synchronize()
    prof_wall_ms = rep["wall_s"] * 1e3
    del rep
    free_cuda(torch)
    dev = device_times(prof.key_averages())
    busy = sum(dev.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    ours = sum(v for k, v in dev.items() if OURS.search(k))
    return {"steps": 2, "wall_ms_unprofiled": f"{wall_ms:.1f}",
            "wall_ms_profiled": f"{prof_wall_ms:.1f}",
            "device_busy_ms": f"{busy:.1f}",
            "busy_share": f"{busy / wall_ms:.3f}",
            "port_kernels_ms": f"{ours:.1f}",
            "top": json.dumps([[k[:48], round(v, 2)] for k, v in top])
            .replace(" ", "")}


def free_cuda(torch):
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: one engine state through the kernels and through the plain
# versions
# ---------------------------------------------------------------------------
class PlainKernels:
    """Route every kernel launch of the model to its plain version on the
    card (for the parity phases only): K1's forward, the K2a / K2b backward,
    every K3 product (forward and backward), every K4 product (forward and
    as dx), K5 and K6."""

    def __enter__(self):
        from repro_torch.kernels.block_sparse_attention import ops as bsa
        from repro_torch.kernels.block_sparse_attention import ref as bsa_ref
        from repro_torch.kernels.grouped_matmul import ops as gm
        from repro_torch.kernels.grouped_matmul import ref as gm_ref
        from repro_torch.kernels.paged_attention import ops as pa
        from repro_torch.kernels.paged_attention import ref as pa_ref
        from repro_torch.kernels.pruned_matmul import ops as pm
        from repro_torch.kernels.pruned_matmul import ref as pm_ref

        def bsa_fwd(q, k, v, m, *, causal=True, block=128):
            return bsa_ref.block_sparse_attention_ref(
                q, k, v, m, causal=causal, block=block)

        def bsa_bwd(q, k, v, m, dout, lse, delta, *, causal=True,
                    block=128):
            return bsa_ref.block_sparse_attention_bwd_ref(
                q, k, v, m, dout.to(q.dtype), lse, delta, causal=causal,
                block=block)

        def pm_product(x, w, m, mask_axis, blk, *, bwd=False, out=None):
            res = pm_ref.pruned_matmul_ref(x, w, m, mask_axis=mask_axis,
                                           bn=blk, bk=blk)
            return res if out is None else out.copy_(res)

        def pa_plain(q, kp, vp, pt, cl):
            return pa_ref.paged_attention_fwd_ref(q[:, 0], kp, vp, pt,
                                                  cl)[:, None]

        def gm_product(x, w, counts, cap, wmap=None, *, bwd=False):
            return gm_ref.grouped_product_ref(x, w, counts, cap, wmap)

        def gm_product_dw(x, g, counts, cap, num_experts, gmap=None, *,
                          out_dtype=None):
            return gm_ref.grouped_product_dw_ref(x, g, counts, cap,
                                                 num_experts, gmap,
                                                 out_dtype=out_dtype)

        self._saved = [(bsa, "block_sparse_attention_fwd", bsa_fwd),
                       (bsa, "block_sparse_attention_bwd", bsa_bwd),
                       (pm, "product", pm_product),
                       (gm, "grouped_product", gm_product),
                       (gm, "grouped_product_dw", gm_product_dw),
                       (pa, "paged_attention", pa_plain)]
        self._orig = [getattr(mod, name) for mod, name, _ in self._saved]
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self._saved, self._orig):
            setattr(mod, name, fn)


def parity_run(torch, plain: bool, moe: bool = False):
    """Prefill [2, 4, 1024] tokens and 8 teacher-forced decode steps at
    full width — smollm-360m with paged KV, or (``moe``) Mixtral-8x7B cut
    to 2 layers with contiguous KV; returns (prefill ids, decode ids [8, m,
    B], decode logprobs, decode logits)."""
    from repro_torch import kernels
    from repro_torch.configs import DistConfig, get_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline import PipelineShapes
    from repro_torch.serve.kv import PagedKVConfig

    cfg = get_config(moe_arch(2) if moe else "smollm-360m")
    dcfg = DistConfig(num_stages=1, slot_slack=0 if moe else 2,
                      remat="none", param_dtype="float32",
                      kernel_impl="pallas")
    m, B, s, gen, page = 2, 4, 1024, 8, 16
    shapes = PipelineShapes(m, B, s, cache_len=s + 32)
    J = shapes.cache_len // page
    paged = None if moe else PagedKVConfig(page_size=page,
                                           pool_pages=m * B * J)
    dyncfg = DynamicsConfig(kind="moe" if moe else "sparse_attention")
    eng = ElasticEngine(cfg, dcfg, dyncfg, shapes, paged=paged,
                        device="cuda")
    st = eng.init_state(0, with_cache=True)
    g = torch.Generator(device="cpu").manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (m, B, s + gen), generator=g)
    table = torch.arange(m * B * J, dtype=torch.int32).reshape(m, B, J)
    logits = []
    orig = M.lm_logits

    def recording(params, cfg_, h):
        out = orig(params, cfg_, h)
        logits.append(out)
        return out

    M.lm_logits = recording
    before = [k.launches for k in kernels.KERNELS]
    try:
        if paged is None:
            pf_ids, _ = eng.prefill(st, {"tokens": toks[:, :, :s]})
        else:
            scratch = eng.make_dense_scratch(1)
            pf_ids, scratch = eng.prefill(st, {"tokens": toks[:, :, :s]},
                                          cache=scratch)
            eng.pack_pages(st, scratch, table,
                           torch.ones((m, B, J), dtype=torch.bool))
            del scratch
        ids, lps = [], []
        logits.clear()
        for i in range(gen):
            pos = torch.full((m, B), s + i, dtype=torch.int32)
            d_ids, d_lp = eng.decode(st, toks[:, :, s + i], pos,
                                     page_table=None if paged is None
                                     else table)
            ids.append(d_ids)
            lps.append(d_lp)
        torch.cuda.synchronize()
    finally:
        M.lm_logits = orig
    launched = [k.launches - b for k, b in zip(kernels.KERNELS, before)]
    if plain and any(launched):
        raise AssertionError(f"plain parity run launched kernels {launched}")
    serving = (MOE_SERVE_PATH if moe else
               ("block_sparse_attention", "pruned_matmul", "paged_attention"))
    if not plain and not all(n for k, n in zip(kernels.KERNELS, launched)
                             if k.name in serving):
        raise AssertionError(f"kernel parity run missed a kernel {launched}")
    dec_logits = torch.stack(logits).reshape(gen, m, B, -1)
    del eng, st
    return pf_ids, torch.stack(ids), torch.stack(lps), dec_logits


def train_parity_run(torch, plain: bool, moe: bool = False):
    """Loss and gradients of one training step (value_and_grad of the
    pipelined loss) at full widths: smollm-360m with 4 layers, 2 stage
    buffers, 4 x 2 x 1024 tokens, half the FFN blocks pruned — or (``moe``)
    Mixtral-8x7B cut to 2 layers, one per stage buffer, 2 x 2 x 1024
    tokens; fp32; returns (loss, grads)."""
    from repro_torch import kernels
    from repro_torch.configs import DistConfig, get_config
    from repro_torch.data.loader import DataConfig, make_loader
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.pipeline.pipeline import (PipelineShapes,
                                               build_loss_fn,
                                               value_and_grad)
    if moe:
        cfg = get_config(moe_arch(2))
        dcfg = DistConfig(num_stages=2, slot_slack=0, remat="none",
                          param_dtype="float32", kernel_impl="pallas")
        dyncfg = DynamicsConfig(kind="moe")
        shapes = PipelineShapes(2, 2, 1024)
    else:
        cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=4)
        dcfg = DistConfig(num_stages=2, slot_slack=2, remat="none",
                          param_dtype="float32", kernel_impl="pallas")
        dyncfg = DynamicsConfig(kind="pruning")
        shapes = PipelineShapes(4, 2, 1024)
    eng = ElasticEngine(cfg, dcfg, dyncfg, shapes, device="cuda")
    st = eng.init_state(0)
    if not moe:
        g = torch.Generator(device="cpu").manual_seed(6)
        st.dyn["ff_mask"] = (torch.rand(st.dyn["ff_mask"].shape,
                                        generator=g) < 0.5).float().cuda()
    batch = eng._batch(next(make_loader(cfg, DataConfig(
        shapes.num_micro, shapes.mb_global, shapes.seq))))
    loss_fn = build_loss_fn(cfg, dcfg, dyncfg, shapes)
    before = [k.launches for k in kernels.KERNELS]
    loss, _, grads = value_and_grad(loss_fn, st.params, st.assignment,
                                    st.dyn, batch)
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(kernels.KERNELS, before)]
    if plain and any(launched):
        raise AssertionError(f"plain train parity run launched {launched}")
    want = ({"grouped_matmul", "grouped_matmul_dw"} if moe else
            {"block_sparse_attention", "block_sparse_attention_bwd_dq",
             "block_sparse_attention_bwd_dkv", "pruned_matmul"})
    missed = [k.name for k, n in zip(kernels.KERNELS, launched)
              if k.name in want and n == 0]
    if not plain and missed:
        raise AssertionError(f"train parity run missed {missed}")
    del eng, st, batch
    return float(loss), grads


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def run_train_phase(torch, kernels):
    """Phase 4c: the training CLI's ``run`` at train_args(); returns the
    launch counts of the run ({name: n}, K3 backward launches)."""
    from repro_torch.configs import get_config
    from repro_torch.dynamics import pruning as prn
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.dynamics.trajectories import zhu_gupta_sparsity
    from repro_torch.kernels.pruned_matmul import ops as pm
    from repro_torch.launch.train import run as train_run
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS:
        k.reset()
    rep = train_run(train_args())
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels.KERNELS}
    k3_bwd = pm.KERNEL.launches_bwd
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = rep["args"]["steps"]
    losses = rep["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if abs(losses[0] - math.log(49152)) > 1.0:
        raise AssertionError(f"step 0 loss {losses[0]:.3f} is not within 1 "
                             f"of ln(49152) = {math.log(49152):.3f}")
    missing = [n for n in TRAIN_LAUNCHES_PER_STEP if launched[n] <= 0]
    if missing:
        raise AssertionError(f"train never launched {missing}: {launched}")
    for name, per_step in TRAIN_LAUNCHES_PER_STEP.items():
        if launched[name] != per_step * steps:
            raise AssertionError(f"{name}: {launched[name]} launches in "
                                 f"{steps} steps, expected {per_step} a "
                                 f"step")
    if k3_bwd != TRAIN_K3_BWD_PER_STEP * steps:
        raise AssertionError(f"K3 backward launches {k3_bwd}, expected "
                             f"{TRAIN_K3_BWD_PER_STEP} a step")
    moved = [(e.iteration, e.moved_layers) for e in rep["events"]]
    if not any(m > 0 for _, m in moved):
        raise AssertionError(f"no rebalance moved layers: {moved}")
    # the prune at step 10 keeps the schedule's share of the FFN blocks
    cfg = get_config("smollm-360m")
    sp = zhu_gupta_sparsity(1000, dataclasses.replace(
        DynamicsConfig(kind="pruning"), prune_start_iter=0,
        prune_end_iter=steps * 100, prune_frequency=1))
    keep = prn.target_keep_blocks(cfg, cfg.total_blocks(), sp)
    active = rep["assignment"]["tags"].to("cuda") != 0
    ff = rep["dyn"]["ff_mask"][active]
    if abs(float(ff.mean()) - keep / ff.numel()) > 1e-6:
        raise AssertionError(f"ff_active {float(ff.mean()):.4f} != target "
                             f"{keep}/{ff.numel()}")
    st = rep["step_times"]
    say("train", steps=steps, tokens_per_step=rep["tokens_per_step"],
        tokens_per_s=f"{rep['steady_tokens_per_s']:.1f}",
        step_ms_1_9=f"{sum(st[1:10]) / 9 * 1e3:.1f}",
        step_ms_11_14=f"{sum(st[11:15]) / 4 * 1e3:.1f}",
        step0_ms=f"{st[0] * 1e3:.1f}", wall_s=f"{rep['wall_s']:.2f}",
        peak_mem_gb=f"{peak_gb:.2f}",
        loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}",
        losses=json.dumps([round(x, 4) for x in losses]).replace(" ", ""),
        prune_keep=f"{keep}/{ff.numel()}",
        events=json.dumps([[e.iteration, e.moved_layers,
                            round(e.imbalance_before, 4),
                            round(e.imbalance_after, 4)]
                           for e in rep["events"]]).replace(" ", ""),
        final_lps=rep["final_lps"],
        launches=json.dumps(launched).replace(" ", ""),
        k3_bwd_launches=k3_bwd)
    del rep
    free_cuda(torch)
    return launched, k3_bwd


def serve_parity(torch, moe: bool = False) -> None:
    """Phases 5 / 5c: decode ids equal wherever the plain run's top-2 gap
    exceeds 1e-3, logprobs within 1e-3 where the ids agree."""
    k_pf, k_ids, k_lp, _ = parity_run(torch, plain=False, moe=moe)
    free_cuda(torch)
    with PlainKernels():
        p_pf, p_ids, p_lp, p_logits = parity_run(torch, plain=True, moe=moe)
    free_cuda(torch)
    top2 = p_logits.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 1e-3
    if not bool((k_ids == p_ids)[decided].all()):
        raise AssertionError("decode ids differ where the plain run's "
                             "top-2 gap exceeds 1e-3")
    same = k_ids == p_ids
    lp_err = float((k_lp - p_lp).abs()[same].max())
    if lp_err > 1e-3:
        raise AssertionError(f"decode logprobs differ by {lp_err:.3e}")
    say("moe_parity" if moe else "parity",
        prefill_ids_equal=bool((k_pf == p_pf).all()),
        decode_ids_equal=f"{int(same.sum())}/{same.numel()}",
        decided=int(decided.sum()), max_logprob_err=f"{lp_err:.3e}",
        tol=1e-3)


def train_parity(torch, moe: bool = False) -> None:
    """Phases 5b / 5c: one step's loss within 1e-4 relative and every
    gradient leaf within 1e-3 of its largest entry (fp32)."""
    free_cuda(torch)
    k_loss, k_grads = train_parity_run(torch, plain=False, moe=moe)
    free_cuda(torch)
    with PlainKernels():
        p_loss, p_grads = train_parity_run(torch, plain=True, moe=moe)
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    if not (math.isfinite(k_loss) and loss_rel <= 1e-4):
        raise AssertionError(f"train loss {k_loss} vs plain {p_loss}")
    worst_leaf, n_leaves = 0.0, 0
    pg = dict(leaves(p_grads))
    for path, kg in leaves(k_grads):
        want = pg[path]
        scale = float(want.abs().max()) or 1.0
        err = float((kg - want).abs().max()) / scale
        if not (err <= 1e-3):
            raise AssertionError(f"grad {path}: max |err| / max |plain| = "
                                 f"{err:.3e} > 1e-3")
        worst_leaf = max(worst_leaf, err)
        n_leaves += 1
    say("moe_train_parity" if moe else "train_parity",
        loss=f"{k_loss:.6f}", plain_loss=f"{p_loss:.6f}",
        loss_rel_err=f"{loss_rel:.3e}", tol_loss=1e-4, leaves=n_leaves,
        worst_leaf_rel_err=f"{worst_leaf:.3e}", tol_grad="1e-3*max|plain|")
    del k_grads, p_grads, pg
    free_cuda(torch)


def moe_placement_neutrality(torch) -> None:
    """Phase 5c: moe_ffn through the kernels at full width under the
    identity placement and two permutations — y, load and the drop
    fraction bitwise equal."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import moe_ffn
    cfg = get_config("mixtral-8x7b")
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    g = torch.Generator(device="cuda").manual_seed(9)
    p = {"router": torch.randn((d, E), generator=g, device="cuda") * d ** -.5,
         "ewi": torch.randn((E, d, ff), generator=g, device="cuda") * d ** -.5,
         "ewg": torch.randn((E, d, ff), generator=g, device="cuda") * d ** -.5,
         "ewo": torch.randn((E, ff, d), generator=g, device="cuda")
         * ff ** -.5}
    x = torch.randn((2, 1024, d), generator=g, device="cuda")
    with torch.no_grad():
        base = moe_ffn(p, x, cfg, kernel_impl="pallas")
        for perm in ([3, 1, 0, 2, 7, 5, 4, 6], [7, 6, 5, 4, 3, 2, 1, 0]):
            em = torch.tensor(perm, dtype=torch.float32, device="cuda")
            got = moe_ffn(p, x, cfg, kernel_impl="pallas", expert_map=em)
            for i, name in ((0, "y"), (1, "load"), (3, "dropped")):
                if not torch.equal(got[i], base[i]):
                    raise AssertionError(f"placement {perm} changed {name}")
    say("moe_placement", placements=3, y_load_dropped_bitwise=True,
        dropped=f"{float(base[3]):.4f}",
        load=json.dumps(base[1].int().tolist()).replace(" ", ""))
    del p, x, base
    free_cuda(torch)


def run_moe_train_phase(torch, kernels):
    """Phase 4e: the training CLI's ``run`` at moe_train_args(); returns
    the launch counts of the run ({name: n})."""
    from repro_torch.kernels.grouped_matmul import ops as gm
    from repro_torch.launch.train import run as train_run
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS:
        k.reset()
    rep = train_run(moe_train_args())
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = rep["args"]["steps"]
    losses = rep["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite MoE training loss: {losses}")
    if abs(losses[0] - math.log(32000)) > 1.0:
        raise AssertionError(f"step 0 loss {losses[0]:.3f} is not within 1 "
                             f"of ln(32000) = {math.log(32000):.3f}")
    check_launches("moe train", launched, MOE_TRAIN_LAUNCHES_PER_STEP, steps)
    rl = rep["relayouts"]
    if not any(r["moved_experts"] > 0 for r in rl):
        raise AssertionError(f"no expert re-layout moved experts: {rl}")
    if not (rep["expert_skew_last"] >= 1.0
            and 0.0 <= rep["moe_dropped_last"] < 1.0):
        raise AssertionError(f"skew {rep['expert_skew_last']} / dropped "
                             f"{rep['moe_dropped_last']} out of range")
    st = rep["step_times"]
    say("moe_train", steps=steps, tokens_per_step=rep["tokens_per_step"],
        tokens_per_s=f"{rep['steady_tokens_per_s']:.1f}",
        step_ms_1_7=f"{sum(st[1:]) / (len(st) - 1) * 1e3:.1f}",
        step0_ms=f"{st[0] * 1e3:.1f}", wall_s=f"{rep['wall_s']:.2f}",
        peak_mem_gb=f"{peak_gb:.2f}",
        losses=json.dumps([round(x, 4) for x in losses]).replace(" ", ""),
        expert_skew_last=f"{rep['expert_skew_last']:.4f}",
        moe_dropped_last=f"{rep['moe_dropped_last']:.4f}",
        relayouts=json.dumps([[r["step"], r["moved_experts"],
                               round(r["skew"], 4)] for r in rl])
        .replace(" ", ""),
        expert_layout=json.dumps(rep["expert_layout"]).replace(" ", ""),
        launches=json.dumps(launched).replace(" ", ""),
        k4_dx_launches=gm.KERNEL.launches_bwd)
    del rep
    free_cuda(torch)
    return launched


def run_moe_serve_phase(torch, kernels):
    """Phase 4f: the serving CLI's ``run`` at moe_serve_args(); returns
    the launch counts of the run ({name: n})."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run as serve_run
    from repro_torch.models.blocks import moe_capacity
    from repro_torch.serve.requests import make_trace
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS:
        k.reset()
    rep = serve_run(moe_serve_args())
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels.KERNELS}
    args = rep["args"]
    comps = rep["completions"]
    if len(comps) != args["requests"]:
        raise AssertionError(f"{len(comps)} of {args['requests']} MoE "
                             f"requests completed")
    cache_len = args["prompt_len"] + args["gen"]
    budget = {r.rid: min(r.gen, cache_len - r.plen + 1)
              for r in make_trace(args["requests"],
                                  prompt_len=args["prompt_len"],
                                  max_gen=args["gen"], vocab_size=32000,
                                  seed=args["seed"],
                                  min_prompt=args["prompt_len"] // 2)}
    for c in comps:
        if len(c["tokens"]) != budget[c["rid"]]:
            raise AssertionError(f"MoE request {c['rid']}: "
                                 f"{len(c['tokens'])} tokens, budget "
                                 f"{budget[c['rid']]}")
        if not all(0 <= t < 32000 for t in c["tokens"]):
            raise AssertionError(f"MoE request {c['rid']}: token out of "
                                 f"vocab")
    missing = [n for n in MOE_SERVE_PATH if launched[n] <= 0]
    if missing:
        raise AssertionError(f"MoE serve never launched {missing}: "
                             f"{launched}")
    drop = rep["moe_dropped_mean"]
    if drop is None or not 0.0 <= drop < 1.0:
        raise AssertionError(f"moe_dropped_mean {drop} not in [0, 1)")
    say("moe_serve", requests=len(comps), tokens=rep["total_tokens"],
        ticks=rep["ticks"], tokens_per_s=f"{rep['tokens_per_s']:.1f}",
        p50_ms=f"{rep['latency_p50_s'] * 1e3:.1f}",
        p95_ms=f"{rep['latency_p95_s'] * 1e3:.1f}",
        wall_s=f"{rep['wall_s']:.2f}",
        max_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        moe_dropped_mean=f"{drop:.5f}",
        decode_cap=moe_capacity(get_config(moe_arch(4)), 1),
        launches=json.dumps(launched).replace(" ", ""))
    del rep
    free_cuda(torch)
    return launched


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false — this smoke test "
              "needs a CUDA card", flush=True)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"FAIL: {ROOT / 'src' / 'repro_torch'} not found — run "
              f"chip_smoke.py from the repository root", flush=True)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", nvidia_smi=repr(smi),
        name=repr(torch.cuda.get_device_name(0)),
        torch=torch.__version__, cuda=torch.version.cuda,
        count=torch.cuda.device_count())

    # 2. build
    from repro_torch import kernels
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    took = _build.build(kernels.KERNELS)
    say("build", seconds=f"{time.perf_counter() - t0:.1f}",
        per_kernel={k: round(v, 1) for k, v in took.items()})

    # 3. kernels vs plain versions
    results = {
        "block_sparse_attention": check_block_sparse_attention(torch, F),
        "pruned_matmul": check_pruned_matmul(torch, F),
        "paged_attention": check_paged_attention(torch, F),
    }
    # 3c / 3d. the backward kernels
    results.update(check_attention_backward(torch, F))
    results["pruned_matmul"].update(check_pruned_matmul_backward(torch))
    # 3e. the grouped expert matmul and its weight gradient
    results.update(check_grouped_matmul(torch))
    for name, r in results.items():
        say("kernels", kernel=name, shape=repr(r["shape"]),
            ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            library_ms=f"{r['library_ms']:.4f}",
            bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1])
    r = results["pruned_matmul"]
    say("kernels", kernel="pruned_matmul(backward dx+dw)",
        shape=repr(r["bwd_shape"]), ms=f"{r['bwd_ms']:.4f}",
        plain_ms=f"{r['bwd_plain_ms']:.4f}",
        library_ms=f"{r['bwd_library_ms']:.4f}",
        bound_ms=f"{r['bwd_bound'][0]:.4f}", bound_by=r["bwd_bound"][1],
        pruned_keep=f"{r['bwd_pruned_keep']:.3f}",
        pruned_ms=f"{r['bwd_pruned_ms']:.4f}",
        pruned_bound_ms=f"{r['bwd_pruned_bound'][0]:.4f}")

    # 4. serve: the main path, counters zeroed just before, read just after
    from repro_torch.launch.serve import run as serve_run
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS:
        k.reset()
    rep = serve_run(serve_args(12))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    args = rep["args"]
    comps = rep["completions"]
    if len(comps) != args["requests"]:
        raise AssertionError(f"{len(comps)} of {args['requests']} requests "
                             f"completed")
    cache_len = args["prompt_len"] + args["gen"]
    from repro_torch.serve.requests import make_trace
    budget = {r.rid: min(r.gen, cache_len - r.plen + 1)
              for r in make_trace(args["requests"],
                                  prompt_len=args["prompt_len"],
                                  max_gen=args["gen"], vocab_size=49152,
                                  seed=args["seed"],
                                  min_prompt=args["prompt_len"] // 2)}
    for c in comps:
        if len(c["tokens"]) != budget[c["rid"]]:
            raise AssertionError(f"request {c['rid']}: {len(c['tokens'])} "
                                 f"tokens, budget {budget[c['rid']]}")
        if not all(0 <= t < 49152 for t in c["tokens"]):
            raise AssertionError(f"request {c['rid']}: token out of vocab")
    serve_path = ("block_sparse_attention", "pruned_matmul",
                  "paged_attention")
    missing = [n for n in serve_path if launches[n] <= 0]
    if missing:
        raise AssertionError(f"serve never launched {missing}: {launches}")
    say("serve", requests=len(comps), tokens=rep["total_tokens"],
        ticks=rep["ticks"], tokens_per_s=f"{rep['tokens_per_s']:.1f}",
        p50_ms=f"{rep['latency_p50_s'] * 1e3:.1f}",
        p95_ms=f"{rep['latency_p95_s'] * 1e3:.1f}",
        wall_s=f"{rep['wall_s']:.2f}",
        max_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        launches=json.dumps(launches).replace(" ", ""),
        tiles_live=f"{rep['page_tile_live']}/{rep['page_tile_total']}")
    del rep

    # 4b. where the time goes: a shorter serve under torch.profiler (its
    # wall includes the profiler's own overhead)
    prof = profile_serve(torch)
    say("profile", **prof)

    # 4c. train: the training path, counters zeroed just before, read
    # just after
    train_launches, train_bwd = run_train_phase(torch, kernels)

    # 4d. where the time goes in training: two steps under the profiler
    say("profile_train", **profile_train(torch))

    # 4e / 4f. the MoE paths, counters zeroed just before each and read
    # just after
    moe_train_launches = run_moe_train_phase(torch, kernels)
    moe_serve_launches = run_moe_serve_phase(torch, kernels)

    # 4g. where the time goes in MoE training
    say("profile_moe_train", **profile_train(torch, moe_train_args))

    # 5. parity of the path: kernels vs plain versions from one state
    serve_parity(torch)

    # 5b. train parity: one step's loss and grads, kernels vs plain
    train_parity(torch)

    # 5c. the MoE path: train step, prefill + decode, placement neutrality
    train_parity(torch, moe=True)
    serve_parity(torch, moe=True)
    moe_placement_neutrality(torch)

    # 6. the kernels line, the card line, the last line
    line = []
    for k in kernels.KERNELS:
        r = results[k.name]
        entry = {
            "name": k.name, "route": "cuda", "source": k.relpath(),
            "replaces": k.replaces, "tpu_kernel": k.replaces,
            "launches": (launches[k.name] + train_launches[k.name]
                         + moe_train_launches[k.name]
                         + moe_serve_launches[k.name]),
            "launches_serve": launches[k.name],
            "launches_train": train_launches[k.name],
            "launches_moe_train": moe_train_launches[k.name],
            "launches_moe_serve": moe_serve_launches[k.name],
            "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
            "tolerance": r["tol"], "ms": r["ms"], "kernel_ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "shape": r["shape"]}
        for key in ("library_covers", "cases"):
            if key in r:
                entry[key] = r[key]
        if k.name == "pruned_matmul":
            entry.update(
                launches_train_bwd=train_bwd, bwd_ms=r["bwd_ms"],
                bwd_plain_ms=r["bwd_plain_ms"],
                bwd_library_ms=r["bwd_library_ms"],
                bwd_bound_ms=r["bwd_bound"][0],
                bwd_bound_by=r["bwd_bound"][1],
                bwd_max_abs_err=r["bwd_max_abs_err"],
                bwd_pruned_ms=r["bwd_pruned_ms"],
                bwd_pruned_bound_ms=r["bwd_pruned_bound"][0],
                bwd_shape=r["bwd_shape"])
        line.append(entry)
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
