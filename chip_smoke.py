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
  4. serve   — the port's serving path through its CLI entry point:
               full-width smollm-360m, one stage, paged KV + prefix cache,
               sparse attention, kernel_impl "pallas"; launch counters are
               zeroed just before and read just after, and every kernel of
               the path must have launched;
  4b. profile — device time by kernel over a shorter serve (4 requests)
               under torch.profiler, and the device's busy share against
               the same serve's wall time without the profiler;
  5. parity  — one prefill and 8 teacher-forced decode steps from one engine
               state, through the kernels and through the plain versions;
  6. the kernels line (JSON), the card line, and the last line
     {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet) used for the roofline bound
PEAK_FP32_FLOPS = 67e12      # fp32 on the CUDA cores: every kernel here
PEAK_BYTES = 3.35e12         # HBM3

def serve_args(requests: int):
    """The main path's CLI flags: full-width smollm-360m on one stage."""
    return ["--elastic", "--stages", "1", "--micro", "2", "--mb-global", "4",
            "--prompt-len", "1024", "--gen", "32", "--requests",
            str(requests), "--kv-page-size", "16", "--prefix-cache",
            "--dynamism", "sparse_attention", "--kernel-impl", "pallas",
            "--param-dtype", "float32", "--seed", "0"]


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


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
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
# phase 4b: device time by kernel over a short serve
# ---------------------------------------------------------------------------
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
    dev = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            dev[e.key] = dev.get(e.key, 0.0) + t / 1e3          # ms
    busy = sum(dev.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    ours = sum(v for k, v in dev.items() if re.search(
        r"\b(bsa_fwd_kernel|pm_kernel|paged_attn_kernel)<", k))
    return {"requests": len(rep["completions"]),
            "wall_ms_unprofiled": f"{wall_ms:.1f}",
            "device_busy_ms": f"{busy:.1f}",
            "busy_share": f"{busy / wall_ms:.3f}",
            "port_kernels_ms": f"{ours:.1f}",
            "top": json.dumps([[k[:48], round(v, 2)] for k, v in top])
            .replace(" ", "")}


# ---------------------------------------------------------------------------
# phase 5: one engine state through the kernels and through the plain
# versions
# ---------------------------------------------------------------------------
class PlainKernels:
    """Route the model's three kernel calls to their plain versions on the
    card (for the parity phase only)."""

    def __enter__(self):
        from repro_torch.kernels.block_sparse_attention import ops as bsa
        from repro_torch.kernels.block_sparse_attention import ref as bsa_ref
        from repro_torch.kernels.paged_attention import ops as pa
        from repro_torch.kernels.paged_attention import ref as pa_ref
        from repro_torch.kernels.pruned_matmul import ops as pm
        from repro_torch.kernels.pruned_matmul import ref as pm_ref

        def bsa_plain(q, k, v, m, *, causal=True, block=128):
            return bsa_ref.block_sparse_attention_ref(
                q, k, v, m, causal=causal, block=block)[0]

        def pm_plain(x, w, m, *, mask_axis="n", bn=128, bk=128):
            out = pm_ref.pruned_matmul_ref(x.reshape(-1, x.shape[-1]), w, m,
                                           mask_axis=mask_axis, bn=bn, bk=bk)
            return out.reshape(*x.shape[:-1], w.shape[1])

        def pa_plain(q, kp, vp, pt, cl):
            return pa_ref.paged_attention_fwd_ref(q[:, 0], kp, vp, pt,
                                                  cl)[:, None]

        self._saved = [(bsa, "block_sparse_attention", bsa_plain),
                       (pm, "pruned_matmul", pm_plain),
                       (pa, "paged_attention", pa_plain)]
        self._orig = [getattr(mod, name) for mod, name, _ in self._saved]
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self._saved, self._orig):
            setattr(mod, name, fn)


def parity_run(torch, plain: bool):
    """Prefill [2, 4, 1024] tokens and 8 teacher-forced paged decode steps
    at full width; returns (prefill ids, decode ids [8, m, B], decode
    logprobs, decode logits)."""
    from repro_torch import kernels
    from repro_torch.configs import DistConfig, get_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline import PipelineShapes
    from repro_torch.serve.kv import PagedKVConfig

    cfg = get_config("smollm-360m")
    dcfg = DistConfig(num_stages=1, slot_slack=2, remat="none",
                      param_dtype="float32", kernel_impl="pallas")
    m, B, s, gen, page = 2, 4, 1024, 8, 16
    shapes = PipelineShapes(m, B, s, cache_len=s + 32)
    J = shapes.cache_len // page
    paged = PagedKVConfig(page_size=page, pool_pages=m * B * J)
    eng = ElasticEngine(cfg, dcfg, DynamicsConfig(kind="sparse_attention"),
                        shapes, paged=paged, device="cuda")
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
                                     page_table=table)
            ids.append(d_ids)
            lps.append(d_lp)
        torch.cuda.synchronize()
    finally:
        M.lm_logits = orig
    launched = [k.launches - b for k, b in zip(kernels.KERNELS, before)]
    if plain and any(launched):
        raise AssertionError(f"plain parity run launched kernels {launched}")
    if not plain and not all(launched):
        raise AssertionError(f"kernel parity run missed a kernel {launched}")
    dec_logits = torch.stack(logits).reshape(gen, m, B, -1)
    return pf_ids, torch.stack(ids), torch.stack(lps), dec_logits


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
    for name, r in results.items():
        say("kernels", kernel=name, shape=repr(r["shape"]),
            ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            library_ms=f"{r['library_ms']:.4f}",
            bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1])

    # 4. serve: the main path, counters zeroed just before, read just after
    from repro_torch.launch.serve import run as serve_run
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS:
        k.launches = 0
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
    missing = [n for n, v in launches.items() if v <= 0]
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

    # 4b. where the time goes: a shorter serve under torch.profiler (its
    # wall includes the profiler's own overhead)
    prof = profile_serve(torch)
    say("profile", **prof)

    # 5. parity of the path: kernels vs plain versions from one state
    k_pf, k_ids, k_lp, _ = parity_run(torch, plain=False)
    with PlainKernels():
        p_pf, p_ids, p_lp, p_logits = parity_run(torch, plain=True)
    top2 = p_logits.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 1e-3
    if not bool((k_ids == p_ids)[decided].all()):
        raise AssertionError("decode ids differ where the plain run's "
                             "top-2 gap exceeds 1e-3")
    same = k_ids == p_ids
    lp_err = float((k_lp - p_lp).abs()[same].max())
    if lp_err > 1e-3:
        raise AssertionError(f"decode logprobs differ by {lp_err:.3e}")
    say("parity", prefill_ids_equal=bool((k_pf == p_pf).all()),
        decode_ids_equal=f"{int(same.sum())}/{same.numel()}",
        decided=int(decided.sum()), max_logprob_err=f"{lp_err:.3e}",
        tol=1e-3)

    # 6. the kernels line, the card line, the last line
    line = []
    for k in kernels.KERNELS:
        r = results[k.name]
        line.append({
            "name": k.name, "route": "cuda", "source": k.relpath(),
            "replaces": k.replaces, "tpu_kernel": k.replaces,
            "launches": launches[k.name],
            "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
            "tolerance": r["tol"], "ms": r["ms"], "kernel_ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
