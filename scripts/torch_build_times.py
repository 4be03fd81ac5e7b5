"""Time the port's CUDA kernel build, each ``nvcc`` to its own exit, and
hold this tree's K2a / K2b library to another tree's, output for output.

    python3 scripts/torch_build_times.py --other ROOT

1. ``ROOT``'s kernel sources (``src/repro_torch/kernels/*/csrc/*.cu``),
   each compiled as one unit with this tree's ``NVCC_FLAGS``, all at once:
   the seconds of each source to its own exit (``[other_build]``);
2. this tree's build (``kernels._build.build``) into a fresh directory:
   each source's and unit's seconds (``[build]``);
3. K2a and K2b at every (dtype, head dim) they take, on the same inputs,
   through this tree's library and through ``ROOT``'s: ``[bwd_bitwise]``
   says whether dq, dk and dv are the same bits.

Needs a CUDA card and ``nvcc``; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def other_build(other: Path, out: Path) -> dict:
    """Compile ``other``'s kernel sources, one unit each, in parallel;
    {stem: seconds to its own exit}."""
    from repro_torch.kernels import _build
    kdir = other / "src" / "repro_torch" / "kernels"
    procs = {}
    t0 = time.perf_counter()
    for src in sorted(kdir.glob("*/csrc/*.cu")):
        procs[src.stem] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{kdir}", "-o",
             str(out / f"{src.stem}.so"), str(src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    took = {}
    while len(took) < len(procs):
        time.sleep(0.02)
        for name, p in procs.items():
            if name not in took and p.poll() is not None:
                if p.returncode != 0:
                    raise RuntimeError(f"{name}: nvcc exit {p.returncode}")
                took[name] = time.perf_counter() - t0
    return took


def bwd_outputs(torch, ops, dtype, d: int):
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (torch.randn((2, 320, h, d), generator=g, device="cuda")
               .mul(0.5).to(dtype) for h in (4, 2, 2))
    m = (torch.rand((2, 1, 3, 3), generator=g, device="cuda") < 0.7).to(
        torch.int32)
    m[..., 0, 0] = 1
    out, lse = ops.block_sparse_attention_fwd(q, k, v, m, block=128)
    dout = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    delta = ((dout.float() * out.float()).sum(-1).transpose(1, 2)
             .contiguous())
    dq = ops.block_sparse_attention_bwd_dq(q, k, v, m, dout, lse, delta,
                                           block=128)
    dk, dv = ops.block_sparse_attention_bwd_dkv(q, k, v, m, dout, lse,
                                                delta, block=128)
    torch.cuda.synchronize()
    return dq, dk, dv


def load(kernel, path: Path):
    lib = ctypes.CDLL(str(path))
    for sym, argtypes in kernel.functions.items():
        fn = getattr(lib, sym)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="another checkout of the repo (e.g. the parent "
                         "commit's git archive)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_sparse_attention import ops
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        tmp = Path(tmp)
        (tmp / "other").mkdir()
        took = other_build(args.other.resolve(), tmp / "other")
        print("[other_build] " + json.dumps(
            {k: round(v, 1) for k, v in took.items()}) + f" card={smi!r}",
            flush=True)
        _build.BUILD_DIR = tmp / "this"
        t0 = time.perf_counter()
        took = _build.build(kernels.KERNELS)
        print(f"[build] seconds={time.perf_counter() - t0:.1f} " + json.dumps(
            {k: round(v, 1) for k, v in took.items()}) + f" card={smi!r}",
            flush=True)
        same = []
        other = tmp / "other" / "block_sparse_attention_bwd.so"
        for dtype in (torch.float32, torch.bfloat16):
            for d in (16, 32, 64, 128):
                mine = bwd_outputs(torch, ops, dtype, d)
                keep = (ops.KERNEL_DQ._lib, ops.KERNEL_DKV._lib)
                ops.KERNEL_DQ._lib = load(ops.KERNEL_DQ, other)
                ops.KERNEL_DKV._lib = load(ops.KERNEL_DKV, other)
                theirs = bwd_outputs(torch, ops, dtype, d)
                ops.KERNEL_DQ._lib, ops.KERNEL_DKV._lib = keep
                same.append([str(dtype).split(".")[-1], d, all(
                    torch.equal(a, b) for a, b in zip(mine, theirs))])
        print("[bwd_bitwise] " + json.dumps(same).replace(" ", "")
              + f" card={smi!r}", flush=True)
    return 0 if all(s[2] for s in same) else 1


if __name__ == "__main__":
    sys.exit(main())
