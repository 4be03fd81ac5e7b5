"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout of the repository (the program is
``src/repro_torch``).  The last line of standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the reference beside its limit (also the last
lines of standard error).  A traced run writes its profiler trace to
``build/portbench/<workload>/trace.json``.  Without a CUDA card, or
with fewer cards than the cell asks for, it exits 2 and prints no
result."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's build and kernel caches at fixed paths in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden():
    """Top-level module names, compared whole, that must not be loaded."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    with open(ROOT / "BENCHMARK.json") as f:
        man = json.load(f)
    cells = {c["name"]: c for c in man["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    need = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {need} CUDA card(s), has {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    import harness
    out = harness.run_cell(ROOT, args.workload, args.seed % (1 << 32),
                           args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} = {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
