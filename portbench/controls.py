"""The readings a training cell's limits are set from, besides the
program's own (which every run prints): the control and the planted
faults, at the cell's own size.  The benchmark's runs never run this.

    python3 portbench/controls.py --workload NAME --seeds 1 2 3 [--out F]

For each seed and variant, the variant takes the program's place: it
trains from the seed's weights on the seed's batches through the checked
steps, prunes by its own magnitudes, and its readings go through the
harness's own comparison (``reference/compare.judge``) against the fp32
reference following it, as a run's readings of the program do:

* ``tf32``: the reference with every product's operands rounded to TF32,
  the precision below the configuration's fp32 (the control);
* ``half``: the fp32 reference with half of each step's rows left out,
  its mean taken over the rest (a planted fault).

A step that returns its state unchanged reads 1 on the change numbers by
their definition and needs no run."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT.parent / "src"))

import torch  # noqa: E402

import harness  # noqa: E402
from reference import compare, data, follow, schedule  # noqa: E402
from reference import weights as wmod  # noqa: E402

VARIANTS = {"tf32": {"prec": "tf32"}, "half": {"rows": "half"}}


def readings(root: Path, workload: str, seed: int, device: str = "cuda",
             manifest_path=None, data_dir: Path = ROOT) -> dict:
    """{"seed", per variant {number: [value, limit]} and ``correct``}."""
    P = harness.prepare(root, workload, seed, device, manifest_path,
                        data_dir)
    c, par, plan = P.c, P.spec.parallel, P.plan
    total = int(P.spec.steps)
    kw = {"chunk_rows": int(P.config.get("ref_chunk_rows", 2))}
    bt = data.take(c["vocab"], par.num_micro, par.mb_global, par.seq, seed,
                   range(plan.last + 1))
    lr = lambda k: schedule.cosine_lr(k, total)  # noqa: E731
    W0 = lambda: wmod.make(c, seed, P.dev, P.layer_dtype)  # noqa: E731
    out = {"seed": seed}
    t0 = time.perf_counter()
    with harness._fp32_only():
        for name, var in VARIANTS.items():
            got = follow.readings(c, W0(), bt, lr, plan,
                                  follow.own_top(plan.keep), **kw, **var)
            ref = follow.readings(c, W0(), bt, lr, plan,
                                  follow.following(got["mask"], plan.keep),
                                  **kw)
            nums = compare.judge(got, ref, P.limits, plan)
            out[name] = {k: list(v) for k, v in nums.items()}
            out[name]["correct"] = all(v <= lim for v, lim in nums.values())
            del got, ref
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = ROOT.parent
    rows = []
    for s in args.seeds:
        r = readings(root, args.workload, s % (1 << 32))
        print(json.dumps(r), flush=True)
        rows.append(r)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
