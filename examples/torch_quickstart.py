"""Quickstart on the PyTorch/CUDA port: train a small GPT with DynMo on a
4-stage pipeline (four stage buffers on one device).

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 30]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

What you see: a tiny GPT training over the pipeline; every 10 steps the
DynMo controller profiles the per-slot stats, and when dynamism (here:
gradual block pruning) skews per-layer cost it migrates layers between
stages.

Everything is described by one typed ``RunSpec`` (the same object
``--config run.json`` files deserialize to) and executed by a ``Session``;
``session.events`` is the structured telemetry stream.  The run is on the
CUDA card unless ``--device cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--dynamism", default="pruning",
                    choices=["none", "pruning", "freezing", "early_exit",
                             "mod", "sparse_attention"])
    ap.add_argument("--balancer", default="diffusion",
                    choices=["diffusion", "partition"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.api import (ControllerSpec, DynamicsSpec, ModelSpec,
                                 ParallelSpec, RunSpec, Session)
    spec = RunSpec(
        model=ModelSpec(arch="smollm-360m", layers=8, d_model=128),
        parallel=ParallelSpec(stages=4, num_micro=4, mb_global=4, seq=64),
        dynamics=DynamicsSpec(kind=args.dynamism),
        controller=ControllerSpec(balancer=args.balancer,
                                  rebalance_every=10),
        steps=args.steps, log_every=5)

    with Session(spec, device=args.device) as s:
        out = s.train()

    print(f"\nloss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f} "
          f"({args.steps} steps, {out['wall_s']:.1f}s)")
    print(f"final layers-per-stage: {out['final_lps']}")
    rebalances = [ev for ev in s.events if ev.kind == "rebalance"]
    print(f"rebalance events: {len(rebalances)}")
    for ev in rebalances:
        print(f"  iter {ev.data['iteration']}: imbalance "
              f"{ev.data['imbalance_before']:.3f} -> "
              f"{ev.data['imbalance_after']:.3f}, "
              f"moved {ev.data['moved_layers']} layers")
    return out


if __name__ == "__main__":
    main()
