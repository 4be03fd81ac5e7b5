"""End-to-end driver on the PyTorch/CUDA port: train a ~30M..100M-param
GPT with gradual global block pruning (paper §3.2.1, Eq. 3) + DynMo
rebalancing + live re-packing + safe points.

    PYTHONPATH=src python examples/torch_train_dynamic_pruning.py
    PYTHONPATH=src python examples/torch_train_dynamic_pruning.py --big
    PYTHONPATH=src python examples/torch_train_dynamic_pruning.py \\
        --device cpu --steps 12 --seq 32

The pruning schedule compresses the paper's 3000..7000-iteration window
into this run's horizon; watch the balancer shift layers toward the stages
holding less-pruned layers, and — once pruning frees enough memory under
the 1.1x per-worker budget — the controller's repack decision consolidate
the pipeline onto 2 stage buffers live (Alg. 2).

The run is one ``RunSpec`` executed by a ``Session`` (the identical run is
``python -m repro_torch.launch.train --config <this spec as json>``).  It
is on the CUDA card unless ``--device cpu``.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", action="store_true", help="~100M params")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="safe-point directory (default: a fresh temporary "
                         "one)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.api import (ControllerSpec, DynamicsSpec, ModelSpec,
                                 ParallelSpec, RepackSpec, RunSpec, Session)
    from repro_torch.configs import get_config, reduced_config

    if args.big:
        model = ModelSpec(arch="smollm-360m", layers=12, d_model=512,
                          num_heads=8, num_kv_heads=4, d_ff=2048,
                          vocab_size=4096)
    else:
        model = ModelSpec(arch="smollm-360m", layers=8, d_model=256,
                          num_heads=8, num_kv_heads=4, d_ff=1024,
                          vocab_size=2048)
    cfg = reduced_config(get_config(model.arch), num_layers=model.layers,
                         d_model=model.d_model, num_heads=model.num_heads,
                         num_kv_heads=model.num_kv_heads, d_ff=model.d_ff,
                         vocab_size=model.vocab_size)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params, "
          f"{cfg.total_blocks()} blocks")

    ckdir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ck_")
    spec = RunSpec(
        model=model,
        parallel=ParallelSpec(stages=4, num_micro=4, mb_global=4,
                              seq=args.seq),
        dynamics=DynamicsSpec(kind="pruning"),
        # finite per-worker budget (1.1x the unpruned per-stage footprint):
        # consolidation plans fire only once pruning shrinks memory
        controller=ControllerSpec(
            rebalance_every=min(20, max(1, args.steps // 3)),
            repack=RepackSpec(enabled=True, mem_cap=1.1, target=2)),
        steps=args.steps, log_every=max(1, min(20, args.steps // 4)),
        ckpt_dir=ckdir, ckpt_every=max(1, args.steps // 2))

    with Session(spec, device=args.device) as s:
        out = s.train()

    print(f"\nloss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f} "
          f"({args.steps} steps, {out['wall_s']:.1f}s)")
    for ev in s.events:
        if ev.kind == "rebalance":
            print(f"  [dynmo] iter {ev.data['iteration']}: imbalance "
                  f"{ev.data['imbalance_before']:.2f} -> "
                  f"{ev.data['imbalance_after']:.2f}, moved "
                  f"{ev.data['moved_layers']} layers")
        elif ev.kind == "resize":
            print(f"  [repack] {ev.data['resize_kind']} @step {ev.step}: "
                  f"{ev.data['from_stages']}->{ev.data['to_stages']} "
                  f"workers, schedule {ev.data['ticks_before']}->"
                  f"{ev.data['ticks_after']} ticks")
    print(f"final stages={out['final_stages']} lps={out['final_lps']}; "
          f"safe points {out['safepoints']}")
    return out


if __name__ == "__main__":
    main()
