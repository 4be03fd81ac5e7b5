"""Fault tolerance and elasticity on the PyTorch/CUDA port (paper §3.4).

Two modes:

  --mode live (default): the ``ElasticEngine`` path — shrink 4 -> 2
    stages and grow back IN PROCESS, no restart: the state is flattened to
    global layer order, re-split, and placed on the surviving stage
    buffers; the released workers go back to the worker pool and are
    granted back later.

  --mode restart: the checkpoint-coordinated fallback (§3.4.2), for when
    the job manager must reschedule processes: train, write a safe point,
    "lose" two workers, restore it elastically onto 2 stages, continue,
    and grow back to 4 when the pool provisions two fresh workers.

    PYTHONPATH=src python examples/torch_elastic_restart.py \\
        [--mode live|restart] [--device cpu]

The run is on the CUDA card unless ``--device cpu``.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def _setup():
    from repro_torch.configs import get_config, reduced_config
    cfg = reduced_config(get_config("smollm-360m"), num_layers=8,
                         d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                         vocab_size=512)
    return cfg, 2, 2, 32       # cfg, micro, mbg, seq


def _dcfg(stages):
    from repro_torch.configs import DistConfig
    return DistConfig(num_stages=stages, slot_slack=3, remat="none",
                      param_dtype="float32")


def main_live(device=None):
    """Engine mode: one process, three worlds, no restart."""
    from repro_torch.data.loader import DataConfig, make_loader
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.pipeline.pipeline import PipelineShapes

    cfg, micro, mbg, seq = _setup()
    engine = ElasticEngine(cfg, _dcfg(4), DynamicsConfig(),
                           PipelineShapes(micro, mbg, seq), device=device)
    state = engine.init_state(0, with_opt=True)
    it = iter(make_loader(cfg, DataConfig(micro, mbg, seq)))

    def train_some(n):
        return [float(engine.step(state, next(it), 3e-4)[0])
                for _ in range(n)]

    print("phase 1: 4-stage training")
    losses1 = train_some(6)
    print(f"  losses: {[f'{x:.3f}' for x in losses1]}")

    print("phase 2: repack decision -> LIVE shrink to 2 stages "
          "(same process, no checkpoint)")
    state = engine.shrink(state, 2, step=6)
    rz = engine.resizes[-1]
    print(f"  released workers {rz.workers} in {rz.seconds * 1e3:.0f}ms; "
          f"pool active={engine.pool.num_active}; "
          f"schedule {rz.ticks_before}->{rz.ticks_after} ticks")
    losses2 = train_some(6)
    print(f"  losses: {[f'{x:.3f}' for x in losses2]}")
    assert losses2[0] < losses1[0], "training must continue, not restart"

    print("phase 3: workers recovered -> LIVE grow back to 4 stages")
    state = engine.grow(state, 2, step=12)
    rz = engine.resizes[-1]
    print(f"  granted workers {rz.workers}; "
          f"pool active={engine.pool.num_active}")
    losses3 = train_some(6)
    print(f"  losses: {[f'{x:.3f}' for x in losses3]}")
    print(f"live shrink + regrow completed; loss descended "
          f"{losses1[0]:.3f} -> {losses3[-1]:.3f}; "
          f"pool log: {engine.pool.log}")
    return {"losses": [losses1, losses2, losses3],
            "resizes": [(r.kind, r.from_stages, r.to_stages, r.workers)
                        for r in engine.resizes],
            "pool_log": list(engine.pool.log),
            "final_stages": state.stages}


def main_restart(device=None):
    """Checkpoint-coordinated fallback (§3.4.2): the restart path."""
    import torch

    from repro_torch.checkpoint.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    from repro_torch.checkpoint.elastic import elastic_restore
    from repro_torch.data.loader import DataConfig, make_loader
    from repro_torch.device import resolve_device
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import make_train_step
    from repro_torch.launch.sharding import tree_digest
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline import PipelineShapes
    from repro_torch.runtime.fault_tolerance import WorkerPool

    dev = resolve_device(device)
    cfg, micro, mbg, seq = _setup()
    dyncfg = DynamicsConfig()
    ckdir = tempfile.mkdtemp(prefix="dynmo_elastic_")
    # the dead workers stay dead: recovery provisions fresh machines
    pool = WorkerPool(4, spares=2)

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree.to(dev)

    def train_some(stages, steps, params=None, opt=None, dyn=None,
                   lps=None, start=0):
        dcfg = _dcfg(stages)
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(0)
            params = M.init_params(gen, cfg, dcfg, dev)
            dyn = M.init_dyn(cfg, dcfg, dyncfg, dev)
        else:
            # restored state comes back on the host: place it on the card
            params, dyn = to_dev(params), to_dev(dyn)
            opt = None if opt is None else to_dev(opt)
        lps = lps or M.uniform_boundaries(cfg.total_blocks(), stages)
        assignment = M.make_assignment(cfg, dcfg, lps)
        init_opt, step_fn = make_train_step(
            cfg, dcfg, dyncfg, PipelineShapes(micro, mbg, seq), device=dev)
        if opt is None:
            opt = init_opt(params)
        losses = []
        loader = make_loader(cfg, DataConfig(micro, mbg, seq),
                             start_step=start)
        for i, batch in enumerate(loader):
            if i >= steps:
                break
            params, opt, loss, _, _ = step_fn(params, opt, assignment, dyn,
                                              batch, 3e-4)
            losses.append(float(loss))
        return params, opt, dyn, list(lps), losses, dcfg

    print("phase 1: 4-stage training")
    p, o, d, lps4, losses1, dcfg4 = train_some(4, 6)
    print(f"  losses: {[f'{x:.3f}' for x in losses1]}")
    save_checkpoint(ckdir, 6, p, o, d, lps4)
    saved = tree_digest({"params": p, "opt": o, "dyn": d})

    print("phase 2: 2 workers fail -> heartbeat detects -> elastic restart "
          "on 2 stages")
    pool.fail(2)
    pool.fail(3)
    print(f"  active workers: {pool.num_active}")
    p, o, d, index = load_checkpoint(ckdir, (p, o, d))
    restored = tree_digest({"params": p, "opt": o, "dyn": d})
    assert restored == saved, "the safe point must restore bit for bit"
    p2, o2, d2, _, lps2 = elastic_restore(
        cfg, dcfg4, _dcfg(2), p, o, d, index["layers_per_stage"])
    p2, o2, d2, lps2b, losses2, _ = train_some(
        2, 6, params=p2, opt=o2, dyn=d2, lps=lps2, start=6)
    print(f"  losses: {[f'{x:.3f}' for x in losses2]}")
    assert losses2[0] < losses1[0], "training must continue, not restart"

    print("phase 3: capacity recovered -> grow back to 4 stages")
    granted = pool.request(2)
    print(f"  fresh workers {granted}; active workers: {pool.num_active}")
    p4, o4, d4, _, lps4b = elastic_restore(
        cfg, _dcfg(2), _dcfg(4), p2, o2, d2, lps2b)
    _, _, _, _, losses3, _ = train_some(4, 6, params=p4, opt=o4, dyn=d4,
                                        lps=lps4b, start=12)
    print(f"  losses: {[f'{x:.3f}' for x in losses3]}")
    print("elastic shrink + regrow completed; loss descended "
          f"{losses1[0]:.3f} -> {losses3[-1]:.3f}")
    return {"losses": [losses1, losses2, losses3], "restored": restored,
            "saved": saved, "lps": [lps4, lps2, lps4b],
            "granted": granted, "pool_log": list(pool.log)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="live", choices=["live", "restart"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return (main_live if args.mode == "live" else main_restart)(args.device)


if __name__ == "__main__":
    main()
