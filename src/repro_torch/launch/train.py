"""Training CLI of the port — ``repro.launch.train`` and ``Session.train``
on one fixed world.

  python -m repro_torch.launch.train --stages 2 --num-micro 4 \\
      --mb-global 2 --seq 1024 --steps 15 --dynamism pruning \\
      --kernel-impl pallas --rebalance-every 5 --straggler 1:2.0

Flag names are the reference's (``repro.api.cli``).  The model is built as
``Session._model_config`` builds it: the registry config at full size, or
``reduced_config`` when ``--layers`` is given (the reference's train CLI
reduces to 8 layers by default; this one trains the full model unless
asked).  The loop is ``Session.train``'s, in its order: a step (pipelined
loss, backward, clipped AdamW), the pruning / freezing events, stats
published to the control plane on its cadence, the decision polled at the
safe point and its migration applied — and, for an MoE arch with
``--dynamics.expert_relayout``, the new expert placement broadcast into
``dyn["expert_map"]`` and committed.  The run is on the CUDA card unless
``--device cpu``.  Flags of features outside this slice raise
``NotImplementedError`` naming their ROADMAP item.

  python -m repro_torch.launch.train --arch mixtral-8x7b --layers 4 \
      --stages 2 --dynamism moe --kernel-impl pallas \
      --dynamics.expert_relayout --dynamics.expert_watermark 1.01
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.cluster.service import ControlPlane, StatsSnapshot
from repro_torch.configs.base import DistConfig, get_config, reduced_config
from repro_torch.core.controller import ControllerConfig, DynMoController
from repro_torch.data.loader import DataConfig, make_loader
from repro_torch.dynamics import pruning as prn
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.dynamics.trajectories import zhu_gupta_sparsity
from repro_torch.launch.engine import ElasticEngine
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.pipeline.pipeline import PipelineShapes
from repro_torch.runtime.fault_tolerance import StragglerDetector

# flags of features outside this slice: accepted so they fail loudly
_NOT_IN_SLICE = {
    "repack": "live worker consolidation (ROADMAP Queue 1 [training]: "
              "repack, live resize)",
    "autoscale": "autoscaling (ROADMAP Queue 1 [training]: heartbeats / "
                 "autoscaler / job managers)",
    "async_controller": "the asynchronous control plane (ROADMAP Queue 1 "
                        "[training]: async ControlPlane)",
    "resume": "checkpoint resume (ROADMAP Queue 1 [training]: checkpoint / "
              "safepoint / resume)",
    "ckpt_dir": "checkpoints (ROADMAP Queue 1 [training]: checkpoint / "
                "safepoint / resume)",
    "ckpt_every": "safe points (ROADMAP Queue 1 [training]: checkpoint / "
                  "safepoint / resume)",
    "chaos": "fault injection (ROADMAP Queue 1 [control-plane])",
    "measure_stage_times": "the stage-time probe (ROADMAP Queue 1 "
                           "[serve-timing])",
    "in_step_timing": "in-step stage timing (ROADMAP Queue 1 "
                      "[serve-timing])",
    "grow_back": "fixed-step re-expansion (ROADMAP Queue 1 [training]: "
                 "live resize)",
    "simulate_recover": "heartbeat recovery (ROADMAP Queue 1 [training]: "
                        "heartbeats / autoscaler / job managers)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="DynMo trainer on the PyTorch/CUDA port (one fixed "
                    "execution world)")
    a = ap.add_argument
    # model (spec fields model.*)
    a("--arch", default="smollm-360m")
    a("--layers", type=int, default=None,
      help="reduce the arch to this many layers (default: full size)")
    a("--d-model", type=int, default=128)
    a("--num-heads", type=int, default=4)
    a("--num-kv-heads", type=int, default=2)
    a("--d-ff", type=int, default=None, help="default 2 * d_model")
    a("--vocab-size", type=int, default=512)
    # parallel.*
    a("--stages", type=int, default=4)
    a("--num-micro", type=int, default=4)
    a("--mb-global", type=int, default=4)
    a("--seq", type=int, default=64)
    a("--slot-slack", type=int, default=2)
    a("--remat", default="none", choices=["none", "block", "full"])
    a("--param-dtype", default="float32", choices=["float32", "bfloat16"])
    a("--kernel-impl", default="scan",
      choices=["reference", "scan", "pallas"])
    a("--dynamism", default="none",
      help="dynamism scheme (none | moe | pruning | freezing | "
           "sparse_attention)")
    # dynamics.* spec fields, spelled as the reference's dotted flags
    a("--dynamics.expert_relayout", dest="expert_relayout", nargs="?",
      const="true", default="false", type=_bool,
      help="live expert re-layout at safe points (MoE archs)")
    a("--dynamics.expert_watermark", dest="expert_watermark", type=float,
      default=2.0, help="max/mean routed-load skew that triggers it")
    a("--dynamics.expert_min_tokens", dest="expert_min_tokens", type=int,
      default=16, help="ignore windows with fewer routed tokens")
    # controller.*
    a("--balancer", default="diffusion", choices=["diffusion", "partition"])
    a("--rebalance-every", type=int, default=10)
    a("--straggler", default=None,
      help="simulate slow workers, e.g. '1:2.0' (worker 1 runs 2x slow); "
           "the detector feeds the balancer")
    a("--steps", type=int, default=50)
    a("--seed", type=int, default=0)
    a("--log-every", type=int, default=10)
    # outside this slice: accepted so they fail loudly, never ignored
    for flag in ("--repack", "--autoscale", "--async-controller", "--chaos",
                 "--measure-stage-times", "--in-step-timing"):
        a(flag, action="store_true")
    for flag in ("--resume", "--ckpt-dir", "--ckpt-every", "--grow-back",
                 "--simulate-recover"):
        a(flag, default=None)
    a("--job-manager", default="inproc")
    a("--device", default=None,
      help="cuda (default) or cpu (the kernels' plain versions)")
    return ap


def _bool(text: str) -> bool:
    """A spec bool as the reference's ``RunSpec.override`` parses it."""
    s = str(text).lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a bool, got {text!r}")


def parse_straggler(text: Optional[str]) -> Optional[Dict[int, float]]:
    """'1:2.0' or '1:2.0,3:1.5' -> {worker id: slowdown}."""
    if not text:
        return None
    out = {}
    for item in text.split(","):
        w, _, mult = item.partition(":")
        out[int(w)] = float(mult)
        if out[int(w)] <= 0:
            raise ValueError(f"--straggler multiplier must be > 0: {item}")
    return out


def check_slice(args) -> None:
    for name, what in _NOT_IN_SLICE.items():
        if getattr(args, name):
            raise NotImplementedError(f"{what} is not in repro_torch yet")
    if args.job_manager != "inproc":
        raise NotImplementedError(
            "job managers are not in repro_torch yet (ROADMAP Queue 1 "
            "[training]: heartbeats / autoscaler / job managers)")


def model_config(args):
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = reduced_config(cfg, num_layers=args.layers,
                             d_model=args.d_model, num_heads=args.num_heads,
                             num_kv_heads=args.num_kv_heads,
                             d_ff=args.d_ff or 2 * args.d_model,
                             vocab_size=args.vocab_size)
    return cfg


def run(argv: Optional[List[str]] = None, *, params=None) -> Dict[str, Any]:
    """Run the training loop; returns the report dict.  ``params`` (a
    converted reference tree) replaces the engine's own init."""
    args = build_parser().parse_args(argv)
    check_slice(args)
    straggler = parse_straggler(args.straggler)
    cfg = model_config(args)
    if args.dynamism == "pruning" and cfg.num_experts:
        raise NotImplementedError(
            "pruning an MoE arch's experts is not in repro_torch yet "
            "(ROADMAP Queue 1 [moe-pruning])")
    dcfg = DistConfig(num_stages=args.stages, slot_slack=args.slot_slack,
                      remat=args.remat, param_dtype=args.param_dtype,
                      kernel_impl=args.kernel_impl)
    dyncfg = DynamicsConfig(kind=args.dynamism,
                            expert_relayout=args.expert_relayout,
                            expert_watermark=args.expert_watermark,
                            expert_min_tokens=args.expert_min_tokens)
    steps, seq, stages = args.steps, args.seq, args.stages
    shapes = PipelineShapes(num_micro=args.num_micro,
                            mb_global=args.mb_global, seq=seq)
    tokens_per_step = args.num_micro * args.mb_global * seq

    engine = ElasticEngine(cfg, dcfg, dyncfg, shapes, device=args.device)
    state = engine.init_state(args.seed, with_opt=True, params=params)
    stage_workers = list(range(stages))
    ccfg = ControllerConfig(method=args.balancer,
                            rebalance_every=args.rebalance_every,
                            expert_relayout=dyncfg.expert_relayout,
                            expert_watermark=dyncfg.expert_watermark,
                            expert_min_tokens=dyncfg.expert_min_tokens)
    det = StragglerDetector(stages) if straggler else None
    ctrl = DynMoController(cfg, dcfg, dyncfg, ccfg, straggler=det)
    cp = ControlPlane(ctrl, async_mode=False, epoch_fn=lambda: engine.epoch)
    loader = make_loader(cfg, DataConfig(args.num_micro, args.mb_global, seq,
                                         seed=args.seed))

    losses, gnorms, events, step_times, stages_hist = [], [], [], [], []
    relayouts: List[Dict[str, Any]] = []
    expert_skew_last = moe_dropped_last = None
    warmup_steps, warmup_s, decide_s = 0, 0.0, 0.0
    steady_times: List[float] = []
    t0 = time.perf_counter()
    for step, batch in enumerate(loader):
        if step >= steps:
            break
        t_step = time.perf_counter()
        lr = cosine_schedule(step, steps, 3e-4, warmup=10)
        loss, stats, gnorm = engine.step(state, batch, lr)
        # one scalar sync for the loss curve; the per-slot stats stay on
        # the device until controller cadence (§3.3.1)
        losses.append(float(loss))
        dt = time.perf_counter() - t_step
        step_times.append(dt)
        stages_hist.append(state.stages)
        if engine.last_step_compiled:
            warmup_steps += 1
            warmup_s += dt
        else:
            steady_times.append(dt)

        # ---- dynamism events (black-box to the controller)
        if args.dynamism == "pruning" and step and step % 10 == 0:
            sp = zhu_gupta_sparsity(
                step * 100, dataclasses.replace(
                    dyncfg, prune_start_iter=0, prune_end_iter=steps * 100,
                    prune_frequency=1))
            keep = prn.target_keep_blocks(cfg, cfg.total_blocks(), sp)
            dyn = dict(state.dyn)
            dyn["ff_mask"] = prn.global_block_prune(
                cfg, state.params["stages"], state.assignment["tags"], keep)
            state.dyn = dyn
        if args.dynamism == "freezing" and step and step % 10 == 0:
            front = int(cfg.total_blocks() * min(0.6, step / steps))
            tags_np = state.assignment["tags"].numpy()
            fr = np.zeros(tags_np.shape, np.float32)
            g = 0
            for s in range(tags_np.shape[0]):
                for l in range(tags_np.shape[1]):
                    if tags_np[s, l] != 0:
                        if g < front:
                            fr[s, l] = 1.0
                        g += 1
            dyn = dict(state.dyn)
            dyn["frozen"] = dyn["frozen"].new_tensor(fr)
            state.dyn = dyn

        # ---- publish stats to the control plane on cadence (the only
        # device -> host stats sync)
        if ctrl.cadence(step + 1):
            t_decide = time.perf_counter()
            measured = None
            if straggler:
                # simulation knob: a straggling WORKER multiplies its
                # stage's wall time (the shape a per-worker timer reports)
                share = np.asarray(state.lps, np.float64)
                measured = share / share.sum() * step_times[-1]
                measured = measured * np.array(
                    [straggler.get(stage_workers[s], 1.0)
                     for s in range(state.stages)])
            cp.publish(StatsSnapshot(
                iteration=step + 1, epoch=engine.epoch,
                stats=engine.stats_to_host(state, stats),
                tags=state.assignment["tags"].numpy(),
                num_micro=shapes.num_micro, tokens=tokens_per_step, seq=seq,
                frozen=state.dyn["frozen"].cpu().numpy(),
                stage_times=measured))
            decide_s += time.perf_counter() - t_decide

        # ---- safe point: apply the newest finished plan
        plan = cp.poll(engine.epoch)
        if plan is not None:
            if plan.event is not None:
                expert_skew_last = plan.event.expert_skew
                moe_dropped_last = plan.event.expert_dropped
            if plan.event is not None and plan.event.rebalanced:
                events.append(plan.event)
            if plan.new_lps is not None:
                p, o, d, new_assignment, _ = cp.apply(
                    plan, state.params, state.opt_state, state.dyn)
                state.params, state.opt_state, state.dyn = p, o, d
                state.assignment = new_assignment
                state.lps = list(cp.ctrl.lps)
            # expert re-layout: orthogonal to the stage plan above (it
            # rewrites only the expert_map dyn leaf)
            if (plan.expert_relayout is not None
                    and "expert_map" in state.dyn):
                rl = plan.expert_relayout
                em = state.dyn["expert_map"]
                state.dyn = {**state.dyn, "expert_map": em.new_tensor(
                    rl.new.as_array()).expand_as(em).clone()}
                ctrl.commit_relayout(rl)
                relayouts.append({
                    "step": step, "iteration": rl.iteration,
                    "skew": rl.skew, "tokens": rl.total_tokens,
                    "moved_experts": rl.moved_experts,
                    "placement": list(rl.new.placement)})
                print(f"step {step:4d} RELAYOUT skew {rl.skew:.2f} moved "
                      f"{rl.moved_experts} experts -> "
                      f"{list(rl.new.placement)}", flush=True)
        gnorms.append(float(gnorm))
        if step % args.log_every == 0:
            print(f"step {step:4d} loss {float(loss):.4f} "
                  f"gnorm {float(gnorm):.3f} S={state.stages} "
                  f"lps={state.lps}", flush=True)
    wall = time.perf_counter() - t0
    steady_s = float(sum(steady_times))
    steady_tok_s = (tokens_per_step * len(steady_times) / steady_s
                    if steady_s > 0 else None)
    timing = {
        "warmup_steps": warmup_steps, "warmup_s": warmup_s,
        "decide_s": decide_s,
        "steady_steps": len(steady_times), "steady_s": steady_s,
        "steady_step_mean_s": (steady_s / len(steady_times)
                               if steady_times else None),
        "steady_tokens_per_s": steady_tok_s,
    }
    return {
        "losses": losses, "gnorms": gnorms, "events": events,
        "wall_s": wall, "final_lps": list(state.lps),
        "params": state.params, "assignment": state.assignment,
        "dyn": state.dyn, "tokens_per_step": tokens_per_step,
        "step_times": step_times, "stages_history": stages_hist,
        "final_stages": state.stages, "timing": timing,
        "steady_tokens_per_s": steady_tok_s,
        "controller": {"mode": "inline", "published": cp.published,
                       "decided": cp.decided, "dropped": cp.dropped,
                       "stale_rejected": cp.stale_rejected},
        # expert-parallel telemetry (MoE archs; None otherwise)
        "relayouts": relayouts,
        "expert_skew_last": expert_skew_last,
        "moe_dropped_last": moe_dropped_last,
        "expert_layout": (list(ctrl.expert_layout.placement)
                          if ctrl.expert_layout is not None else None),
        "device": str(engine.device), "args": vars(args),
    }


def main(argv=None):
    out = run(argv)
    ctl = out["controller"]
    print(f"done: loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f} "
          f"in {out['wall_s']:.1f}s; rebalances={len(out['events'])}; "
          f"final lps={out['final_lps']}; controller[{ctl['mode']}] "
          f"decided={ctl['decided']}; relayouts={len(out['relayouts'])}")
    for ev in out["events"]:
        print(f"  rebalance @iter {ev.iteration}: imbalance "
              f"{ev.imbalance_before:.3f} -> {ev.imbalance_after:.3f}, "
              f"moved {ev.moved_layers} layers")


if __name__ == "__main__":
    main()
