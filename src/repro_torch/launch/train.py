"""Training CLI of the port — ``repro.launch.train`` and ``Session.train``.

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
safe point and its migration applied, or — with ``--repack`` — the
controller's repack decision executed as a live shrink onto fewer stage
buffers (``--grow-back N`` grows back N steps later); for an MoE arch with
``--dynamics.expert_relayout``, the new expert placement broadcast into
``dyn["expert_map"]`` and committed.  The run is on the CUDA card unless
``--device cpu``.  Flags of features outside the port so far raise
``NotImplementedError`` naming their ROADMAP item.

Fault tolerance and the control plane's inputs (the reference's
``Session.train`` / ``Session.resume``): ``--ckpt-dir D --ckpt-every N``
writes a safe point after every N-th step (after the step's resize and
grow decisions), and ``--resume D`` rebuilds the run from the newest
complete one alone — its flags, world, pool and epoch — and continues
bit-identically (``--device`` is the only flag it takes from the command
line); ``--ckpt-dir`` alone writes plain checkpoints every max(10, steps
// 5) steps.  ``--async-controller`` decides on a background thread
(``--async-drain`` waits for each decision: the inline run step for step).
``--in-step-timing`` (``--obs.in_step_timing``) times every stage's forward
inside the step (CUDA events on the card), ``--measure-stage-times`` runs
the isolated per-stage probe on cadence; in-step times come first, and the
straggler detector (which consumes them) is built only with
``--straggler`` or ``--measure-stage-times``.

  python -m repro_torch.launch.train --stages 4 --dynamism pruning \
      --repack --grow-back 6 --rebalance-every 5

  python -m repro_torch.launch.train --arch mixtral-8x7b --layers 4 \
      --stages 2 --dynamism moe --kernel-impl pallas \
      --dynamics.expert_relayout --dynamics.expert_watermark 1.01

  python -m repro_torch.launch.train --steps 20 --ckpt-dir ck \
      --ckpt-every 8 --in-step-timing --async-controller --async-drain
  python -m repro_torch.launch.train --resume ck

The cluster layer (``Session.train``'s): ``--autoscale`` runs a heartbeat
monitor on the step clock and the autoscaler over it — a worker that stops
beating is evicted, a revived one (``--simulate-recover K`` revives every
idle worker at step K) is grown back, and ``--autoscale-watermark`` adds
the throughput watermark.  ``--job-manager file|http`` puts the worker
pool behind a manager process: releases and grants cross an RPC boundary,
and while the manager is unreachable the engine defers its bookkeeping
and replays it in order (``degraded_events``).  ``--tenant-id`` /
``--priority`` register the run with a shared HTTP manager's cluster
scheduler (``--manager-url``): each step polls its directives — a
preemption becomes a shrink at the safe point, an offer is absorbed.

  python -m repro_torch.launch.train --stages 4 --dynamism pruning \
      --repack --async-controller --autoscale --simulate-recover 18 \
      --job-manager file
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.checkpoint.safepoint import SafepointManager, peek
from repro_torch.cluster.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.cluster.rpc import JobManagerUnavailable
from repro_torch.cluster.service import ControlPlane, StatsSnapshot
from repro_torch.configs.base import DistConfig, get_config, reduced_config
from repro_torch.core.controller import ControllerConfig, DynMoController
from repro_torch.core.cost_model import stage_memory_budget
from repro_torch.data.loader import DataConfig, make_loader
from repro_torch.dynamics import pruning as prn
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.dynamics.trajectories import zhu_gupta_sparsity
from repro_torch.launch import cluster
from repro_torch.launch.engine import ElasticEngine
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.pipeline.pipeline import PipelineShapes
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                 StragglerDetector,
                                                 WorkerPool)

# flags of features not in the port yet: accepted so they fail loudly
_NOT_IN_SLICE = {
    "chaos": "fault injection (ROADMAP Queue 1 [faults-obs])",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="DynMo trainer on the PyTorch/CUDA port")
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
           "sparse_attention | early_exit | mod)")
    # dynamics.* spec fields, spelled as the reference's dotted flags
    a("--dynamics.expert_relayout", dest="expert_relayout", nargs="?",
      const="true", default="false", type=_bool,
      help="live expert re-layout at safe points (MoE archs)")
    a("--dynamics.expert_watermark", dest="expert_watermark", type=float,
      default=2.0, help="max/mean routed-load skew that triggers it")
    a("--dynamics.expert_min_tokens", dest="expert_min_tokens", type=int,
      default=16, help="ignore windows with fewer routed tokens")
    a("--dynamics.ee_threshold", dest="ee_threshold", type=float,
      default=0.98, help="early exit: cosine of a block's input and "
                         "output above which a token exits")
    # controller.*
    a("--balancer", default="diffusion", choices=["diffusion", "partition"])
    a("--rebalance-every", type=int, default=10)
    a("--straggler", default=None,
      help="simulate slow workers, e.g. '1:2.0' (worker 1 runs 2x slow); "
           "the detector feeds the balancer")
    a("--repack", action="store_true",
      help="enable live worker consolidation (paper Alg. 2)")
    a("--repack-policy", default="adjacent",
      choices=["adjacent", "first_fit"])
    a("--repack-mem-cap", type=float, default=1.1,
      help="per-worker memory budget as a multiple of the unpruned "
           "per-stage footprint")
    a("--repack-target", type=int, default=1,
      help="never consolidate below this many workers")
    a("--grow-back", type=int, default=None,
      help="DEPRECATED: re-expand N steps after a shrink")
    a("--async-controller", action="store_true",
      help="decide on a background thread (latest-wins mailbox)")
    a("--async-drain", action="store_true",
      help="with --async-controller: wait for each decision "
           "(deterministic; the inline run step for step)")
    a("--measure-stage-times", action="store_true",
      help="time each stage alone on cadence (the probe)")
    # obs.*
    a("--in-step-timing", dest="in_step_timing", action="store_true",
      help="time each stage's forward inside the step")
    a("--obs.in_step_timing", dest="in_step_timing", nargs="?",
      const="true", type=_bool, default=argparse.SUPPRESS)
    a("--steps", type=int, default=50)
    a("--seed", type=int, default=0)
    a("--log-every", type=int, default=10)
    a("--ckpt-dir", default=None, help="checkpoint / safe-point directory")
    a("--ckpt-every", type=int, default=0,
      help="write a safe point every N steps (needs --ckpt-dir)")
    a("--resume", default=None, metavar="CKPT_DIR",
      help="resume from the newest complete safe point in this directory; "
           "it carries the run's flags, so every other flag but --device "
           "is ignored")
    # cluster.*
    a("--autoscale", action="store_true",
      help="signal-driven shrink / grow: heartbeat failures and "
           "recoveries (+ the throughput watermark with "
           "--autoscale-watermark)")
    a("--autoscale-watermark", action="store_true",
      help="also scale on the per-worker throughput watermark")
    a("--heartbeat-timeout", type=float, default=3.0,
      help="missed-beat timeout in steps (simulated clock)")
    a("--simulate-recover", type=int, default=None,
      help="revive all non-active workers at this step (heartbeat "
           "recovery)")
    cluster.add_cluster_flags(ap)
    # not in the port yet: accepted so it fails loudly, never ignored
    a("--chaos", action="store_true")
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
    cluster.check_cluster_flags(args)
    if args.heartbeat_timeout <= 0:
        raise ValueError(f"--heartbeat-timeout must be > 0, got "
                         f"{args.heartbeat_timeout}")
    if args.ckpt_every and not args.ckpt_dir:
        raise ValueError("--ckpt-every requires --ckpt-dir (safe points "
                         "need a directory)")


def resume_args(argv: Optional[List[str]], resume: Optional[str] = None,
                resume_step: Optional[int] = None):
    """(flags, safe-point index or None): with ``--resume DIR`` (or
    ``resume``) the flags are the safe point's own, ``--device`` aside."""
    args = build_parser().parse_args(argv)
    path = resume or args.resume
    if not path:
        return args, None
    idx = peek(path, resume_step)
    stored = {**vars(build_parser().parse_args([])), **idx["meta"]["args"]}
    out = argparse.Namespace(**stored)
    out.resume = path
    if args.device is not None:
        out.device = args.device
    return out, idx


def model_config(args):
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = reduced_config(cfg, num_layers=args.layers,
                             d_model=args.d_model, num_heads=args.num_heads,
                             num_kv_heads=args.num_kv_heads,
                             d_ff=args.d_ff or 2 * args.d_model,
                             vocab_size=args.vocab_size)
    return cfg


def run(argv: Optional[List[str]] = None, *, params=None,
        resume: Optional[str] = None,
        resume_step: Optional[int] = None,
        on_step: Optional[Callable[[int, "cluster.JobManager"], None]] = None
        ) -> Dict[str, Any]:
    """Run the training loop; returns the report dict.  ``params`` (a
    converted reference tree) replaces the engine's own init.  ``resume``
    (a safe-point directory) and ``resume_step`` continue a run from its
    newest complete safe point, or from the one of ``resume_step``, as
    ``Session.resume(dir, step)`` does.  ``on_step(step, job_manager)``
    runs after each step's safe point (where the reference's fault
    injector fires: a test stops and restarts the manager there)."""
    args, resume_idx = resume_args(argv, resume, resume_step)
    check_slice(args)
    straggler = parse_straggler(args.straggler)
    cfg = model_config(args)
    if args.dynamism == "pruning" and cfg.num_experts:
        raise NotImplementedError(
            "pruning an MoE arch's experts is not in repro_torch yet "
            "(ROADMAP Queue 1 [moe-rest])")
    dcfg = DistConfig(num_stages=args.stages, slot_slack=args.slot_slack,
                      remat=args.remat, param_dtype=args.param_dtype,
                      kernel_impl=args.kernel_impl)
    dyncfg = DynamicsConfig(kind=args.dynamism,
                            ee_threshold=args.ee_threshold,
                            expert_relayout=args.expert_relayout,
                            expert_watermark=args.expert_watermark,
                            expert_min_tokens=args.expert_min_tokens)
    stages = args.stages
    shapes = PipelineShapes(num_micro=args.num_micro,
                            mb_global=args.mb_global, seq=args.seq)
    if args.grow_back is not None:
        warnings.warn(
            "cluster.grow_back / --grow-back is deprecated: fixed-step "
            "re-expansion is superseded by signal-driven scaling "
            "(cluster.autoscale / --autoscale)", DeprecationWarning,
            stacklevel=2)

    rmeta = resume_idx["meta"] if resume_idx is not None else {}
    log = cluster.EventLog()
    jm = cluster.connect(args.job_manager, workers=stages, spares=args.spares,
                         job_manager_dir=args.job_manager_dir,
                         manager_url=args.manager_url,
                         pool_state=(rmeta.get("pool")
                                     if args.job_manager == "file" else None),
                         rpc_timeout_s=args.rpc_timeout_s)
    pool = None
    if jm.client is None and resume_idx is None and args.spares:
        pool = WorkerPool(stages, spares=args.spares)
    engine = None
    try:
        engine = ElasticEngine(cfg, dcfg, dyncfg, shapes, pool=pool,
                               job_manager=jm.client, device=args.device,
                               in_step_timing=args.in_step_timing)
        return _train(args, resume_idx, rmeta, params, cfg, dcfg, dyncfg,
                      shapes, straggler, engine, jm, log, on_step)
    finally:
        jm.close(engine)


def _train(args, resume_idx, rmeta, params, cfg, dcfg, dyncfg, shapes,
           straggler, engine, jm, log, on_step) -> Dict[str, Any]:
    """The loop of ``run`` on a connected job manager and a built
    engine."""
    steps, seq, stages = args.steps, args.seq, args.stages
    tokens_per_step = args.num_micro * args.mb_global * seq
    grow_back = args.grow_back
    repack_target = max(1, args.repack_target)
    start_step, restore_s, restore_mem = 0, None, None
    if resume_idx is not None:
        # rebuild the world the run was in at its safe point (stage count,
        # split, workers, pool, epoch) and load the shards into it
        t_restore = time.perf_counter()
        state = engine.restore_state(args.resume, resume_idx)
        _sync(engine)
        restore_s = time.perf_counter() - t_restore
        restore_mem = _allocated(engine)
        start_step = int(resume_idx["step"]) + 1
    else:
        granted = cluster.register_tenant(
            jm, args.tenant_id, priority=args.priority, kind="train",
            workers=stages, max_workers=stages, min_workers=repack_target,
            log=log)
        if granted is not None:
            # train on exactly the granted workers (arbitrary ids: another
            # tenant may hold 0..k)
            engine.bind_workers(granted)
        state = engine.init_state(args.seed, with_opt=True, params=params,
                                  stages=(len(granted) if granted is not None
                                          else None))
    ccfg = ControllerConfig(method=args.balancer,
                            rebalance_every=args.rebalance_every,
                            repack=args.repack,
                            repack_policy=args.repack_policy,
                            repack_target=repack_target,
                            expert_relayout=dyncfg.expert_relayout,
                            expert_watermark=dyncfg.expert_watermark,
                            expert_min_tokens=dyncfg.expert_min_tokens)
    if args.repack:
        # per-worker memory budget: the capacity factor x the per-stage
        # footprint of the UNPRUNED model under a uniform split, so a
        # consolidation becomes feasible once dynamism shrinks the model
        ccfg.repack_mem_cap = stage_memory_budget(
            cfg, tokens_per_step, seq, dcfg.bytes_per_param, stages,
            cap_factor=args.repack_mem_cap)
    if rmeta.get("repack_enabled") is False:
        # the crashed run had latched repack off (a grow keeps the granted
        # workers): the resumed one must not plan a shrink again
        ccfg.repack = False
    det = (StragglerDetector(stages)
           if (straggler or args.measure_stage_times) else None)
    ctrl = DynMoController(cfg, dcfg, dyncfg, ccfg, straggler=det)
    cp = ControlPlane(ctrl, async_mode=args.async_controller,
                      epoch_fn=lambda: engine.epoch)
    if resume_idx is not None:
        cp.rebind(engine.dcfg_for(state.stages), state.lps)

    # ---- autoscaler: heartbeats (+ the throughput watermark); the monitor
    # runs on a step-granular clock, so a run is deterministic
    monitor = scaler = None
    sim_clock = [0.0]
    if args.autoscale:
        monitor = HeartbeatMonitor(stages, timeout_s=args.heartbeat_timeout,
                                   clock=lambda: sim_clock[0])
        scaler = Autoscaler(AutoscalerConfig(
            min_stages=repack_target, max_stages=stages,
            watermark=args.autoscale_watermark), monitor)
        if rmeta.get("scaler"):
            scaler.load_state(rmeta["scaler"])
    loader = make_loader(cfg, DataConfig(args.num_micro, args.mb_global, seq,
                                         seed=args.seed),
                         start_step=start_step)
    ckpt = safept = None
    if args.ckpt_every:
        safept = SafepointManager(args.ckpt_dir, every=args.ckpt_every)
    elif args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, every=max(10, steps // 5))
    saved_args = {**vars(args), "resume": None}

    def after_resize(step: int, kind: str, mem_before) -> None:
        cp.rebind(engine.dcfg_for(state.stages), state.lps)
        if scaler is not None:
            scaler.note_resize(step, state.stages)
        rz = engine.resizes[-1]
        if monitor is not None and rz.kind == "shrink":
            # released workers leave the heartbeat set deliberately; a
            # later revive is the recovery signal the autoscaler grows on
            for w in rz.workers:
                monitor.expire(w)
        if monitor is not None and rz.kind == "grow":
            # regranted workers must beat again (a later real death of the
            # same worker would otherwise go unseen)
            for w in rz.workers:
                monitor.revive(w)
        log.emit("resize", step, resize_kind=kind,
                 from_stages=rz.from_stages, to_stages=rz.to_stages,
                 workers=list(rz.workers), ticks_before=rz.ticks_before,
                 ticks_after=rz.ticks_after)
        resize_mem.append({"step": step, "kind": rz.kind,
                           "allocated_before": mem_before,
                           "allocated_after": _allocated(engine)})
        print(f"step {step:4d} {kind.upper()} {rz.from_stages}->"
              f"{rz.to_stages} stages; workers {rz.workers}; "
              f"pool active={engine.jm.num_active}; schedule "
              f"{rz.ticks_before}->{rz.ticks_after} ticks", flush=True)

    # multi-tenant: poll the cluster scheduler's directive mailbox each
    # step (preempt = shrink at this safe point; offer = absorb free
    # workers back)
    multi_tenant = bool(jm.client is not None and args.tenant_id
                        and getattr(jm.client, "tenant", None))
    last_cluster_resize = start_step - 1
    absorb_cooldown = max(1, args.rebalance_every)

    losses, gnorms, events, step_times, stages_hist = [], [], [], [], []
    resize_mem: List[Dict[str, Any]] = []
    exited_frac: Dict[int, float] = {}
    relayouts: List[Dict[str, Any]] = []
    expert_skew_last = moe_dropped_last = None
    last_measured = stage_time_source = None
    stage_times_log: List[Dict[str, Any]] = []
    safepoint_s: List[float] = []
    warmup_steps, warmup_s, decide_s = 0, 0.0, 0.0
    steady_times: List[float] = []
    t0 = time.perf_counter()
    try:
        for step, batch in enumerate(loader, start=start_step):
            if step >= steps:
                break
            t_step = time.perf_counter()
            lr = cosine_schedule(step, steps, 3e-4, warmup=10)
            loss, stats, gnorm = engine.step(state, batch, lr)
            # one scalar sync for the loss curve; the per-slot stats stay
            # on the device until controller cadence (§3.3.1)
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
                        dyncfg, prune_start_iter=0,
                        prune_end_iter=steps * 100, prune_frequency=1))
                keep = prn.target_keep_blocks(cfg, cfg.total_blocks(), sp)
                state.dyn = {**state.dyn, "ff_mask": prn.global_block_prune(
                    cfg, state.params["stages"], state.assignment["tags"],
                    keep)}
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
                state.dyn = {**state.dyn,
                             "frozen": state.dyn["frozen"].new_tensor(fr)}

            # ---- heartbeats (simulated per-step liveness: active workers
            # beat; released / dead ones go silent and time out)
            if monitor is not None:
                sim_clock[0] = float(step)
                for w in engine.stage_workers:
                    monitor.beat(w)
                if (args.simulate_recover is not None
                        and step == args.simulate_recover):
                    for w in range(stages):
                        if w not in engine.stage_workers:
                            monitor.revive(w)

            # ---- publish stats to the control plane on cadence (the only
            # device -> host stats sync; in async mode a pointer swap)
            if ctrl.cadence(step + 1):
                t_decide = time.perf_counter()
                measured = src = None
                if args.in_step_timing:
                    # per-stage seconds of the live step's stage calls: no
                    # extra execution (the probe below stays available as
                    # the parity oracle)
                    measured = engine.in_step_stage_times(state)
                    if measured is not None:
                        src = "in_step"
                if measured is None and args.measure_stage_times:
                    # the isolated probe: a host sync per stage, so on
                    # cadence only
                    measured = engine.measure_stage_times(state, batch)
                    src = "probe"
                if measured is not None:
                    last_measured, stage_time_source = measured, src
                    stage_times_log.append({
                        "step": step, "source": src, "stages": state.stages,
                        "seconds": [float(x) for x in measured]})
                if straggler:
                    # simulation knob: a straggling WORKER multiplies its
                    # stage's time (the measured one when there is one,
                    # else the wall time split by layer counts)
                    if measured is None:
                        share = np.asarray(state.lps, np.float64)
                        measured = share / share.sum() * step_times[-1]
                    measured = measured * np.array(
                        [straggler.get(engine.stage_workers[s], 1.0)
                         for s in range(state.stages)])
                cp.publish(StatsSnapshot(
                    iteration=step + 1, epoch=engine.epoch,
                    stats=engine.stats_to_host(state, stats),
                    tags=state.assignment["tags"].numpy(),
                    num_micro=shapes.num_micro, tokens=tokens_per_step,
                    seq=seq, frozen=state.dyn["frozen"].cpu().numpy(),
                    stage_times=measured))
                if args.async_drain:
                    cp.drain()
                if stage_times_log and stage_times_log[-1]["step"] == step \
                        and (args.async_drain or not args.async_controller):
                    # the cost model's per-stage loads of this decision
                    stage_times_log[-1]["expected"] = cp.with_ctrl(
                        lambda c: c.expected_loads)
                decide_s += time.perf_counter() - t_decide

            # ---- cluster-scheduler directives (multi-tenant): a steal by
            # a higher-priority tenant arrives as a preemption and becomes
            # an externally originated shrink in the same epoch-fenced
            # mailbox, applied at this step's safe point just below.
            # Level-triggered: a directive fenced off is re-delivered
            if multi_tenant:
                try:
                    directives = jm.client.poll_cluster()
                except (JobManagerUnavailable, RuntimeError):
                    directives = None
                if directives and directives["preempt"] > 0:
                    target = max(repack_target,
                                 state.stages - directives["preempt"])
                    if target < state.stages:
                        cp.inject_resize(engine.epoch, target)
                        last_cluster_resize = step
                        log.emit("preempt", step,
                                 due=directives["preempt"],
                                 target_stages=target)
                elif (directives and directives["offer"] > 0
                        and state.stages < stages
                        and step - last_cluster_resize >= absorb_cooldown):
                    prev = state.stages
                    mem_before = _allocated(engine)
                    state = engine.grow(
                        state, min(directives["offer"],
                                   stages - state.stages), step=step)
                    if state.stages > prev:   # the scheduler may grant none
                        cp.with_ctrl(
                            lambda c: setattr(c.ccfg, "repack", False))
                        after_resize(step, "absorb", mem_before)
                        log.emit("absorb", step, workers=state.stages - prev)
                        last_cluster_resize = step

            # ---- safe point: apply the newest finished plan (epoch-
            # fenced: a plan decided against a pre-resize world is
            # rejected)
            plan = cp.poll(engine.epoch)
            if plan is not None:
                if plan.event is not None:
                    expert_skew_last = plan.event.expert_skew
                    moe_dropped_last = plan.event.expert_dropped
                if plan.event is not None and plan.event.rebalanced:
                    events.append(plan.event)
                if (plan.resize is not None
                        and plan.resize.target_stages < state.stages):
                    mem_before = _allocated(engine)
                    state = engine.shrink(state, plan.resize.target_stages,
                                          plan.resize.layers_per_stage,
                                          step=step)
                    after_resize(step, f"shrink[{plan.resize.policy}]",
                                 mem_before)
                elif plan.new_lps is not None:
                    (state.params, state.opt_state, state.dyn,
                     state.assignment, _) = cp.apply(
                        plan, state.params, state.opt_state, state.dyn)
                    state.lps = cp.with_ctrl(lambda c: list(c.lps))
                # expert re-layout: orthogonal to the stage plan above (it
                # rewrites only the expert_map dyn leaf)
                if (plan.expert_relayout is not None
                        and "expert_map" in state.dyn):
                    rl = plan.expert_relayout
                    em = state.dyn["expert_map"]
                    state.dyn = {**state.dyn, "expert_map": em.new_tensor(
                        rl.new.as_array()).expand_as(em).clone()}
                    cp.with_ctrl(lambda c: c.commit_relayout(rl))
                    relayouts.append({
                        "step": step, "iteration": rl.iteration,
                        "skew": rl.skew, "tokens": rl.total_tokens,
                        "moved_experts": rl.moved_experts,
                        "placement": list(rl.new.placement)})
                    print(f"step {step:4d} RELAYOUT skew {rl.skew:.2f} moved "
                          f"{rl.moved_experts} experts -> "
                          f"{list(rl.new.placement)}", flush=True)
            # ---- autoscaler: heartbeat + watermark signals
            if scaler is not None:
                d = scaler.observe(step, step_times[-1], state.stages,
                                   engine.stage_workers, tokens_per_step)
                if d.action != "none":
                    log.emit("autoscale", step, action=d.action,
                             workers=d.workers, reason=d.reason,
                             ids=list(d.ids))
                if d.action == "evict":
                    mem_before = _allocated(engine)
                    state = engine.evict(state, d.ids, step=step)
                    after_resize(step, "evict", mem_before)
                elif d.action == "grow" and state.stages < stages:
                    prev = state.stages
                    mem_before = _allocated(engine)
                    state = engine.grow(state, d.workers, step=step)
                    if state.stages > prev:   # the pool may grant nothing
                        # granted workers stay for this job: stop planning
                        # resizes so ordinary rebalancing keeps running
                        cp.with_ctrl(
                            lambda c: setattr(c.ccfg, "repack", False))
                        after_resize(step, "grow", mem_before)
                elif d.action == "shrink" and state.stages > repack_target:
                    mem_before = _allocated(engine)
                    state = engine.shrink(
                        state, max(repack_target, state.stages - d.workers),
                        step=step)
                    after_resize(step, "shrink[watermark]", mem_before)

            # ---- legacy fixed-step growth (deprecated)
            if (grow_back and engine.last_shrink_step is not None
                    and state.stages < stages
                    and step >= engine.last_shrink_step + grow_back):
                prev_stages = state.stages
                mem_before = _allocated(engine)
                state = engine.grow(state, stages - state.stages, step=step)
                if state.stages > prev_stages:
                    # granted workers stay: stop planning resizes
                    cp.with_ctrl(lambda c: setattr(c.ccfg, "repack", False))
                    after_resize(step, "grow", mem_before)
            # ---- checkpoints: after the step's resize and grow decisions
            if ckpt is not None:
                ckpt.maybe_save(step, state.params, state.opt_state,
                                state.dyn, state.lps)
            if safept is not None and safept.due(step):
                t_sp = time.perf_counter()
                path = safept.save(step, state, args=saved_args,
                                   engine=engine, scaler=scaler,
                                   repack_enabled=cp.with_ctrl(
                                       lambda c: bool(c.ccfg.repack)),
                                   jm_dir=jm.run_dir)
                safepoint_s.append(time.perf_counter() - t_sp)
                log.emit("safepoint", step, path=path, stages=state.stages)
            if on_step is not None:
                on_step(step, jm)
            gnorms.append(float(gnorm))
            if step % args.log_every == 0:
                log.emit("log", step, loss=float(loss), gnorm=float(gnorm),
                         stages=state.stages, lps=list(state.lps))
                ee = ""
                if "exited_frac" in stats:
                    # early exit's share of exited tokens: a host read on
                    # the log cadence only
                    exited_frac[step] = float(stats["exited_frac"])
                    ee = f" exited {exited_frac[step]:.4f}"
                print(f"step {step:4d} loss {float(loss):.4f} "
                      f"gnorm {float(gnorm):.3f} S={state.stages} "
                      f"lps={state.lps}{ee}", flush=True)
    finally:
        cp.close()
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
        # safe points: seconds of each save (device -> host, npz, sha256)
        # and of the restore (verify, load, host -> device), and
        # torch.cuda.memory_allocated just after the restore
        "safepoint_s": safepoint_s, "restore_s": restore_s,
        "restore_allocated": restore_mem,
    }
    log.emit("train_summary", steps - 1,
             loss_first=losses[0] if losses else None,
             loss_last=losses[-1] if losses else None, wall_s=wall,
             resizes=len(engine.resizes), final_stages=state.stages)
    if args.events_out:
        log.write(args.events_out)
    return {
        "losses": losses, "gnorms": gnorms, "events": events,
        "wall_s": wall, "final_lps": list(state.lps),
        "params": state.params, "assignment": state.assignment,
        "dyn": state.dyn, "opt_state": state.opt_state,
        "tokens_per_step": tokens_per_step,
        "step_times": step_times, "stages_history": stages_hist,
        "final_stages": state.stages, "timing": timing,
        "resizes": [dataclasses.asdict(e) for e in engine.resizes],
        # the pool's transitions; behind an RPC boundary, the client's
        # mirror of them
        "pool_log": list(engine.jm.log),
        # torch.cuda.memory_allocated around each resize (None on the CPU)
        "resize_memory": resize_mem,
        "exited_frac": exited_frac,
        "steady_tokens_per_s": steady_tok_s,
        "measured_stage_times": (list(map(float, last_measured))
                                 if last_measured is not None else None),
        "stage_time_source": stage_time_source,
        # every cadence's measured per-stage seconds (and, when the
        # decision was waited for, the cost model's per-stage loads)
        "stage_times": stage_times_log,
        "controller": {"mode": ("async" if args.async_controller
                                else "inline"),
                       "published": cp.published,
                       "decided": cp.decided, "dropped": cp.dropped,
                       "stale_rejected": cp.stale_rejected},
        # expert-parallel telemetry (MoE archs; None otherwise)
        "relayouts": relayouts,
        "expert_skew_last": expert_skew_last,
        "moe_dropped_last": moe_dropped_last,
        "expert_layout": (list(ctrl.expert_layout.placement)
                          if ctrl.expert_layout is not None else None),
        # fault tolerance
        "start_step": start_step,
        "resumed_from": (int(resume_idx["step"])
                         if resume_idx is not None else None),
        "safepoints": list(safept.saved) if safept is not None else [],
        # the cluster layer
        "autoscale_decisions": ([dataclasses.asdict(d)
                                 for d in scaler.decisions]
                                if scaler is not None else []),
        "degraded_events": list(engine.degraded_events),
        "rpc": ({"stats": dict(jm.client.rpc_stats),
                 "breaker": jm.client.breaker.state_dict()}
                if jm.client is not None else None),
        # the structured telemetry stream (--events-out)
        "session_events": log.events,
        "device": str(engine.device), "args": vars(args),
    }


def _sync(engine: ElasticEngine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def _allocated(engine: ElasticEngine) -> Optional[int]:
    """Bytes of live tensors on the engine's card (None on the CPU)."""
    if engine.device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(engine.device)


def main(argv=None):
    out = run(argv)
    ctl = out["controller"]
    print(f"done: loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f} "
          f"in {out['wall_s']:.1f}s; rebalances={len(out['events'])}; "
          f"final lps={out['final_lps']}; controller[{ctl['mode']}] "
          f"decided={ctl['decided']}; relayouts={len(out['relayouts'])}; "
          f"final stages={out['final_stages']}")
    for ev in out["events"]:
        print(f"  rebalance @iter {ev.iteration}: imbalance "
              f"{ev.imbalance_before:.3f} -> {ev.imbalance_after:.3f}, "
              f"moved {ev.moved_layers} layers")
    for rz in out["resizes"]:
        print(f"  {rz['kind']} @step {rz['step']}: {rz['from_stages']} -> "
              f"{rz['to_stages']} stages, workers {rz['workers']}, "
              f"{rz['seconds']:.3f}s")


if __name__ == "__main__":
    main()
