"""Training CLI of the port — a thin adapter over ``repro_torch.api``
(``RunSpec`` + ``Session``), as ``repro.launch.train`` is over
``repro.api``.

The training loop lives in ``repro_torch.api.session.Session.train``; this
module only (1) resolves a ``RunSpec`` from the command line
(``--config run.json``, the auto-generated dotted spec flags, the
historical flags as aliases and ``--set path=value`` overrides — see
``repro_torch.api.cli``) and (2) keeps ``run_training(...)`` as the
reference's deprecation shim: it builds the equivalent ``RunSpec``
(``train_spec``) and runs it through a ``Session``.

Like the reference's, the CLI cuts the arch to 8 layers unless
``--layers N`` or ``--set model.layers=null`` (the full model) is given.
It runs on the CUDA card unless ``--device cpu``.

  python -m repro_torch.launch.train --device cpu \\
      --config configs/scenarios/early_exit.json --set steps=3
  python -m repro_torch.launch.train --set model.layers=null --stages 2 \\
      --num-micro 4 --mb-global 2 --seq 1024 --steps 15 \\
      --dynamism pruning --kernel-impl pallas --straggler 1:2.0
  python -m repro_torch.launch.train --dump-config --stages 2
  python -m repro_torch.launch.train --resume CKPT_DIR

``--procs N`` runs the steps as N processes, one per cell of the
``parallel.data x parallel.stages`` mesh of ranks (``launch.dist``), and
prints rank 0's report:

  python -m repro_torch.launch.train --device cpu --procs 4 --stages 4 \\
      --layers 8 --d-model 64 --steps 6
  python -m repro_torch.launch.train --device cpu --procs 4 --stages 4 \\
      --layers 8 --d-model 128 --num-micro 4 --seq 32 --steps 26 \\
      --dynamism pruning --repack --grow-back 6 --rebalance-every 5

The ranks resize too: the second run's repack shrink releases ranks 2 and
3 to the job manager at step 14 and the grow binds them back at step 20.
They write safe points (``--ckpt-dir DIR --ckpt-every K``: each rank its
own stage's shard), run ``--chaos`` (every rank fires the same plan at the
same step) and ``--async-controller`` without ``--async-drain`` (every rank
applies each plan at the same step).

``--resume DIR`` rebuilds the run from the newest complete safe point in
``DIR`` (it carries the producing RunSpec; only ``--device``, ``--procs``
and ``--dist-backend`` are read from the command line) and continues
bit-identically, as one process or as ranks, whichever wrote it:

  python -m repro_torch.launch.train --device cpu --resume DIR --procs 4

``--events-out PATH`` writes the session's structured event stream.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.api.cli import (TRAIN_ALIASES, TRAIN_CLI_DEFAULTS,
                                 add_alias_flags, add_config_args,
                                 add_dist_args, add_spec_flags, build_spec,
                                 maybe_dump)
from repro_torch.api.session import Session
from repro_torch.api.specs import (ClusterSpec, ControllerSpec, DynamicsSpec,
                                   ModelSpec, ParallelSpec, RepackSpec,
                                   RunSpec)


def train_spec(arch: str, *, steps: int = 50, stages: int = 4,
               num_micro: int = 4, mb_global: int = 4, seq: int = 64,
               layers: Optional[int] = None, d_model: int = 128,
               dynamism: str = "none", rebalance_every: int = 10,
               balancer: str = "diffusion", ckpt_dir: Optional[str] = None,
               log_every: int = 10, seed: int = 0,
               kernel_impl: str = "scan",
               dyn_overrides: Optional[Dict[str, Any]] = None,
               repack: bool = False, repack_policy: str = "adjacent",
               repack_mem_cap: float = 1.1, repack_target: int = 1,
               grow_back: Optional[int] = None,
               async_controller: bool = False, async_drain: bool = False,
               autoscale: bool = False,
               autoscale_watermark: bool = False,
               heartbeat_timeout: float = 3.0,
               simulate_recover: Optional[int] = None,
               job_manager: str = "inproc",
               job_manager_dir: Optional[str] = None,
               tenant_id: Optional[str] = None, priority: int = 0,
               manager_url: Optional[str] = None,
               straggler: Optional[Dict[int, float]] = None,
               measure_stage_times: bool = False) -> RunSpec:
    """The ``RunSpec`` equivalent of the legacy ``run_training`` kwargs —
    the single place the old vocabulary maps onto the spec schema."""
    return RunSpec(
        model=ModelSpec(arch=arch, layers=layers, d_model=d_model),
        parallel=ParallelSpec(stages=stages, num_micro=num_micro,
                              mb_global=mb_global, seq=seq,
                              kernel_impl=kernel_impl),
        dynamics=DynamicsSpec(kind=dynamism, **(dyn_overrides or {})),
        controller=ControllerSpec(
            balancer=balancer, rebalance_every=rebalance_every,
            repack=RepackSpec(enabled=repack, policy=repack_policy,
                              mem_cap=repack_mem_cap,
                              target=max(1, repack_target)),
            async_decide=async_controller, async_drain=async_drain,
            straggler=straggler,
            measure_stage_times=measure_stage_times),
        cluster=ClusterSpec(job_manager=job_manager,
                            job_manager_dir=job_manager_dir,
                            tenant_id=tenant_id, priority=priority,
                            manager_url=manager_url,
                            autoscale=autoscale,
                            autoscale_watermark=autoscale_watermark,
                            heartbeat_timeout=heartbeat_timeout,
                            simulate_recover=simulate_recover,
                            grow_back=grow_back),
        steps=steps, seed=seed, log_every=log_every, ckpt_dir=ckpt_dir)


def run_training(arch: str, *, device=None, params=None,
                 **kwargs) -> Dict[str, Any]:
    """Legacy kwarg entry point (deprecation shim).

    Builds the equivalent ``RunSpec`` and runs it through a ``Session`` —
    new code should do that directly:

        with Session(train_spec(arch, ...), device=device) as s:
            report = s.train()
    """
    spec = train_spec(arch, **kwargs)
    with Session(spec, device=device, params=params) as s:
        return s.train()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="DynMo trainer on the PyTorch/CUDA port (config-first: "
                    "--config RUN.JSON; flags below override spec fields)")
    add_config_args(ap)
    ap.add_argument("--resume", default=None, metavar="CKPT_DIR",
                    help="resume from the newest safe point in this "
                         "directory; the safe point carries the producing "
                         "RunSpec, so every other flag but --device, "
                         "--procs and --dist-backend is ignored")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="write the session's structured telemetry stream "
                         "(one JSON record per rebalance / resize / "
                         "relayout / autoscale / log event) to this file")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    add_dist_args(ap)
    add_alias_flags(ap, TRAIN_ALIASES)
    add_spec_flags(ap)
    return ap


def run(argv: Optional[List[str]] = None, *, params=None,
        resume: Optional[str] = None, resume_step: Optional[int] = None,
        on_step: Optional[Callable[[int, Session], None]] = None,
        gather: bool = False) -> Optional[Dict[str, Any]]:
    """Resolve the spec of ``argv`` and train it through a ``Session``;
    returns the report (with the event stream as ``session_events``), or
    None after ``--dump-config``.  ``params`` (a converted reference tree)
    replaces the engine's own init.  ``resume`` (a safe-point directory,
    or ``--resume``) and ``resume_step`` continue a run from its newest
    complete safe point, or from the one of ``resume_step``, as
    ``Session.resume(dir, step=...)`` does.  ``on_step(step, session)``
    runs after each step's safe point.  ``gather`` (with ``--procs``)
    brings the final params and optimizer state back whole."""
    args = build_parser().parse_args(argv)
    path = resume or args.resume
    if path:
        # the RunSpec is the safe point's; --device and --procs (Session
        # keywords, not spec fields) come from the command line
        sess = Session.resume(path, step=resume_step, device=args.device,
                              procs=args.procs,
                              dist_backend=args.dist_backend, gather=gather)
    else:
        spec = build_spec(args, TRAIN_ALIASES,
                          cli_defaults=TRAIN_CLI_DEFAULTS)
        if maybe_dump(args, spec):
            return None
        sess = Session(spec, device=args.device, params=params,
                       procs=args.procs, dist_backend=args.dist_backend,
                       gather=gather)
    with sess as s:
        rep = s.train(on_step=on_step)
    rep["session_events"] = [dataclasses.asdict(e) for e in sess.events]
    if args.events_out:
        sess.write_events(args.events_out)
        print(f"wrote {len(sess.events)} events to {args.events_out}")
    return rep


def main(argv=None):
    out = run(argv)
    if out is None:
        return
    ctl = out["controller"]
    print(f"done: loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f} "
          f"in {out['wall_s']:.1f}s; rebalances={len(out['events'])}; "
          f"resizes={len(out['resizes'])}; "
          f"relayouts={len(out['relayouts'])}; "
          f"final stages={out['final_stages']}; "
          f"controller[{ctl['mode']}] decided={ctl['decided']} "
          f"dropped={ctl['dropped']} stale={ctl['stale_rejected']}")
    for rz in out["resizes"]:
        print(f"  {rz['kind']} @step {rz['step']}: {rz['from_stages']}->"
              f"{rz['to_stages']} stages, workers {rz['workers']}, "
              f"{rz['seconds'] * 1e3:.0f}ms, ticks {rz['ticks_before']}->"
              f"{rz['ticks_after']}")
    for d in out["autoscale_decisions"]:
        print(f"  autoscale @step {d['step']}: {d['action']} "
              f"x{d['workers']} ({d['reason']})")
    for r in out.get("ranks", []):
        launched = {k: v["launches"] for k, v in r["launches"].items()
                    if v["launches"]}
        print(f"  rank {r['rank']} (stage {r['stage']}, replica "
              f"{r['replica']}, {r['device']}, {r['backend']}): launches "
              f"{launched}; rows sent {r['comm']['rows_sent']} received "
              f"{r['comm']['rows_recv']}; hand-offs "
              f"{r['comm']['handoffs']}")


if __name__ == "__main__":
    main()
