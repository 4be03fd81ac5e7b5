"""Cluster control-plane demo on the PyTorch/CUDA port: asynchronous
decisions + signal-driven elasticity.

  * the DynMo controller decides on a background thread (double-buffered
    stats mailbox — the training thread only publishes snapshots);
  * gradual pruning shrinks the model until the controller's repack
    decision consolidates 4 stage buffers onto 2 live;
  * the released workers go back to a job manager running in a SEPARATE
    process (file-backed RPC, ``repro_torch.cluster.rpc``);
  * mid-run the released machines "come back" (simulated heartbeat
    recovery) and the autoscaler grows the pipeline to 4 again.

The whole story is one ``RunSpec``: serialize it with ``spec.to_json()``
and the identical run is ``python -m repro_torch.launch.train --config
...``.

    PYTHONPATH=src python examples/torch_autoscale_cluster.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--recover-at", type=int, default=18,
                    help="step at which released workers start "
                         "heartbeating again")
    ap.add_argument("--job-manager", default="file",
                    choices=["inproc", "file"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.api import (ClusterSpec, ControllerSpec, DynamicsSpec,
                                 ModelSpec, ParallelSpec, RepackSpec,
                                 RunSpec, Session)
    spec = RunSpec(
        model=ModelSpec(arch="smollm-360m", layers=8, d_model=128),
        parallel=ParallelSpec(stages=4, num_micro=4, mb_global=2, seq=32),
        dynamics=DynamicsSpec(kind="pruning"),
        controller=ControllerSpec(rebalance_every=5,
                                  repack=RepackSpec(enabled=True),
                                  async_decide=True),
        cluster=ClusterSpec(job_manager=args.job_manager, autoscale=True,
                            simulate_recover=args.recover_at),
        steps=args.steps, log_every=5)

    with Session(spec, device=args.device) as s:
        out = s.train()

    ctl = out["controller"]
    print(f"\nloss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}; "
          f"controller[{ctl['mode']}] decided={ctl['decided']} "
          f"dropped={ctl['dropped']} stale-rejected={ctl['stale_rejected']}")
    print(f"pool transitions over the {args.job_manager} boundary: "
          f"{out['pool_log']}")
    for ev in s.events:
        if ev.kind == "resize":
            print(f"  {ev.data['resize_kind']} @step {ev.step}: "
                  f"{ev.data['from_stages']}->{ev.data['to_stages']} "
                  f"stages, workers {ev.data['workers']}, schedule "
                  f"{ev.data['ticks_before']}->{ev.data['ticks_after']} "
                  f"ticks")
        elif ev.kind == "autoscale":
            print(f"  autoscale @step {ev.step}: {ev.data['action']} "
                  f"x{ev.data['workers']} ({ev.data['reason']})")
    assert out["final_stages"] == 4, "expected the recovery grow to land"
    return out


if __name__ == "__main__":
    main()
