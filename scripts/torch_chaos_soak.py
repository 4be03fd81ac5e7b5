"""Chaos soak of the PyTorch port (the counterpart of
``scripts/chaos_soak.py``): a fault-free baseline against a seeded-chaos
run of the same spec, with the acceptance checks asserted and the
fault-event log written as JSON.

  train: auto-derived faults (worker crash, job-manager kill -9 and
         respawn, RPC loss + duplication, straggler spike) against the
         file job manager; the chaos run must end within ``LOSS_TOL`` of
         the baseline — a crash costs capacity, never correctness.
  serve: a worker crash mid-flight; the chaos run must complete the same
         request -> tokens map as the baseline (no lost request, every
         in-flight request requeued and replayed).

The specs are the reference soak's (reduced smollm: 8 layers, d_model 64,
4 stages).  Runs on the CUDA card unless ``--device cpu``:

  PYTHONPATH=src python scripts/torch_chaos_soak.py --mode train \\
      --fault-seed 1 --device cpu --out chaos_events_train_1.json
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.api import RunSpec, Session  # noqa: E402

LOSS_TOL = 3e-3     # ULP-level drift of a different stage split

TRAIN_BASE = {
    "steps": 16, "seed": 5, "log_every": 4,
    "model": {"arch": "smollm-360m", "layers": 8, "d_model": 64,
              "num_heads": 4, "num_kv_heads": 2, "d_ff": 256,
              "vocab_size": 512},
    "parallel": {"stages": 4, "num_micro": 2, "mb_global": 2, "seq": 32,
                 "remat": "none", "param_dtype": "float32"},
    "cluster": {"job_manager": "file", "autoscale": True,
                "heartbeat_timeout": 3.0, "rpc_timeout_s": 2.0,
                "spares": 1},
}

SERVE_BASE = {
    "seed": 3,
    "model": {"arch": "smollm-360m", "layers": 8, "d_model": 64,
              "num_heads": 4, "num_kv_heads": 2, "d_ff": 256,
              "vocab_size": 512},
    "parallel": {"stages": 4, "num_micro": 2, "mb_global": 2, "seq": 16,
                 "remat": "none", "param_dtype": "float32"},
    "serve": {"requests": 10, "prompt_len": 16, "gen": 12, "min_prompt": 4,
              "burst_period": 6, "burst_len": 2, "burst_rate": 3,
              "lull_rate": 1},
    "cluster": {"job_manager": "inproc", "autoscale": False, "spares": 1},
}


def _chaos(base: dict, fault_seed: int) -> dict:
    return {**base, "faults": {"enabled": True, "auto": True,
                               "seed": fault_seed}}


def soak_train(fault_seed: int, device) -> dict:
    with Session(RunSpec.from_dict(dict(TRAIN_BASE)), device=device) as s:
        base = s.train()
    with Session(RunSpec.from_dict(_chaos(TRAIN_BASE, fault_seed)),
                 device=device) as s:
        chaos = s.train()
    diffs = [abs(a - b) for a, b in zip(base["losses"], chaos["losses"])]
    verdict = {
        "steps": len(chaos["losses"]),
        "max_loss_diff": max(diffs),
        "loss_tol": LOSS_TOL,
        "resizes": [(r["kind"], r["step"]) for r in chaos["resizes"]],
        "ok": (len(chaos["losses"]) == TRAIN_BASE["steps"]
               and max(diffs) < LOSS_TOL),
    }
    return {"mode": "train", "fault_seed": fault_seed, "verdict": verdict,
            "fault_plan": chaos["fault_plan"], "events": chaos["faults"],
            "degraded_events": chaos["degraded_events"],
            "rpc": chaos["rpc"],
            "baseline_losses": base["losses"],
            "chaos_losses": chaos["losses"]}


def soak_serve(fault_seed: int, device) -> dict:
    with Session(RunSpec.from_dict(dict(SERVE_BASE)), device=device) as s:
        base = s.serve()
    with Session(RunSpec.from_dict(_chaos(SERVE_BASE, fault_seed)),
                 device=device) as s:
        chaos = s.serve()
    tok_a = {c["rid"]: c["tokens"] for c in base["completions"]}
    tok_b = {c["rid"]: c["tokens"] for c in chaos["completions"]}
    mismatched = sorted(r for r in tok_a if tok_b.get(r) != tok_a[r])
    verdict = {
        "requests": len(tok_a),
        "lost_requests": sorted(set(tok_a) - set(tok_b)),
        "token_mismatches": mismatched,
        "requeued_total": chaos["requeued_total"],
        "resizes": [(r["kind"], r["step"]) for r in chaos["resizes"]],
        "ok": set(tok_a) == set(tok_b) and not mismatched,
    }
    return {"mode": "serve", "fault_seed": fault_seed, "verdict": verdict,
            "fault_plan": chaos["fault_plan"], "events": chaos["faults"],
            "degraded_events": chaos["degraded_events"],
            "completions": chaos["completions"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["train", "serve"], required=True)
    ap.add_argument("--fault-seed", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--out", default=None, metavar="EVENTS.JSON",
                    help="write the fault-event log here")
    args = ap.parse_args(argv)
    log = (soak_train if args.mode == "train" else soak_serve)(
        args.fault_seed, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(log, f, indent=1)
    v = log["verdict"]
    print(f"chaos soak [{log['mode']} seed {log['fault_seed']}]: "
          f"{'PASS' if v['ok'] else 'FAIL'} {v}")
    print(f"  injected: {[(e['step'], e['kind']) for e in log['events']]}")
    if log["degraded_events"]:
        print(f"  degraded: {log['degraded_events']}")
    return 0 if v["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
