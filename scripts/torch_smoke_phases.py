"""Run the ``chip_smoke.py`` of a checkout with the wall seconds of each of
its phases recorded, for trees whose smoke test prints no
``[phase_seconds]`` line of its own (it came with phase 4r).

    python3 scripts/torch_smoke_phases.py ROOT

``ROOT`` holds ``chip_smoke.py`` and ``src/repro_torch`` (unpack an older
commit there with ``git archive``).  The script imports ROOT's smoke test
as a module, wraps its phase functions (and the serve CLI's ``run``, which
phase 4 calls inline) in timers that count only top-level calls — a
phase's nested serve or train runs belong to it — and runs its ``main``;
then it prints ``[phase_seconds] {...}`` after the smoke test's output
and exits with its code.  Needs a CUDA card, as the smoke test does.
"""
import importlib.util
import json
import sys
import time
from pathlib import Path

# function name -> phase, or a list of phases by call index
PHASE_OF = {
    "build": "2",
    "check_block_sparse_attention": "3", "check_pruned_matmul": "3",
    "check_paged_attention": "3b", "check_attention_backward": "3c",
    "check_pruned_matmul_backward": "3d", "check_grouped_matmul": "3e",
    "run": "4", "profile_serve": "4b", "run_train_phase": "4c",
    "profile_train": ["4d", "4g"], "run_moe_train_phase": "4e",
    "run_moe_serve_phase": "4f", "run_elastic_train_phase": "4h",
    "run_elastic_serve_phase": "4i", "run_ee_train_phase": "4j",
    "run_ee_serve_phase": "4j", "run_ckpt_phase": "4k",
    "run_ctl_phase": "4l", "run_sampling_serve_phase": "4m",
    "run_autoscale_train_phase": "4n", "run_autoscale_serve_phase": "4o",
    "run_two_tenant_phase": "4p", "run_front_door_phase": "4q",
    "run_fault_phase": "4r",
    "serve_parity": ["5", "5c", "5d"],
    "train_parity": ["5b", "5c", "5c", "5d", "5d"],
    "moe_placement_neutrality": "5c", "mod_bitwise": "5d",
}


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timed", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    seconds, calls, depth = {}, {}, [0]

    def wrap(owner, name):
        fn = getattr(owner, name)

        def timed(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
                n = calls.get(name, 0)
                calls[name] = n + 1
                ph = PHASE_OF[name]
                if isinstance(ph, list):
                    ph = ph[min(n, len(ph) - 1)]
                seconds[ph] = seconds.get(ph, 0.0) + (
                    time.perf_counter() - t0)

        setattr(owner, name, timed)

    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    wrap(_build, "build")
    wrap(serve, "run")
    for name in PHASE_OF:
        if name not in ("build", "run") and hasattr(smoke, name):
            wrap(smoke, name)
    t0 = time.perf_counter()
    rc = smoke.main()
    total = time.perf_counter() - t0
    print("[phase_seconds] " + json.dumps(
        {"total": round(total, 1),
         **{k: round(v, 1) for k, v in seconds.items()}}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
