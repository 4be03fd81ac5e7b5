"""The program's spans laid on a run of a cell, for its notes.  The
benchmark's runs never run this.

    python3 portbench/spans_report.py traced --workload NAME --seed N \
        [--seconds S]
    python3 portbench/spans_report.py cost --workload NAME --seed N \
        --tracer 0|1 [--seconds S]

``traced``: one ``--trace 1`` run of the harness; then per traced step the
device ms of ``step.forward``, ``step.backward`` and ``step.optimizer``
beside the device's busy time and the window, the ten longest idle gaps
labelled by program span (``program_spans.label_gaps``), the host ms of
each loop span, and the clock check: each traced step's first AdamW
kernel (``addcmul``, which only AdamW launches) starts after its
``step.optimizer`` span starts and before the first kernel that follows
the next step's ``step.forward`` start.

``cost``: one untraced run with a tracer current for the whole run
(``--tracer 1``) or none; the window's step median, and the host us a
span costs (a loop span, and a step's five phase boundaries on the
run's device).

Each prints one JSON line last, from the root of a checkout on a machine
with a card."""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import statistics
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
import run  # noqa: E402  (the program's caches, as a run sets them)

ROOT = run.ROOT


class _Tee(io.StringIO):
    def write(self, s):
        sys.__stderr__.write(s)
        return super().write(s)


def _harness(workload, seed, seconds, trace):
    sys.path.insert(0, str(ROOT / "src"))
    import harness
    err = _Tee()
    with contextlib.redirect_stderr(err):
        out = harness.run_cell(ROOT, workload, seed % (1 << 32), seconds,
                               trace, device="cuda",
                               t_start=run.T_START)
    m = re.search(r"step_ms_median=([0-9.e+-]+|nan)", err.getvalue())
    return out, float(m.group(1)) if m else float("nan")


def traced(args):
    import devtrace
    import program_spans
    seen = {}
    reduce0 = devtrace.reduce_trace

    def reduce(path, marks, spans):
        seen.update(path=path, marks=list(marks), spans=list(spans))
        return reduce0(path, marks, spans)

    devtrace.reduce_trace = reduce
    out, median = _harness(args.workload, args.seed, args.seconds, True)
    spans = program_spans.read() or []
    res = {"correct": out["correct"], "metrics": out["metrics"],
           "device": out["device"], "step_ms_median": median,
           "breakdown_idle_gaps": out.get("breakdown", {}).get("idle_gaps")}
    if not spans or "path" not in seen:
        res["error"] = "no program spans or no device trace"
        return res
    res["idle_gaps"] = program_spans.label_gaps(
        seen["path"], seen["marks"], seen["spans"], spans)
    n = program_spans.steps(spans)
    host = {}
    for s in spans:
        if s["parent"] is not None:
            host[s["name"]] = host.get(s["name"], 0.0) + (
                s["end_ns"] - s["start_ns"]) / 1e6 / n
    res["host_ms_a_step"] = dict(sorted(host.items(), key=lambda kv: -kv[1]))
    by_step = {}
    for s in spans:
        if s["name"].startswith("step."):
            by_step.setdefault(s["step"], {})[s["name"]] = s
    with open(seen["path"]) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    kernels = sorted((base + float(e["ts"]) * 1e3, e.get("name", ""))
                     for e in doc["traceEvents"]
                     if e.get("cat") == "kernel" and "ts" in e)
    w0, w1 = seen["marks"][0], seen["marks"][-1]
    summary = devtrace.reduce_trace(seen["path"], seen["marks"], [])
    res["busy_ms_a_step"] = 1e3 * summary["busy_s"] / summary["steps"]
    res["window_ms_a_step"] = 1e3 * summary["window_s"] / summary["steps"]
    steps, checks = sorted(by_step), []
    for i, k in enumerate(steps):
        ph = by_step[k]
        opt = ph["step.optimizer"]["start_ns"]
        nxt = w1
        if i + 1 < len(steps):
            fwd = by_step[steps[i + 1]]["step.forward"]["start_ns"]
            nxt = next((t for t, _ in kernels if t >= fwd), w1)
        first = next((t for t, name in kernels
                      if t >= w0 and "addcmul" in name
                      and t >= ph["step.forward"]["start_ns"]), None)
        checks.append({"step": k,
                       "device_ms": {n_: ph[n_]["device_ms"]
                                     for n_ in sorted(ph)},
                       "adamw_after_optimizer_start_ms":
                       None if first is None else (first - opt) / 1e6,
                       "adamw_before_next_forward_ms":
                       None if first is None else (nxt - first) / 1e6})
    res["steps"] = checks
    res["clocks_agree"] = all(
        c["adamw_after_optimizer_start_ms"] is not None
        and c["adamw_after_optimizer_start_ms"] > 0
        and c["adamw_before_next_forward_ms"] > 0 for c in checks)
    fbo = [sum(c["device_ms"].get(n_) or 0.0 for n_ in
               ("step.forward", "step.backward", "step.optimizer"))
           for c in checks]
    res["fbo_device_ms_a_step"] = sum(fbo) / len(fbo)
    return res


def cost(args):
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.obs import trace as T
    from repro_torch.obs.timing import StepSpans
    tr = T.Tracer("cost") if args.tracer else None
    T.set_current_tracer(tr)
    try:
        out, median = _harness(args.workload, args.seed, args.seconds,
                               False)
    finally:
        T.set_current_tracer(None)
    res = {"tracer": args.tracer, "correct": out["correct"],
           "step_ms_median": median,
           "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
    if tr is not None:
        evs = tr.to_chrome()["traceEvents"]
        res["spans"] = len(evs)
        res["train_steps"] = sum(1 for e in evs if e["name"] == "train.step")
    # the host us a span costs, alone
    probe = T.Tracer("probe")
    n = 20000
    t0 = time.perf_counter()
    for i in range(n):
        probe.span("train.log", cat="train", step=i).end()
    res["loop_span_us"] = (time.perf_counter() - t0) / n * 1e6
    spans = StepSpans(torch.device("cuda"))
    n = 2000
    with probe.span("train.step", step=0):
        t0 = time.perf_counter()
        for _ in range(n):
            phase = spans.begin(probe)
            for name in ("step.batch", "step.forward", "step.backward",
                         "step.optimizer", None):
                phase(name)
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        spans.resolve()
    res["step_phases_us"] = dt / n * 1e6
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("traced", "cost"))
    ap.add_argument("--workload", default="smollm360m.train.prune")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(4)
    res = traced(args) if args.mode == "traced" else cost(args)
    res["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
