"""Run one cell of the benchmark once: set up, measure a window of
training steps, check what the window's program produced against the
plain reference, and return the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration's file (``configs/``), its traffic mix
(``traffic/<mix>.json``), the limits of its comparison
(``limits/<cell>.json``) and one reader per per-layer metric
(``metrics/<metric>.py``).  This file holds no cell, mix or metric.

The run, in order:

1. Set-up (``setup_s``): resolve the RunSpec from the configuration's and
   the mix's flags and the seed; make the weights on the device from the
   seed; start the program's training loop on them.  The loop's first
   steps are set-up as well: the checked steps (see 3) run through the
   same call and feed as the window's, with the harness reading the
   program's state between them.
2. The window: from the end of the last set-up step, every step until
   the first step boundary at least ``--seconds`` later.  The work of a
   step is the cell's (a fixed spec ``steps`` sets the schedules), not
   how many steps fit.  With ``--trace 1`` a few steady steps run under
   the profiler.
3. The check, once the window has closed, its peak memory is read and
   the program's state is freed: the reference follows every set-up step
   from the same weights and batches, through the first prune
   (``reference/follow.py``), and ``reference/compare.judge`` holds the
   program's readings to it.  Every migration the controller makes, in
   set-up or in the window, is held to carry each logical layer's
   parameters, moments and mask over bit for bit (``program.carried``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import program  # noqa: E402
from reference import compare, data, dense, follow, formulas  # noqa: E402
from reference import schedule  # noqa: E402
from reference import weights as wmod  # noqa: E402
import devtrace  # noqa: E402

B1 = dense.OPT["b1"]


class WindowClosed(Exception):
    """Raised from the step hook to end the program's loop."""


def manifest(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, man: Dict[str, Any], name: str,
              data_dir: Path = ROOT):
    cells = {c["name"]: c for c in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(data_dir / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    with open(data_dir / "limits" / f"{name}.json") as f:
        limits = json.load(f)["limits"]
    return cell, config, traffic, limits


# the configuration file's published keys -> the reference's widths
WIDTH_KEYS = {"num_hidden_layers": "layers", "hidden_size": "d",
              "num_attention_heads": "hq", "num_key_value_heads": "hkv",
              "head_dim": "hd", "intermediate_size": "ff",
              "vocab_size": "vocab", "rope_theta": "theta",
              "rms_norm_eps": "eps", "tie_word_embeddings": "tied"}
KINDS = {"theta": float, "eps": float, "tied": bool}


def widths(config: Dict[str, Any]) -> Dict[str, Any]:
    """The widths the configuration's file states it is run at."""
    run = config["as_run"]
    return {v: KINDS.get(v, int)(run[k]) for k, v in WIDTH_KEYS.items()}


def load_readers(man: Dict[str, Any], cell: Dict[str, Any]):
    """The reader module of every per-layer metric this cell reports."""
    e2e = {m["name"]: m for m in man["end_to_end"]}
    if str(ROOT / "metrics") not in sys.path:
        sys.path.insert(0, str(ROOT / "metrics"))
    out = []
    for m in man["per_layer"]:
        if "workloads" in m:
            if cell["name"] not in m["workloads"]:
                continue
        elif cell["name"] not in e2e[m["moves"]].get("workloads",
                                                     [cell["name"]]):
            continue
        path = ROOT / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out.append((m, mod))
    return out


def _norms(leaves: Dict[str, torch.Tensor], scale: float):
    return {k: float(torch.linalg.vector_norm(t.float())) * scale
            for k, t in leaves.items()}


def prepare(root: Path, workload: str, seed: int, device: str,
            manifest_path: Optional[Path] = None,
            data_dir: Path = ROOT) -> SimpleNamespace:
    """A cell as the program resolves it for ``seed``: its manifest entry,
    configuration, traffic and limits, the RunSpec and model shapes, the
    widths (held to the configuration's file), the checked steps
    (``plan``) and the dtype of the layers' weights."""
    man = manifest(manifest_path or root / "BENCHMARK.json")
    cell, config, traffic, limits = load_cell(root, man, workload, data_dir)
    dev = torch.device(device)
    argv = (list(config["cli"]) + list(traffic["cli"])
            + ["--seed", str(int(seed)), "--device", device])
    spec = program.resolve_spec(argv, config.get("arch"))
    shapes = program.model_shapes(spec, dev)
    c = widths(config)
    if c != shapes["widths"]:
        raise ValueError(f"the program runs {shapes['widths']}, the "
                         f"configuration states {c}")
    dyn = spec.dynamics
    plan = follow.Plan.of(traffic["check"], c["layers"], shapes["npb"],
                          int(spec.steps),
                          (dyn.prune_initial_sparsity,
                           dyn.prune_final_sparsity)
                          if dyn.kind == "pruning" else None)
    missing = set(compare.limit_names(plan)) - set(limits)
    if missing:
        raise KeyError(f"{workload}: no limit for {sorted(missing)}")
    layer_dtype = (torch.bfloat16 if spec.parallel.param_dtype == "bfloat16"
                   else torch.float32)
    return SimpleNamespace(man=man, cell=cell, config=config,
                           traffic=traffic, limits=limits, dev=dev,
                           argv=argv, spec=spec, shapes=shapes, c=c,
                           plan=plan, layer_dtype=layer_dtype)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda",
             t_start: Optional[float] = None,
             manifest_path: Optional[Path] = None,
             data_dir: Path = ROOT) -> Dict[str, Any]:
    """One run of ``workload``; returns the result line's object.
    ``manifest_path`` / ``data_dir`` default to ``BENCHMARK.json`` and
    this directory (the tests point them at a tiny cell)."""
    t_start = time.perf_counter() if t_start is None else t_start

    def log(what: str) -> None:
        print(f"[t={time.perf_counter() - t_start:.2f}s] {what}",
              file=sys.stderr, flush=True)

    P = prepare(root, workload, seed, device, manifest_path, data_dir)
    man, cell, config, traffic, limits = (P.man, P.cell, P.config,
                                          P.traffic, P.limits)
    dev, argv, spec, shapes, c, plan = (P.dev, P.argv, P.spec, P.shapes,
                                        P.c, P.plan)
    L, npb = c["layers"], shapes["npb"]
    par, dyn = spec.parallel, spec.dynamics
    steps_total = int(spec.steps)
    tokens_per_step = par.num_micro * par.mb_global * par.seq
    rows = par.num_micro * par.mb_global
    layer_dtype = P.layer_dtype
    pruning = dyn.kind == "pruning"
    first_window = plan.last + 1

    def live_ff(step: int) -> float:
        if not pruning:
            return float(L * c["ff"])
        return schedule.live_blocks(
            step, steps_total, L, npb, dyn.prune_initial_sparsity,
            dyn.prune_final_sparsity) * (c["ff"] / npb)

    def step_flops(step: int) -> float:
        return formulas.dense_step_flops(
            layers=L, d=c["d"], hq=c["hq"], hkv=c["hkv"], hd=c["hd"],
            vocab=c["vocab"], rows=rows, seq=par.seq,
            live_ff=live_ff(step))

    # ---- the weights: made here from the seed, handed to the program
    lps0 = schedule.uniform_split(L, shapes["stages"])
    W = wmod.make(c, seed, dev, layer_dtype)
    tree = program.pack(W, shapes, lps0)
    del W
    log("weights made")

    rec = program.Recorder(sync_steps=trace)
    got: Dict[str, Any] = {"count": {}}
    win: Dict[str, Any] = {"stamps": [], "t0": None}
    prof_at = (first_window + int(traffic["trace"]["after"])
               if trace else None)
    prof_n = int(traffic["trace"]["steps"])
    prof: Dict[str, Any] = {"p": None, "masks": None}
    out_dir = root / "build" / "portbench" / workload

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def hook(step: int, session) -> None:
        now = time.perf_counter()
        if len(rec.steps) != step + 1:
            raise RuntimeError(f"step {step}: the harness saw "
                               f"{len(rec.steps)} steps")
        st = rec.state
        if step >= first_window:
            win["stamps"].append(now)
            if prof_at is not None and step == prof_at:
                prof["masks"] = program.layer_masks(st.dyn, st.lps).cpu()
                prof["p"] = _start_profiler()
                rec.spans_on = True
                prof["marks"] = [time.time_ns()]
            elif prof["p"] is not None and not prof.get("done"):
                prof["marks"].append(time.time_ns())
                if step == prof_at + prof_n:
                    prof["p"].stop()
                    rec.spans_on = False
                    prof["done"] = True
            if (now - win["t0"] >= seconds
                    and step - first_window + 1 >= 2
                    and (prof_at is None or prof.get("done"))):
                raise WindowClosed()
            return
        # the program's readings, as ``follow.readings`` takes the
        # reference's
        with torch.no_grad():
            leaves = program.layer_leaves(st.params, st.lps)
            if step == 0:
                m = program.layer_leaves(st.opt_state["m"], st.lps)
                got["grad0"] = _norms(m, 1.0 / (1.0 - B1))
            for at, key in ((plan.a_n - 1, "change_a"),
                            (plan.b_from, "state_b")):
                if step == at:
                    W0 = wmod.make(c, seed, dev, layer_dtype)
                    got[key] = compare.change_norms(
                        leaves, dense.leaf_views(W0, L))
                    del W0
            if step == plan.b_from:
                got["then"] = {k: t.detach().cpu().clone()
                               for k, t in leaves.items()}
                if plan.mask_step is not None:
                    got["mask"] = program.layer_masks(st.dyn, st.lps).cpu()
            if plan.b_from is not None and step == plan.last:
                got["change_b"] = compare.change_norms(leaves,
                                                       got.pop("then"))
            if step in (plan.b_from, plan.last):
                got["count"][step] = int(st.opt_state["count"])
            del leaves
        if step in (0, plan.a_n - 1, plan.mask_step, plan.b_from,
                    plan.last):
            log(f"set-up step {step} done; layers per stage "
                f"{list(st.lps)}")
        if step == first_window - 1:
            sync()
            got["setup_peak"] = _peak(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            win["t0"] = time.perf_counter()

    def _start_profiler():
        from torch.profiler import ProfilerActivity, profile
        p = profile(activities=[ProfilerActivity.CUDA
                                if dev.type == "cuda"
                                else ProfilerActivity.CPU])
        p.start()
        return p

    with rec.installed():
        try:
            program.train(argv, tree, hook)
            ended = "steps"
        except WindowClosed:
            ended = "seconds"
    del tree
    sync()
    log(f"window closed ({ended})")
    window_peak = _peak(dev)
    losses = [float(s["loss"]) for s in rec.steps]
    got["loss"] = {k: losses[k] for k in range(plan.last + 1)}
    step_tokens = [s["tokens"] for s in rec.steps[:plan.last + 1]]
    spans = [(s["t0"], s["t1"]) for s in rec.steps]
    decides = list(rec.decides)
    got["migrations"] = list(rec.migrations)
    for n, lps0, lps1, alone, total in rec.migrations:
        log(f"migration {lps0} -> {lps1}: {n} entries not carried over "
            f"bit for bit; {alone:.4f} s, {total:.4f} s with the check")
    rec.state = None
    rec.steps.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the window's end-to-end numbers
    stamps = win["stamps"]
    times = [b - a for a, b in zip([win["t0"]] + stamps[:-1], stamps)]
    w_steps = list(range(first_window, first_window + len(times)))
    wall = stamps[-1] - win["t0"] if stamps else float("nan")
    setup_s = win["t0"] - t_start
    flops = sum(step_flops(k) for k in w_steps)
    peak_flops = formulas.PEAK_FLOPS[config["dtype"]]
    result_metrics = {
        "train_tokens_per_s": (tokens_per_step * len(times) / wall,
                               "tokens/s"),
        "train_mfu": (100.0 * flops / wall / peak_flops, "%"),
        "train_step_ms_p90": (1e3 * _p90(times), "ms"),
        "setup_s": (setup_s, "s"),
    }
    print(f"[window] setup_s={setup_s!r} steps={len(times)} wall_s={wall!r} "
          f"ended_by={ended} "
          f"first_step={first_window} step_ms_median="
          f"{1e3 * statistics.median(times) if times else float('nan')!r} "
          f"p90_over={len(times)} flops={flops!r} peak={peak_flops!r}",
          file=sys.stderr)
    print("[step_ms] " + json.dumps([round(1e3 * t, 3) for t in times]),
          file=sys.stderr)

    # ---- the traced run's per-layer numbers
    summary = None
    if trace and prof["p"] is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / "trace.json"
        prof["p"].export_chrome_trace(str(path))
        prof["p"] = None
        summary = devtrace.reduce_trace(str(path), prof["marks"],
                                        rec.spans_ns)

    # ---- the check
    log("trace read" if trace else "check starts")
    checks = check(c, config, limits, seed, dev, layer_dtype, got,
                   step_tokens, steps_total, par, plan)
    log("check done")
    correct = all(v <= lim for v, lim in checks.values())
    n_bad = sum(1 for k in w_steps if not math.isfinite(losses[k]))

    # what a per-layer reader may read (``metrics/``)
    ctx = {"cell": cell, "config": config, "widths": c,
           "dtype": config["dtype"], "times": times, "steps": w_steps,
           "spans": spans, "decides": decides, "window_peak": window_peak,
           "trace": summary, "prof_at": prof_at, "prof_n": prof_n,
           "masks": prof["masks"], "seq": par.seq,
           "rows_per_micro": par.mb_global, "micro": par.num_micro,
           "step_flops": step_flops, "win_t0": win["t0"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": int(max(got.get("setup_peak", 0),
                                                window_peak))}
    out: Dict[str, Any] = {"correct": bool(correct and n_bad == 0),
                           "attempted": len(times), "failed": n_bad}
    if trace:
        metrics = {}
        for m, mod in load_readers(man, cell):
            v = mod.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        if summary is not None:
            device_info["busy_s"] = summary["busy_s"]
            device_info["window_s"] = summary["window_s"]
        out["device"] = device_info
        if summary is not None:
            out["breakdown"] = devtrace.breakdown(summary)
    else:
        out["metrics"] = {k: {"value": v, "unit": u}
                          for k, (v, u) in result_metrics.items()}
        out["device"] = device_info
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def _p90(xs: List[float]) -> float:
    if len(xs) < 2:
        return xs[0] if xs else float("nan")
    return statistics.quantiles(xs, n=10, method="inclusive")[8]


def _peak(dev) -> int:
    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)


def check(c, config, limits, seed, dev, layer_dtype, got, step_tokens,
          steps_total, par, plan) -> Dict[str, tuple]:
    """{number: (value, limit)}: the reference follows the set-up steps
    from the seed's weights and batches, and ``compare.judge`` holds the
    program's readings ``got`` to it."""
    bt = data.take(c["vocab"], par.num_micro, par.mb_global, par.seq,
                   int(seed), range(plan.last + 1))
    got["tokens_wrong"] = sum(
        int(not (step_tokens[k] == bt[k]["tokens"]).all())
        for k in range(plan.last + 1))
    choose = (follow.following(got["mask"], plan.keep)
              if plan.mask_step is not None else None)
    with _fp32_only():
        ref = follow.readings(
            c, wmod.make(c, seed, dev, layer_dtype), bt,
            lambda k: schedule.cosine_lr(k, steps_total), plan, choose,
            chunk_rows=int(config.get("ref_chunk_rows", 2)))
    where: Dict[str, str] = {}
    out = compare.judge(got, ref, limits, plan, where)
    print("[check] worst leaves " + json.dumps(where), file=sys.stderr)
    return out


class _fp32_only:
    """TF32 off for the reference's products, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, prec) = self.saved
        torch.set_float32_matmul_precision(prec)
