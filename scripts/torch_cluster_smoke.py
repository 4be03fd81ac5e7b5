"""Two-tenant HTTP contention smoke of the PyTorch port (the counterpart
of ``scripts/cluster_smoke.py``).

Spawns ONE port HTTP job manager over a 6-worker pool, then a port CLI
trainer
(tenant ``train``, priority 0, 4 stages) and a port CLI elastic server
(tenant
``serve``, priority 10, 2..4 stages, bursty trace) as separate processes.
The serve burst must steal training workers (the trainer shrinks at a safe
point) and the lull must yield them back (the trainer absorbs) — asserted
from both sides' ``--events-out`` streams.

Observability gates, both tenants run with ``obs.trace``:

  * the manager's ``GET /metrics`` Prometheus page is scraped before
    shutdown and its ``dynmo_scheduler_events_total`` counters must equal
    the per-(tenant, event) counts in the scheduler's own events stream —
    the two views are derived from one list, disagreement is a bug;
  * the two trace files must hold ONE causally-linked cross-process chain
    ``rpc.steal -> cluster.preempt -> resize.shrink`` (serve's steal RPC
    parents train's preemption directive parents train's safe-point
    shrink), validated by ``scripts/torch_check_trace.py``.

The tenants run on the CUDA card unless ``--device cpu``; ``--steps`` and
``--requests`` cut the run (defaults: the reference smoke's 120 and 300).

  PYTHONPATH=src python scripts/torch_cluster_smoke.py --device cpu

Exit 0 = contention + observability verified end-to-end; non-zero = a
tenant died, the steal/yield never crossed the scheduler, the metrics
page drifted from the events stream, or the trace chain broke.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
sys.path.insert(0, SRC)

sys.path.insert(0, os.path.join(REPO, "scripts"))

from repro_torch.cluster.http_rpc import (HttpJobManager,  # noqa: E402
                                          spawn_http_manager)

ENV = {**os.environ, "PYTHONPATH": SRC}


def _spawn_cli(module: str, args: list, log_path: str) -> subprocess.Popen:
    log = open(log_path, "w")
    return subprocess.Popen([sys.executable, "-m", module] + args,
                            stdout=log, stderr=subprocess.STDOUT,
                            text=True, env=ENV)


# label order is the registry's sorted-label identity: event < tenant
_PROM_LINE = re.compile(
    r'^dynmo_scheduler_events_total\{event="([^"]*)",tenant="([^"]*)"\} '
    r'(\d+(?:\.\d+)?)$')


def _check_metrics_page(url: str, events: list) -> list:
    """Scrape GET /metrics and diff the scheduler-event counters against
    the events stream the ``metrics`` RPC verb returned."""
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        assert "version=0.0.4" in r.headers.get("Content-Type", "")
        page = r.read().decode()
    scraped = {}
    for line in page.splitlines():
        m = _PROM_LINE.match(line)
        if m:
            scraped[(m.group(2), m.group(1))] = float(m.group(3))
    expected = {}
    for ev in events:
        key = (str(ev.get("tenant")), ev["ev"])
        expected[key] = expected.get(key, 0.0) + 1.0
    failures = []
    if not scraped:
        failures.append("metrics page had no dynmo_scheduler_events_total")
    if scraped != expected:
        failures.append(f"metrics page drifted from the events stream: "
                        f"scraped={scraped} expected={expected}")
    for ev in events:
        if ev.get("schema") != "obs.event/1" or ev.get("kind") != ev["ev"]:
            failures.append(f"scheduler event missing unified fields: {ev}")
            break
    steals = [ev for ev in events if ev["ev"] == "steal"]
    if steals and not any(ev.get("trace_id") for ev in steals):
        failures.append("no steal event carried a propagated trace_id "
                        "(RPC trace context never reached the scheduler)")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--steps", type=int, default=120,
                    help="the trainer's steps")
    ap.add_argument("--requests", type=int, default=300,
                    help="the server's requests")
    args = ap.parse_args(argv)
    device = ["--device", args.device] if args.device else []
    run_dir = tempfile.mkdtemp(prefix="torch_cluster_smoke_")
    mgr, url = spawn_http_manager(run_dir, 6, spares=0, idle_timeout_s=900)
    train_events = os.path.join(run_dir, "train_events.json")
    serve_events = os.path.join(run_dir, "serve_events.json")
    train_trace = os.path.join(run_dir, "train.trace.json")
    serve_trace = os.path.join(run_dir, "serve.trace.json")
    train_log = os.path.join(run_dir, "train.log")
    serve_log = os.path.join(run_dir, "serve.log")
    print(f"manager {url} (pool 6, journal {run_dir})")
    children = []
    try:
        train = _spawn_cli("repro_torch.launch.train", device + [
            "--arch", "smollm-360m", "--layers", "8", "--d-model", "64",
            "--stages", "4", "--steps", str(args.steps), "--seq", "32",
            "--num-micro", "2", "--mb-global", "2", "--log-every", "1000",
            "--rebalance-every", "4", "--job-manager", "http",
            "--manager-url", url, "--tenant-id", "train", "--priority", "0",
            "--set", "controller.repack.target=2",
            "--set", "obs.trace=true",
            "--set", f"obs.trace_out={train_trace}",
            "--events-out", train_events], train_log)
        children.append(("train", train, train_log))
        # let the trainer claim its 4 before the server joins, so the serve
        # burst has to STEAL (a fresh pool would hand it free workers)
        probe = HttpJobManager(url, client_id="smoke-probe")
        for _ in range(600):
            t = probe.cluster_metrics()["tenants"].get("train")
            if t and len(t["granted"]) == 4:
                break
            time.sleep(0.1)
        else:
            raise RuntimeError("trainer never registered with the manager")
        print("trainer registered: 4 workers granted")
        serve = _spawn_cli("repro_torch.launch.serve", device + [
            "--elastic", "--autoscale", "--arch", "smollm-360m",
            "--layers", "8", "--d-model", "64", "--stages", "4",
            "--micro", "2", "--mb-global", "2", "--prompt-len", "8",
            "--gen", "12", "--requests", str(args.requests),
            "--burst-period", "24",
            "--burst-len", "6", "--burst-rate", "4", "--lull-rate", "0",
            "--min-stages", "2", "--queue-high", "2",
            "--occupancy-low", "0.6", "--patience", "2", "--cooldown", "3",
            "--latency-slo-s", "0.5", "--log-every", "1000",
            "--job-manager", "http", "--manager-url", url,
            "--tenant-id", "serve", "--priority", "10",
            "--set", "obs.trace=true",
            "--set", f"obs.trace_out={serve_trace}",
            "--events-out", serve_events], serve_log)
        children.append(("serve", serve, serve_log))
        for name, proc, log_path in children:
            rc = proc.wait(timeout=1500)
            if rc != 0:
                with open(log_path) as f:
                    print(f"--- {name} log tail ---\n{f.read()[-4000:]}")
                raise RuntimeError(f"{name} tenant exited {rc}")
            print(f"{name} tenant finished cleanly")
        # scrape while the manager is still up: the Prometheus page must
        # agree with the events stream it is derived from
        sched_events = probe.cluster_metrics()["events"]
        metrics_failures = _check_metrics_page(url, sched_events)
        print(f"scraped /metrics: {len(sched_events)} scheduler events, "
              f"{len(metrics_failures)} failure(s)")
        probe.close()
    except Exception as e:
        print(f"SMOKE FAILED: {e}", file=sys.stderr)
        for name, proc, log_path in children:
            if proc.poll() is None:
                proc.kill()
            if os.path.exists(log_path):
                with open(log_path) as f:
                    print(f"--- {name} log tail ---\n{f.read()[-2000:]}",
                          file=sys.stderr)
        return 1
    finally:
        try:
            HttpJobManager(url, client_id="smoke-kill", timeout_s=10,
                           shutdown_on_close=True).close()
        except Exception:
            pass
        if mgr.poll() is None:
            mgr.kill()

    with open(train_events) as f:
        train_kinds = [ev["kind"] for ev in json.load(f)]
    with open(serve_events) as f:
        serve_kinds = [ev["kind"] for ev in json.load(f)]
    print(f"train events: {train_kinds}")
    print(f"serve events: {serve_kinds}")
    failures = list(metrics_failures)
    if "steal" not in serve_kinds:
        failures.append("serve never stole (no urgent grow)")
    if "preempt" not in train_kinds:
        failures.append("train never saw the preemption directive")
    if "yield" not in serve_kinds:
        failures.append("serve never yielded back")
    if "absorb" not in train_kinds:
        failures.append("train never absorbed the yielded workers")
    # the two trace files must hold the causally-linked cross-process
    # steal chain (and pass structural validation)
    import torch_check_trace
    rc = torch_check_trace.main([serve_trace, train_trace, "--expect-chain",
                                 "rpc.steal,cluster.preempt,resize.shrink"])
    if rc != 0:
        failures.append("trace validation failed (see check_trace output)")
    if failures:
        print("SMOKE FAILED: " + "; ".join(failures), file=sys.stderr)
        for log_path in (train_log, serve_log):
            with open(log_path) as f:
                print(f"--- {log_path} ---\n{f.read()[-2500:]}",
                      file=sys.stderr)
        return 1
    print("SMOKE OK: steal -> safe-point shrink -> yield -> absorb, "
          "two processes, one pool; /metrics == events; trace chain "
          "causally linked across processes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
