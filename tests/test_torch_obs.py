"""The port's observability layer against the reference's, on the CPU.

* The tracer: the scripted span scenario of the reference's
  ``test_obs.py`` exports byte-for-byte ``tests/golden/trace_events.json``
  (thread ids and the wall anchor zeroed), its logical-clock sequence is
  the reference tracer's, spans nest and parent across tracers, and the
  current tracer is process-global; ``scripts/torch_check_trace.py``
  validates the golden file.
* ``stamp_record`` with a local tracer, a foreign context or both gives
  the reference's record (the wall stamp aside).
* The metrics registry's snapshot is ``tests/golden/metrics_snapshot.json``
  and its Prometheus text is the reference registry's; ``serve_metrics``
  serves it; ``scheduler_to_prometheus`` of a scheduler driven through the
  same operations is the reference's text; the port's HTTP manager
  answers ``GET /metrics`` with it.
* ``Session``: a traced CPU train (inline, and async with the drain) has
  the same logical event sequence on a second run, stage times from the
  live step, events with tracing identity, a trace that validates and a
  metrics snapshot; a traced serve with ``obs.metrics_port`` and
  ``obs.in_step_timing`` answers ``GET /metrics`` with its token count.
* The port's own spans (no reference counterpart): a tracer made current
  from ``on_step`` traces exactly the next steps, each loop and step
  phase under its parent, the step's phases with ``device_ms``; a
  recording ``torch.profiler`` does the same with a tracer of its own; a
  run with neither records nothing; the tracer's clock is the wall clock
  in nanoseconds.
"""
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from conftest import REPO, SRC  # noqa: E402
from repro.obs import events as j_events  # noqa: E402
from repro.obs import metrics as j_metrics  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402
from repro_torch.obs import events as t_events  # noqa: E402
from repro_torch.obs import metrics as t_metrics  # noqa: E402
from repro_torch.obs import trace as t_trace  # noqa: E402

torch.set_num_threads(1)
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
TRACE_GOLDEN = os.path.join(GOLDEN_DIR, "trace_events.json")
METRICS_GOLDEN = os.path.join(GOLDEN_DIR, "metrics_snapshot.json")
sys.path.insert(0, os.path.join(REPO, "scripts"))


def _scripted_tracer(mod):
    """The reference test's fixed span scenario under an injected
    1 ms-per-call clock and pid 0, on ``mod``'s Tracer."""
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]

    tr = mod.Tracer("golden-run", clock=clock, pid=0, meta={"mode": "test"})
    with tr.span("train", steps=2):
        with tr.span("train.step", cat="step", step=0):
            pass
        ctx = tr.instant("checkpoint.saved", cat="checkpoint", step=0)
        sp = tr.span("resize.shrink", cat="resize",
                     parent_id=ctx["span_id"], target_stages=2)
        sp.end(stages=2)
    return tr


def _normalized_chrome(tr) -> dict:
    doc = tr.to_chrome()
    for ev in doc["traceEvents"]:
        ev["tid"] = 0
    doc["otherData"].pop("wall0", None)
    return doc


def test_trace_export_is_the_golden_file():
    with open(TRACE_GOLDEN) as f:
        golden = json.load(f)
    got = _normalized_chrome(_scripted_tracer(t_trace))
    assert got == golden
    assert got == _normalized_chrome(_scripted_tracer(j_trace))
    # byte for byte as the reference test writes the file
    assert (json.dumps(got, indent=1)
            == json.dumps(_normalized_chrome(_scripted_tracer(j_trace)),
                          indent=1))


def test_torch_check_trace_validates_the_golden_file(tmp_path):
    import torch_check_trace
    assert torch_check_trace.main([TRACE_GOLDEN, "--expect-chain",
                                   "checkpoint.saved,resize.shrink"]) == 0
    # a broken parent link fails
    with open(TRACE_GOLDEN) as f:
        doc = json.load(f)
    doc["traceEvents"][-1]["args"]["parent_id"] = "golden-run.s99"
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    assert torch_check_trace.main([str(bad)]) == 1


def test_event_sequence_is_deterministic_and_the_references():
    a = _scripted_tracer(t_trace).event_sequence()
    assert a == _scripted_tracer(t_trace).event_sequence()
    assert a == _scripted_tracer(j_trace).event_sequence()
    assert [lc for _, _, lc, _, _ in a] == sorted(
        lc for _, _, lc, _, _ in a), "logical clocks not monotone"


def test_span_nesting_and_cross_process_parenting():
    tr = t_trace.Tracer("t1", pid=0)
    with tr.span("outer") as outer:
        with tr.span("inner") as inner:
            assert inner.parent_id == outer.span_id
        ctx = tr.instant("leaf")
    tr2 = t_trace.Tracer("t2", pid=1)
    sp = tr2.span("remote", parent_id=ctx["span_id"])
    sp.end()
    ev = tr2.to_chrome()["traceEvents"][0]
    assert ev["args"]["parent_id"] == ctx["span_id"]
    assert ev["args"]["span_id"].startswith("t2.")
    assert len(tr) == 3 and len(tr2) == 1


def _stamps(ev_mod, tr_mod):
    tr = tr_mod.Tracer("run-a", pid=0)
    local = ev_mod.stamp_record({"x": 1}, source="session", kind="log",
                                tracer=tr)
    ctx = tr.instant("rpc.steal")
    far = ev_mod.stamp_record({}, source="scheduler", kind="steal", ctx=ctx,
                              wall=False)
    both = ev_mod.stamp_record({}, source="session", kind="preempt",
                               tracer=tr_mod.Tracer("run-b", pid=0), ctx=ctx)
    tr_mod.set_current_tracer(tr_mod.Tracer("global", pid=0))
    try:
        cur = ev_mod.stamp_record({}, source="fault", kind="rpc_loss")
    finally:
        tr_mod.set_current_tracer(None)
    out = [local, far, both, cur]
    for rec in out:
        assert rec.pop("wall", 0.0) is not None
    return out


def test_stamp_record_local_foreign_and_both_match_reference():
    got = _stamps(t_events, t_trace)
    assert got == _stamps(j_events, j_trace)
    local, far, both, cur = got
    assert local["trace_id"] == "run-a" and isinstance(local["lc"], int)
    assert far["trace_id"] == "run-a" and far["parent_id"] == "run-a.s2"
    assert both["trace_id"] == "run-b" and both["parent_id"] == "run-a.s2"
    assert both["cause_trace_id"] == "run-a"
    assert cur["trace_id"] == "global"
    assert t_trace.current_tracer() is None


def _scripted_registry(mod):
    reg = mod.MetricsRegistry()
    reg.inc("dynmo_train_steps_total", 3, help="train steps", mode="train")
    reg.inc("dynmo_resizes_total", kind="shrink", policy="preempt")
    reg.set("dynmo_stages", 4, help="live stage count")
    reg.set("dynmo_stage_time_seconds", 0.25, stage="0", source="in_step")
    for v in (0.004, 0.04, 0.4, 4.0):
        reg.observe("dynmo_step_seconds", v, help="steady step seconds")
    return reg


def test_metrics_snapshot_golden_and_prometheus_text():
    with open(METRICS_GOLDEN) as f:
        golden = json.load(f)
    reg = _scripted_registry(t_metrics)
    assert reg.snapshot() == golden
    text = reg.to_prometheus()
    assert text == _scripted_registry(j_metrics).to_prometheus()
    assert 'dynmo_step_seconds_bucket{le="0.005"} 1' in text
    assert text.endswith("\n")


def test_serve_metrics_endpoint():
    reg = _scripted_registry(t_metrics)
    srv = t_metrics.serve_metrics(reg, 0)          # ephemeral port
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            assert r.status == 200
            assert (r.headers["Content-Type"]
                    == "text/plain; version=0.0.4; charset=utf-8")
            assert r.read().decode() == reg.to_prometheus()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=30)
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()


OPS = [{"op": "register", "tenant": "train", "priority": 0, "kind": "train",
        "workers": 3, "max_workers": 4, "min_workers": 1},
       {"op": "register", "tenant": "serve", "priority": 10, "kind": "serve",
        "workers": 1, "max_workers": 4, "min_workers": 1},
       {"op": "steal", "tenant": "serve", "n": 2},
       {"op": "poll", "tenant": "train"},
       {"op": "release", "tenant": "train", "workers": [1, 2]},
       {"op": "yield", "tenant": "serve", "workers": [3]}]


def _sched_text(sched_mod, ft_mod, metrics_mod):
    sched = sched_mod.ClusterScheduler(ft_mod.WorkerPool(5, spares=1))
    for op in OPS:
        sched.handle(dict(op))
    return metrics_mod.scheduler_to_prometheus(sched), sched.events


def test_scheduler_to_prometheus_matches_reference_and_events():
    from repro.cluster import scheduler as j_sched
    from repro.runtime import fault_tolerance as j_ft
    from repro_torch.cluster import scheduler as t_sched
    from repro_torch.runtime import fault_tolerance as t_ft
    text, events = _sched_text(t_sched, t_ft, t_metrics)
    want, _ = _sched_text(j_sched, j_ft, j_metrics)
    assert text == want
    counts = {}
    for ev in events:
        k = (ev["ev"], ev["tenant"])
        counts[k] = counts.get(k, 0) + 1
    for (ev, tenant), n in counts.items():
        assert (f'dynmo_scheduler_events_total{{event="{ev}",'
                f'tenant="{tenant}"}} {n}') in text
    assert "dynmo_pool_active 6" in text


def test_http_manager_serves_get_metrics(tmp_path):
    from repro_torch.cluster.http_rpc import (HttpJobManager,
                                              spawn_http_manager)
    proc, url = spawn_http_manager(str(tmp_path), 4,
                                   startup_timeout_s=60.0)
    try:
        jm = HttpJobManager(url, client_id="probe", timeout_s=30,
                            shutdown_on_close=True)
        jm.register_tenant("train", priority=0, kind="train", workers=3,
                           max_workers=4, min_workers=1)
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            assert r.status == 200
            assert "version=0.0.4" in r.headers["Content-Type"]
            page = r.read().decode()
        events = jm.cluster_metrics()["events"]
        assert [e["ev"] for e in events] == ["register"] + ["grant"] * 3
        assert ('dynmo_scheduler_events_total{event="grant",'
                'tenant="train"} 3') in page
        assert ('dynmo_scheduler_events_total{event="register",'
                'tenant="train"} 1') in page
        assert 'dynmo_workers_granted{tenant="train"} 3' in page
        jm.close()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


TRAIN_SPEC = {
    "model": {"arch": "smollm-360m", "layers": 8, "d_model": 64,
              "num_heads": 4, "num_kv_heads": 2, "vocab_size": 256},
    "parallel": {"stages": 4, "num_micro": 4, "mb_global": 4, "seq": 16},
    "controller": {"rebalance_every": 3},
    "steps": 7, "log_every": 3}


def _traced_train(tmp_path, tag, **controller):
    from repro_torch.api import RunSpec, Session
    d = json.loads(json.dumps(TRAIN_SPEC))
    d["controller"].update(controller)
    d["obs"] = {"trace": True, "in_step_timing": True,
                "trace_out": str(tmp_path / f"trace_{tag}.json"),
                "metrics_out": str(tmp_path / f"metrics_{tag}.json")}
    with Session(RunSpec.from_dict(d), device="cpu") as s:
        rep = s.train()
        seq = s.tracer.event_sequence()
        assert t_trace.current_tracer() is s.tracer
    assert t_trace.current_tracer() is None
    return rep, seq, s.events


@pytest.mark.parametrize("controller", [
    {}, {"async_decide": True, "async_drain": True}],
    ids=["inline", "async_drain"])
def test_session_trace_is_deterministic_and_validates(tmp_path, controller):
    import torch_check_trace
    rep, seq_a, events = _traced_train(tmp_path, "a", **controller)
    assert rep["stage_time_source"] == "in_step"
    mt = rep["measured_stage_times"]
    assert mt is not None and len(mt) == 4 and all(t > 0 for t in mt)
    for ev in events:
        assert ev.schema == "obs.event/1" and ev.source == "session"
        assert ev.trace_id == "train-solo-s0" and ev.span_id
        assert ev.lc is not None
    snap = json.loads((tmp_path / "metrics_a.json").read_text())
    assert snap["schema"] == "obs.metrics/1"
    assert "dynmo_train_steps_total" in {c["name"]
                                        for c in snap["counters"]}
    assert torch_check_trace.main(
        [str(tmp_path / "trace_a.json"), "--expect-event", "train",
         "--expect-event", "train.step", "--expect-event",
         "controller.decide", "--expect-event",
         "controlplane.decide"]) == 0
    _, seq_b, _ = _traced_train(tmp_path, "b", **controller)
    assert seq_a == seq_b, "fixed-seed logical-clock sequence diverged"


def test_session_serve_metrics_port_and_in_step_timing(tmp_path):
    import socket

    from repro_torch.api import RunSpec, Session
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    spec = RunSpec.from_dict({
        "model": {"arch": "smollm-360m", "layers": 4, "d_model": 64,
                  "num_heads": 4, "num_kv_heads": 2, "vocab_size": 256},
        "parallel": {"stages": 2, "num_micro": 2, "mb_global": 2},
        "serve": {"requests": 6, "prompt_len": 8, "gen": 8,
                  "kv_page_size": 4},
        "obs": {"trace": True, "in_step_timing": True,
                "metrics_port": port,
                "trace_out": str(tmp_path / "serve.json")}})
    with Session(spec, device="cpu") as s:
        rep = s.serve()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r:
            page = r.read().decode()
    assert rep["stage_time_source"] == "in_step"
    assert len(rep["measured_stage_times"]) == 2
    assert f"dynmo_serve_tokens_total {rep['total_tokens']}" in page
    assert rep["total_tokens"] == sum(rep["tick_tokens"])
    assert f"dynmo_serve_ticks_total {rep['ticks']}" in page
    assert "dynmo_kv_page_occupancy" in page
    with pytest.raises(urllib.error.URLError):   # closed with the session
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                               timeout=5)
    import torch_check_trace
    assert torch_check_trace.main([str(tmp_path / "serve.json"),
                                   "--expect-chain",
                                   "serve,serve.tick,serve.admit"]) == 0


def test_torch_cluster_smoke_script_passes(tmp_path):
    """``scripts/torch_cluster_smoke.py`` at a reduced size (60 train
    steps, 80 requests): the steal, the safe-point shrink, the yield and
    the absorb cross one HTTP manager; ``GET /metrics`` equals the events
    stream; the two traces hold the causal chain
    ``rpc.steal -> cluster.preempt -> resize.shrink``."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_cluster_smoke.py"),
         "--device", "cpu", "--steps", "60", "--requests", "80"],
        capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1",
             "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "SMOKE OK" in proc.stdout
    assert "chain OK: rpc.steal -> cluster.preempt -> resize.shrink" \
        in proc.stdout


def test_tracer_clock_is_the_wall_clock_in_ns():
    tr = t_trace.Tracer("clock", pid=0)
    with tr.span("x"):
        inside = time.time_ns()
    doc = tr.to_chrome()
    ev = doc["traceEvents"][0]
    start = doc["otherData"]["wall0"] * 1e9 + ev["ts"] * 1e3
    assert abs(start - inside) < 1e6
    exact = tr.wall0_ns + ev["ts"] * 1e3
    assert exact <= inside <= exact + ev["dur"] * 1e3 + 1e3


SPAN_SPEC = {
    "model": {"arch": "smollm-360m", "layers": 8, "d_model": 32,
              "num_heads": 2, "num_kv_heads": 1, "d_ff": 64,
              "vocab_size": 64},
    "parallel": {"stages": 2, "num_micro": 2, "mb_global": 1, "seq": 8},
    # the one decision, at step 10, moves a layer off the straggler
    "controller": {"rebalance_every": 11, "straggler": {1: 3.0}},
    "dynamics": {"kind": "pruning"},
    "steps": 12, "log_every": 1}
# each span the traced steps 10 and 11 run, with its parent's name
SPAN_PARENTS = {
    "train": None, "train.data": "train", "train.step": "train",
    "step.batch": "train.step", "step.forward": "train.step",
    "step.backward": "train.step", "step.optimizer": "train.step",
    "train.sync": "train.step", "train.prune": "train",
    "controller.decide": "train", "controller.stats": "controller.decide",
    "controlplane.decide": "controller.decide",
    "controlplane.apply": "train", "train.hook": "train",
    "train.log": "train"}


def _spans_by_parent(tr):
    evs = tr.to_chrome()["traceEvents"]
    names = {e["args"]["span_id"]: e["name"] for e in evs}
    return [(e["name"], names.get(e["args"]["parent_id"]), e["args"])
            for e in evs]


def _span_train(on_step):
    from repro_torch.api import RunSpec, Session
    with Session(RunSpec.from_dict(SPAN_SPEC), device="cpu") as s:
        rep = s.train(on_step=on_step)
        spans = s._engine.world(2).spans
    return rep, spans


def test_tracer_switched_from_on_step_traces_those_steps(tmp_path):
    import torch_check_trace
    tr = t_trace.Tracer("switched", pid=0)

    def on_step(step, session):
        if step == 9:
            t_trace.set_current_tracer(tr)
        if step == 11:
            t_trace.set_current_tracer(None)

    rep, _ = _span_train(on_step)
    assert t_trace.current_tracer() is None
    got = _spans_by_parent(tr)
    assert {(n, p) for n, p, _ in got} == set(SPAN_PARENTS.items())
    assert [e.iteration for e in rep["events"]] == [11]
    assert sorted(a["step"] for n, _, a in got if n == "train.step") \
        == [10, 11]
    for name, _, args in got:
        if name == "controlplane.decide":
            assert args["iteration"] == 11
        elif name != "train":
            assert args["step"] in (10, 11), (name, args)
        if name.startswith("step."):
            assert args["device_ms"] >= 0
    path = tr.export(str(tmp_path / "switched.json"))
    assert torch_check_trace.main(
        [path, "--expect-chain", "train,train.step,step.forward",
         "--expect-chain", "controller.decide,controller.stats"]) == 0
    # the tracer records nothing once it is no longer current
    n = len(tr)
    _span_train(None)
    assert len(tr) == n


def test_untraced_run_records_nothing_and_profiler_traces_its_steps():
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import timing
    before = timing.profile_tracer()

    def quiet(step, session):
        assert t_trace.current_tracer() is None

    _, spans = _span_train(quiet)
    assert timing.profile_tracer() is before
    assert (spans._tracer, spans._open, spans._pending) == (None, None, [])
    prof = {}

    def profiled(step, session):
        if step == 9:
            prof["p"] = profile(activities=[ProfilerActivity.CPU])
            prof["p"].start()
        if step == 11:
            prof["p"].stop()

    _span_train(profiled)
    tr = timing.profile_tracer()
    assert tr is not None and tr is not before
    assert t_trace.current_tracer() is None
    got = _spans_by_parent(tr)
    assert {(n, p) for n, p, _ in got} == set(SPAN_PARENTS.items())
    assert {a.get("step", a.get("iteration")) for _, _, a in got
            if "steps" not in a} == {10, 11}
