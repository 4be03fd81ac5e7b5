"""The port's multi-tenant cluster scheduler against the reference's.

* The operation sequences of the reference's ``test_scheduler.py``
  (register, request, steal, yield, poll, fail, deregister, the legacy
  single-run ops, an unknown tenant, spare promotion, metrics) go through
  both packages' ``ClusterScheduler.handle`` — the dispatch both
  transports serve: every reply is equal (the scheduler's wall stamps
  aside), and so is the final state (the port's pool also keeps its log),
  which round-trips through ``from_state``.
* The double-grant guard trips on the same corruptions.
* Two CPU processes contend over one port HTTP manager: the port's train
  CLI (tenant ``train``, priority 0) and this test (tenant ``ext``,
  priority 10).  The steal shrinks the trainer at a safe point, the yield
  is absorbed back, both in the trainer's ``--events-out`` stream; the
  scheduler's ``metrics`` verb counts the same events, and so does the
  manager's ``GET /metrics`` page.
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

from conftest import SRC  # noqa: E402
from repro.cluster import scheduler as j_sched  # noqa: E402
from repro.runtime import fault_tolerance as j_ft  # noqa: E402
from repro_torch.cluster import scheduler as t_sched  # noqa: E402
from repro_torch.runtime import fault_tolerance as t_ft  # noqa: E402


def reg(tenant, workers, max_workers, priority=0, min_workers=1,
        kind="train"):
    return {"op": "register", "tenant": tenant, "priority": priority,
            "kind": kind, "workers": workers, "max_workers": max_workers,
            "min_workers": min_workers}


def op(name, tenant=None, **kw):
    return {"op": name, **({"tenant": tenant} if tenant else {}), **kw}


TWO = [reg("train", 4, 4), reg("serve", 2, 4, priority=10, kind="serve")]
SEQUENCES = {
    "register_disjoint": (6, 0, TWO + [op("metrics")]),
    "register_idempotent": (6, 0, [reg("train", 4, 4), reg("train", 4, 4)]),
    "request_never_preempts": (6, 0, TWO + [op("request", "serve", n=2),
                                            op("poll", "train")]),
    "steal_free_capacity_first": (6, 0, [
        reg("train", 3, 3), reg("serve", 2, 5, priority=10),
        op("steal", "serve", n=1), op("poll", "train")]),
    "steal_preempt_reserve_collect": (6, 0, TWO + [
        op("steal", "serve", n=2), op("poll", "train"),
        op("release", "train", workers=[2, 3]), op("poll", "train"),
        reg("late", 2, 2), op("request", "serve", n=2),
        op("poll", "serve"), op("metrics")]),
    "steal_only_strictly_lower_priority": (4, 0, [
        reg("a", 2, 4, priority=5), reg("b", 2, 4, priority=5),
        op("steal", "a", n=2), op("poll", "b")]),
    "steal_respects_min_workers": (4, 0, [
        reg("train", 2, 2, min_workers=2), reg("serve", 2, 4, priority=10),
        op("steal", "serve", n=2), op("poll", "train")]),
    "victim_lowest_priority_most_headroom": (9, 0, [
        reg("low", 2, 2), reg("mid", 4, 4, priority=1),
        reg("hi", 3, 9, priority=10), op("steal", "hi", n=2),
        op("poll", "low"), op("poll", "mid")]),
    "poll_level_triggered": (6, 0, TWO + [
        op("steal", "serve", n=2), op("poll", "train"), op("poll", "train"),
        op("release", "train", workers=[3]), op("poll", "train")]),
    "yield_becomes_offer": (6, 0, TWO + [
        op("yield", "train", workers=[2, 3]), op("poll", "train"),
        op("request", "train", n=2), op("poll", "train"),
        op("poll", "serve")]),
    "offer_capped_by_ceiling": (8, 0, [
        reg("train", 4, 5), op("release", workers=[4, 5, 6, 7]),
        op("poll", "train")]),
    "death_settles_preemption_debt": (6, 0, TWO + [
        op("steal", "serve", n=2), op("poll", "train"),
        op("fail", "train", worker=3), op("poll", "train")]),
    "death_scrubs_reservations": (6, 0, TWO + [
        op("steal", "serve", n=2), op("release", "train", workers=[2, 3]),
        op("fail", worker=2), op("metrics")]),
    "deregister_frees_the_grant": (6, 0, TWO + [
        op("deregister", "serve"), op("poll", "train"), reg("bigger", 0, 6),
        op("poll", "bigger")]),
    "legacy_ops": (4, 0, [op("release", workers=[2, 3]),
                          op("request", n=5), op("fail", worker=0),
                          op("status")]),
    "unknown_tenant": (6, 0, [op("steal", "ghost", n=1),
                              op("frobnicate")]),
    "evict_revive_spare_promotion": (4, 2, [
        reg("train", 4, 6), op("fail", "train", worker=0),
        op("request", "train", n=1), op("release", "train", workers=[1]),
        op("request", "train", n=1), op("metrics")]),
}


def _drop_wall(reply):
    """Scheduler event records carry the server's wall stamp ``t``."""
    out = dict(reply)
    if "events" in out:
        out["events"] = [{k: v for k, v in e.items() if k != "t"}
                         for e in out["events"]]
    return out


def _run(sched_mod, ft_mod, total, spares, ops):
    sched = sched_mod.ClusterScheduler(ft_mod.WorkerPool(total,
                                                         spares=spares))
    replies = [_drop_wall(sched.handle({**o, "seq": i}))
               for i, o in enumerate(ops)]
    return sched, replies


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_scheduler_op_sequences_match_reference(name):
    total, spares, ops = SEQUENCES[name]
    js, want = _run(j_sched, j_ft, total, spares, ops)
    ts, got = _run(t_sched, t_ft, total, spares, ops)
    assert got == want
    sd = ts.state_dict()
    assert sd["pool"].pop("log") == js.pool.log
    assert sd == js.state_dict()
    back = t_sched.ClusterScheduler.from_state(json.loads(json.dumps(
        ts.state_dict())))
    assert back.state_dict() == ts.state_dict()
    # every event record carries the unified schema fields
    for ev in ts.events:
        assert ev["schema"] == "obs.event/1" and ev["kind"] == ev["ev"]
        assert ev["source"] == "scheduler"


@pytest.mark.parametrize("corrupt,match", [
    ("two_tenants", "held by both"), ("inactive", r"not\s+active"),
    ("reserved_and_granted", "held by both")])
def test_scheduler_guard_trips_like_the_reference(corrupt, match):
    for mod, ft, err in ((j_sched, j_ft, j_sched.SchedulerInvariantError),
                         (t_sched, t_ft, t_sched.SchedulerInvariantError)):
        sched = mod.ClusterScheduler(ft.WorkerPool(6))
        for o in TWO:
            sched.handle(o)
        train, serve = sched.tenants["train"], sched.tenants["serve"]
        if corrupt == "two_tenants":
            serve.granted.append(train.granted[0])
        elif corrupt == "inactive":
            train.granted.append(99)
        else:
            train.reserved.append(train.granted[1])
        with pytest.raises(err, match=match):
            sched._check()
    pool = t_ft.WorkerPool(4)
    pool.released.add(1)
    with pytest.raises(AssertionError, match="active and released"):
        pool.check_consistent()


def test_two_processes_contend_over_one_http_manager(tmp_path):
    from repro_torch.cluster.http_rpc import (HttpJobManager,
                                              spawn_http_manager)

    run_dir = str(tmp_path)
    proc, url = spawn_http_manager(run_dir, 4, spares=0)
    events_path = os.path.join(run_dir, "events.json")
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu", "--layers", "8", "--d-model", "64", "--stages", "4",
         "--steps", "40", "--seq", "32", "--num-micro", "2", "--mb-global",
         "2", "--log-every", "1000", "--job-manager", "http",
         "--manager-url", url, "--tenant-id", "train", "--priority", "0",
         "--rebalance-every", "3", "--events-out", events_path],
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ext = HttpJobManager(url, client_id="ext", shutdown_on_close=False)
    try:
        ext.register_tenant("ext", priority=10, kind="serve", workers=0,
                            max_workers=2, min_workers=1)
        deadline = time.time() + 300
        while time.time() < deadline:       # trainer up and holding 4
            t = ext.cluster_metrics()["tenants"].get("train")
            if t and len(t["granted"]) == 4:
                break
            time.sleep(0.1)
        else:
            pytest.fail("trainer never registered")
        got = list(ext.steal(2))
        while len(got) < 2 and time.time() < deadline:
            got.extend(ext.request(2 - len(got)))
            time.sleep(0.1)
        assert len(got) == 2, got           # preemption crossed processes
        ext.yield_workers(got)              # load dropped: hand them back
        out, _ = child.communicate(timeout=600)
        assert child.returncode == 0, out[-4000:]
        metrics = ext.cluster_metrics()
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            assert r.status == 200
            page = r.read().decode()
    finally:
        ext.close()
        if child.poll() is None:
            child.kill()
        try:
            HttpJobManager(url, client_id="kill", timeout_s=10,
                           shutdown_on_close=True).close()
        except Exception:
            pass
        if proc.poll() is None:
            proc.kill()
    with open(events_path) as f:
        events = json.load(f)
    kinds = [ev["kind"] for ev in events]
    assert "tenant_register" in kinds
    assert "preempt" in kinds, kinds        # the steal arrived
    assert "absorb" in kinds, kinds         # the yield flowed back
    assert all(ev["schema"] == "obs.event/1" for ev in events)
    assert "SHRINK[PREEMPT] 4->2" in out, out[-4000:]
    assert "ABSORB 2->4" in out, out[-4000:]
    # the scheduler's own stream: the trainer yielded 2 and was granted
    # 4 + 2, ext was granted and yielded the same 2
    sched = [(e["tenant"], e["ev"]) for e in metrics["events"]]
    assert sched.count(("train", "grant")) == 6
    assert sched.count(("train", "yield")) == 2 + 4   # + its deregister
    assert sched.count(("ext", "grant")) == 2
    assert sched.count(("ext", "yield")) == 2
    assert sched.count(("train", "preempt_due")) == 1
    for tenant, ev in set(sched):
        assert (f'dynmo_scheduler_events_total{{event="{ev}",'
                f'tenant="{tenant}"}} {sched.count((tenant, ev))}') in page
