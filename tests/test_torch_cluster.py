"""The port's cluster layer against the reference's: heartbeats, the
autoscaler, the worker pool, the circuit breaker, the file job manager and
the engine's degraded mode.

* The reference's eight autoscaler scenarios (``test_cluster.py``) and its
  two serving-signal cases (``test_serve.py``) run against both packages'
  ``Autoscaler`` and ``HeartbeatMonitor``: every observation's decision and
  the final ``state_dict`` are equal, and the reference's own assertions
  hold on the port.
* ``HeartbeatMonitor``'s unknown-worker guard, expire and revive; a
  ``WorkerPool`` with spares (fresh ids, grants by id, exclusions) through
  ``state_dict`` / ``from_state``, equal to the reference's pool;
  ``CircuitBreaker``'s trip, fast fails and probe.
* ``FileJobManager`` across a process boundary, its timeout without a
  server, and a server over a previous run's leftovers.
* The engine's deferred release / fail replaying in order behind a stub
  manager that raises ``JobManagerUnavailable``: the same
  ``degraded_events``, manager calls and resizes as the reference's engine
  behind the same stub.
"""
import dataclasses
import json
import types

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from conftest import run_in_subprocess  # noqa: E402

from repro.cluster import autoscaler as j_auto  # noqa: E402
from repro.cluster import rpc as j_rpc  # noqa: E402
from repro.runtime import fault_tolerance as j_ft  # noqa: E402
from repro_torch.cluster import autoscaler as t_auto  # noqa: E402
from repro_torch.cluster import rpc as t_rpc  # noqa: E402
from repro_torch.runtime import fault_tolerance as t_ft  # noqa: E402

torch.set_num_threads(1)
REF = types.SimpleNamespace(HB=j_ft.HeartbeatMonitor, A=j_auto.Autoscaler,
                            C=j_auto.AutoscalerConfig)
PORT = types.SimpleNamespace(HB=t_ft.HeartbeatMonitor, A=t_auto.Autoscaler,
                             C=t_auto.AutoscalerConfig)


class Recorder:
    """Wraps an ``Autoscaler``: every decision is recorded as a dict."""

    def __init__(self, sc):
        self.sc, self.log = sc, []

    def observe(self, *a, **kw):
        d = self.sc.observe(*a, **kw)
        self.log.append(dataclasses.asdict(d))
        return d

    def observe_load(self, *a, **kw):
        d = self.sc.observe_load(*a, **kw)
        self.log.append(dataclasses.asdict(d))
        return d

    def note_resize(self, step, stages):
        self.log.append({"note_resize": [step, stages]})
        self.sc.note_resize(step, stages)


def evict_on_heartbeat_failure(ns):
    t = [0.0]
    mon = ns.HB(4, timeout_s=5.0, clock=lambda: t[0])
    sc = Recorder(ns.A(ns.C(min_stages=1, max_stages=4, watermark=False),
                       mon))
    for step in range(10):
        t[0] = float(step)
        for w in (0, 1, 2):                 # worker 3 goes silent
            mon.beat(w)
        d = sc.observe(step, 1.0, stages=4, active_workers=[0, 1, 2, 3],
                       tokens=1000)
        if d.action != "none":
            assert d.action == "evict" and d.ids == [3] and step > 5
            break
    else:
        pytest.fail("failure never detected")
    d = sc.observe(step + 1, 1.0, stages=3, active_workers=[0, 1, 2],
                   tokens=1000)
    assert d.action == "none"
    return sc


def grow_on_recovery_is_remembered(ns):
    t = [0.0]
    mon = ns.HB(4, timeout_s=5.0, clock=lambda: t[0])
    sc = Recorder(ns.A(ns.C(min_stages=1, max_stages=4, watermark=False),
                       mon))
    cool = sc.sc.cfg.cooldown
    mon.expire(3)
    assert sc.observe(0, 1.0, stages=3, active_workers=[0, 1, 2],
                      tokens=1000).action == "none"
    mon.revive(3)
    assert sc.observe(1, 1.0, stages=4, active_workers=[0, 1, 2, 9],
                      tokens=1000).action == "none"
    d = sc.observe(2, 1.0, stages=3, active_workers=[0, 1, 2], tokens=1000)
    assert d.action == "grow" and d.ids == [3]
    assert sc.observe(3, 1.0, stages=3, active_workers=[0, 1, 2],
                      tokens=1000).action == "none"
    d = sc.observe(2 + cool, 1.0, stages=3, active_workers=[0, 1, 2],
                   tokens=1000)
    assert d.action == "grow" and d.ids == [3]
    assert sc.observe(3 + 2 * cool, 1.0, stages=4,
                      active_workers=[0, 1, 2, 3],
                      tokens=1000).action == "none"
    assert sc.observe(4 + 3 * cool, 1.0, stages=3,
                      active_workers=[0, 1, 2], tokens=1000).action == "none"
    return sc


def recovery_survives_retimeout_before_grant(ns):
    t = [0.0]
    mon = ns.HB(4, timeout_s=3.0, clock=lambda: t[0])
    sc = Recorder(ns.A(ns.C(min_stages=1, max_stages=4, cooldown=4,
                            watermark=False), mon))

    def beat_active():
        for w in (0, 1, 2):
            mon.beat(w)

    mon.expire(3)
    beat_active()
    sc.observe(0, 1.0, stages=3, active_workers=[0, 1, 2], tokens=1000)
    mon.revive(3)
    t[0] = 1.0
    beat_active()
    d = sc.observe(1, 1.0, stages=3, active_workers=[0, 1, 2], tokens=1000)
    assert d.action == "grow" and d.ids == [3]
    t[0] = 6.0
    beat_active()
    assert mon.failed_workers() == {3}
    d = sc.observe(6, 1.0, stages=3, active_workers=[0, 1, 2], tokens=1000)
    assert d.action == "grow" and d.ids == [3]
    return sc


def capped_eviction_retries_remaining_dead_workers(ns):
    t = [0.0]
    mon = ns.HB(4, timeout_s=2.0, clock=lambda: t[0])
    sc = Recorder(ns.A(ns.C(min_stages=3, max_stages=4, watermark=False),
                       mon))
    t[0] = 5.0
    mon.beat(0)
    mon.beat(3)
    d = sc.observe(5, 1.0, stages=4, active_workers=[0, 1, 2, 3],
                   tokens=1000)
    assert d.action == "evict" and d.ids == [1]
    assert sc.observe(6, 1.0, stages=3, active_workers=[0, 2, 3],
                      tokens=1000).action == "none"
    d = sc.observe(7, 1.0, stages=4, active_workers=[0, 2, 3, 9],
                   tokens=1000)
    assert d.action == "evict" and d.ids == [2]
    return sc


def blocked_evict_does_not_starve_recovery_grow(ns):
    t = [0.0]
    mon = ns.HB(4, timeout_s=2.0, clock=lambda: t[0])
    sc = Recorder(ns.A(ns.C(min_stages=2, max_stages=4, watermark=False),
                       mon))
    mon.expire(2)
    mon.expire(3)
    sc.observe(0, 1.0, stages=2, active_workers=[0, 1], tokens=1000)
    t[0] = 5.0
    mon.beat(0)
    assert mon.failed_workers() == {1, 2, 3}
    mon.revive(3)
    d = sc.observe(5, 1.0, stages=2, active_workers=[0, 1], tokens=1000)
    assert d.action == "grow" and d.ids == [3]
    mon.beat(0)
    mon.beat(3)
    d = sc.observe(6, 1.0, stages=3, active_workers=[0, 1, 3], tokens=1000)
    assert d.action == "evict" and d.ids == [1]
    return sc


def watermark_does_not_oscillate(ns):
    cfg = ns.C(min_stages=2, max_stages=4, window=2, low_watermark=0.6,
               high_watermark=0.9, patience=2, cooldown=2, watermark=True)
    sc = Recorder(ns.A(cfg, monitor=None))
    step = 0
    for _ in range(4):
        sc.observe(step, 1.0, 4, [0, 1, 2, 3], 1000)
        step += 1
    actions, last, stages = [], None, 4
    for _ in range(60):
        d = sc.observe(step, 3.0, stages, list(range(stages)), 1000)
        if d.action == "shrink":
            stages -= d.workers
            sc.note_resize(step, stages)
        elif d.action == "grow":
            stages += d.workers
            sc.note_resize(step, stages)
        if d.action != "none":
            actions.append(d.action)
            last = step
        step += 1
    span = cfg.max_stages - cfg.min_stages
    assert 0 < actions.count("shrink") <= span, actions
    assert actions.count("grow") <= span and last < step - 20
    assert stages == 4
    return sc


def watermark_shrink_with_hysteresis(ns):
    cfg = ns.C(min_stages=2, max_stages=4, window=2, low_watermark=0.6,
               patience=2, cooldown=5, watermark=True)
    sc = Recorder(ns.A(cfg, monitor=None))
    step = 0
    for _ in range(4):
        assert sc.observe(step, 1.0, stages=4, active_workers=[0, 1, 2, 3],
                          tokens=1000).action == "none"
        step += 1
    shrinks = []
    for _ in range(12):
        d = sc.observe(step, 3.0, stages=4, active_workers=[0, 1, 2, 3],
                       tokens=1000)
        if d.action == "shrink":
            shrinks.append(step)
            sc.note_resize(step, 3)
        step += 1
    assert shrinks and shrinks[0] >= 4 + cfg.patience - 1
    assert all(b - a >= cfg.cooldown for a, b in zip(shrinks, shrinks[1:]))
    return sc


def watermark_grow_on_throughput_drop(ns):
    cfg = ns.C(min_stages=2, max_stages=4, window=2, high_watermark=0.9,
               patience=2, cooldown=3, watermark=True)
    sc = Recorder(ns.A(cfg, monitor=None))
    step = 0
    for _ in range(4):
        assert sc.observe(step, 1.0, 2, [0, 1], 1000).action == "none"
        step += 1
    for _ in range(6):
        if sc.observe(step, 3.0, 2, [0, 1], 1000).action == "grow":
            return sc
        step += 1
    pytest.fail("throughput drop never grew")


def load_signals_hysteresis(ns):
    mk = lambda **kw: Recorder(ns.A(ns.C(  # noqa: E731
        min_stages=2, max_stages=4, queue_high=4, occupancy_low=0.3, **kw)))
    sc = mk(patience=3, cooldown=5)
    for t in range(3):
        assert sc.observe_load(t, 4, queue_depth=9,
                               occupancy=1.0).action == "none"
    sc2 = mk(patience=3, cooldown=5)
    acts = [sc2.observe_load(t, 3, queue_depth=9, occupancy=1.0).action
            for t in range(3)]
    assert acts == ["none", "none", "grow"]
    sc2.note_resize(2, 4)
    for t in range(3, 7):
        assert sc2.observe_load(t, 4, queue_depth=0,
                                occupancy=0.0).action == "none"
    acts = [sc2.observe_load(t, 4, queue_depth=0, occupancy=0.0).action
            for t in range(7, 10)]
    assert acts == ["none", "none", "shrink"]
    sc3 = mk(patience=1, cooldown=0)
    assert sc3.observe_load(0, 2, queue_depth=0,
                            occupancy=0.0).action == "none"
    # one recorder carries all three runs' decisions and the last state
    sc2.log += sc.log + sc3.log
    return sc2


def latency_slo_signal(ns):
    sc = Recorder(ns.A(ns.C(min_stages=1, max_stages=4, patience=2,
                            cooldown=0, queue_high=10 ** 9,
                            latency_slo_s=0.1)))
    acts = [sc.observe_load(t, 2, queue_depth=0, occupancy=1.0,
                            latency_s=0.5).action for t in range(2)]
    assert acts == ["none", "grow"]
    assert "latency" in sc.sc.decisions[-1].reason
    # and a page-pool pressure signal, urgent at twice the queue watermark
    d = [sc.observe_load(t, 2, queue_depth=0, occupancy=0.2,
                         page_occupancy=0.95) for t in range(2, 6)]
    assert [x.action for x in d] == ["none", "grow", "none", "grow"]
    return sc


SCENARIOS = [evict_on_heartbeat_failure, grow_on_recovery_is_remembered,
             recovery_survives_retimeout_before_grant,
             capped_eviction_retries_remaining_dead_workers,
             blocked_evict_does_not_starve_recovery_grow,
             watermark_does_not_oscillate, watermark_shrink_with_hysteresis,
             watermark_grow_on_throughput_drop, load_signals_hysteresis,
             latency_slo_signal]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__ for f in SCENARIOS])
def test_autoscaler_scenarios_match_reference(scenario):
    want, got = scenario(REF), scenario(PORT)
    assert got.log == want.log
    assert got.sc.state_dict() == want.sc.state_dict()
    # the hysteresis state round-trips through a safe point's JSON
    again = PORT.A(got.sc.cfg)
    again.load_state(json.loads(json.dumps(got.sc.state_dict())))
    assert again.state_dict() == got.sc.state_dict()


def test_heartbeat_monitor_matches_reference():
    logs = []
    for ns in (REF, PORT):
        t = [0.0]
        mon = ns.HB(3, timeout_s=2.0, clock=lambda: t[0])
        with pytest.raises(KeyError, match="unregistered"):
            mon.beat(7)
        log = []
        for step in range(8):
            t[0] = float(step)
            for w in (0, 1) if step < 5 else (0,):
                mon.beat(w)
            if step == 3:
                mon.expire(0)
            if step == 6:
                mon.revive(0)
                mon.revive(5)               # revive registers a new id
            log.append((sorted(mon.failed_workers()),
                        sorted(mon.known_workers())))
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][-1] == ([1, 2], [0, 1, 2, 5])


def _pool_ops(mod):
    pool = mod.WorkerPool(4, spares=2)
    seen = []
    pool.subscribe(lambda ev, w: seen.append((ev, w)))
    pool.release([2, 3])
    out = [pool.request(1, exclude=[2]), pool.grant([2])]
    pool.fail(0)
    out.append(pool.request(4))             # 1 released + 2 fresh spares
    with pytest.raises(ValueError):
        pool.grant([0])                     # dead
    pool.check_consistent()
    return pool, out, seen


def test_worker_pool_with_spares_matches_reference():
    jp, jout, jseen = _pool_ops(j_ft)
    tp, tout, tseen = _pool_ops(t_ft)
    assert tout == jout == [[3], [2], [4, 5]]
    assert tseen == jseen
    sd = tp.state_dict()
    assert sd.pop("log") == jp.log          # the port's pool keeps its log
    assert sd == jp.state_dict()
    assert sd["provisioned"] == [4, 5] and sd["next_id"] == 6
    back = t_ft.WorkerPool.from_state(json.loads(json.dumps(
        tp.state_dict())))
    assert back.state_dict() == tp.state_dict()
    assert back.request(1) == []            # spares spent, nothing released
    # a reference pool's state (no log) restores too
    assert t_ft.WorkerPool.from_state(jp.state_dict()).spares == 2


def test_circuit_breaker_matches_reference():
    logs = []
    for mod in (j_rpc, t_rpc):
        br = mod.CircuitBreaker(trip_after=2, probe_every=3)
        log = []
        for ok in (False, False, None, None, None, None, True, None):
            if ok is None:
                log.append(br.allow())
            elif ok:
                br.success()
            else:
                br.failure()
            log.append((br.open, br.state_dict()))
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][-1] == (False, {"failures": 0, "trips": 1,
                                   "fast_fails": 3})


def test_in_process_job_manager_wraps_pool():
    pool = t_ft.WorkerPool(4)
    jm = t_rpc.InProcessJobManager(pool)
    assert jm.release([2, 3]) == [2, 3] and jm.num_active == 2
    assert jm.release([3]) == []
    assert jm.request(5) == [2, 3] and jm.num_active == 4
    jm.fail(0)
    assert jm.num_active == 3 and jm.log == pool.log
    jm.close()


def test_file_job_manager_crosses_process_boundary(tmp_path):
    root = str(tmp_path)
    proc = t_rpc.spawn_file_manager(root, workers=4, idle_timeout_s=60.0)
    try:
        jm = t_rpc.FileJobManager(root, timeout_s=30.0)
        assert jm.num_active == 4
        assert jm.release([2, 3]) == [2, 3]
        assert jm.num_active == 2
        assert jm.release([3]) == []
        assert jm.request(1) == [2]
        jm.fail(1)
        assert jm.num_active == 2
        assert jm.request(5) == [3]
        assert jm.log == ["release:2", "release:3", "grant:2", "fail:1",
                          "grant:3"]
        with open(f"{root}/state.json") as f:
            journal = json.load(f)
        assert journal["pool"]["released"] == [] and \
            journal["pool"]["dead"] == [1]
        jm.close()
        assert proc.wait(timeout=20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_file_job_manager_timeout_without_server(tmp_path):
    jm = t_rpc.FileJobManager(str(tmp_path), timeout_s=0.2, poll_s=0.02)
    with pytest.raises(TimeoutError):
        jm.request(1)
    with pytest.raises(t_rpc.JobManagerUnavailable):
        jm.request(1)                       # the breaker trips after two
    assert jm.rpc_stats["calls"] == 2 and jm.breaker.trips == 1
    assert jm.num_active == -1              # never answered: telemetry -1


def test_file_job_manager_ignores_previous_runs_leftovers(tmp_path):
    root = str(tmp_path)
    for seq, op in ((1, {"op": "release", "workers": [2, 3]}),
                    (2, {"op": "shutdown"})):
        with open(f"{root}/req-{seq:06d}.json", "w") as f:
            json.dump(op, f)
        with open(f"{root}/resp-{seq:06d}.json", "w") as f:
            json.dump({"op": op["op"], "active": 2, "released": [2, 3]}, f)
    proc = t_rpc.spawn_file_manager(root, workers=4, idle_timeout_s=60.0)
    try:
        jm = t_rpc.FileJobManager(root, timeout_s=30.0)
        assert jm._seq == 2
        assert jm.num_active == 4
        jm.close()
        assert proc.wait(timeout=20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


# ---------------------------------------------------------------------------
# the engine's degraded mode
# ---------------------------------------------------------------------------
HELPERS = """
class FlakyManager:
    # a job-manager stub over a pool: while ``down`` every call raises the
    # given package's ``JobManagerUnavailable``; every answered call is
    # logged

    def __init__(self, ft, rpc, stages):
        self.pool = ft.WorkerPool(stages)
        self.err = rpc.JobManagerUnavailable
        self.down = False
        self.calls = []

    def _gate(self, what):
        if self.down:
            raise self.err(what)
        self.calls.append(what)

    def release(self, workers):
        self._gate(f"release:{list(workers)}")
        before = set(self.pool.released)
        self.pool.release(list(workers))
        return sorted(set(self.pool.released) - before)

    def request(self, n):
        self._gate(f"request:{n}")
        return self.pool.request(n)

    def fail(self, worker):
        self._gate(f"fail:{worker}")
        self.pool.fail(worker)

    @property
    def num_active(self):
        return self.pool.num_active

    @property
    def log(self):
        return self.pool.log

    def close(self):
        pass


def _degraded_sequence(eng, st, jm):
    # shrink 4 -> 3 and evict worker 1 while the manager is down, a grow
    # denied, then the manager back: a grow replays the queue in order
    # first and is granted the released worker
    jm.down = True
    st = eng.shrink(st, 3, step=1)
    st = eng.evict(st, [1], step=2)
    st = eng.grow(st, 1, step=3)            # denied: unreachable
    jm.down = False
    st = eng.grow(st, 1, step=4)
    return {"degraded": list(eng.degraded_events), "calls": list(jm.calls),
            "workers": list(eng.stage_workers), "log": list(jm.log),
            "resizes": [(r.kind, r.step, r.from_stages, r.to_stages,
                         list(r.workers)) for r in eng.resizes]}
"""
exec(HELPERS)


REF_DEGRADED = """
import json
import jax
from repro.cluster import rpc
from repro.configs import DistConfig, get_config, reduced_config
from repro.dynamics.config import DynamicsConfig
from repro.launch.engine import ElasticEngine
from repro.pipeline.pipeline import PipelineShapes
from repro.runtime import fault_tolerance as ft
""" + HELPERS + """
jm = FlakyManager(ft, rpc, 4)
eng = ElasticEngine(reduced_config(get_config("smollm-360m"), **SMALL),
                    DistConfig(num_stages=4, slot_slack=2), DynamicsConfig(),
                    PipelineShapes(2, 2, 8), job_manager=jm)
out = _degraded_sequence(eng, eng.init_state(jax.random.PRNGKey(0)), jm)
print("REPORT " + json.dumps(out))
"""
SMALL = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=256)


def test_engine_deferred_calls_replay_like_the_reference():
    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.pipeline.pipeline import PipelineShapes

    out = run_in_subprocess(f"SMALL = {SMALL!r}\n" + REF_DEGRADED,
                            devices=4)
    want = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("REPORT ")][-1][7:])
    jm = FlakyManager(t_ft, t_rpc, 4)
    eng = ElasticEngine(reduced_config(get_config("smollm-360m"), **SMALL),
                        DistConfig(num_stages=4, slot_slack=2),
                        DynamicsConfig(), PipelineShapes(2, 2, 8),
                        job_manager=jm, device="cpu")
    got = _degraded_sequence(eng, eng.init_state(0, with_opt=True), jm)
    assert json.loads(json.dumps(got)) == want
    assert got["degraded"] == [
        "release deferred: [3]", "fail deferred: 1",
        "grow denied at step 3: manager unreachable",
        "replayed release:[3]", "replayed fail:1"]
    assert got["workers"] == [0, 2, 3]
    assert sorted(jm.pool.active) == [0, 2, 3]


def test_engine_binds_fresh_ids_to_free_slots():
    """A manager that mints a never-seen id: it takes the free stage-buffer
    slot; a grant beyond the slots is rejected and handed back."""
    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.pipeline.pipeline import PipelineShapes

    pool = t_ft.WorkerPool(3, spares=2)
    eng = ElasticEngine(
        reduced_config(get_config("smollm-360m"), num_layers=3, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128,
                       vocab_size=256),
        DistConfig(num_stages=3, slot_slack=2), DynamicsConfig(),
        PipelineShapes(2, 2, 8), pool=pool, device="cpu")
    st = eng.init_state(0, with_opt=True)
    st = eng.evict(st, [1], step=0)
    st = eng.grow(st, 2, step=1)            # fresh ids 3 and 4: one slot
    assert eng.stage_workers == [0, 2, 3]
    assert eng.worker_column[3] == 1
    assert eng.degraded_events == [
        "grant rejected (no free stage-buffer slot): [4]"]
    assert 4 in pool.released and pool.provisioned == {3, 4}
    assert eng.pool_events == ["fail:1", "grant:3", "grant:4",
                               "release:4"]
    eng.close()
    assert pool._hooks == []
