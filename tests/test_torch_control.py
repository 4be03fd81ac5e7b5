"""The port's control-plane inputs: the asynchronous ``ControlPlane``,
``StageTimer`` and the two sources of measured per-stage times.

* The async plane mirrors ``tests/test_cluster.py``'s decision-service
  tests on the port's controller: a decision on the worker thread equals
  the inline one from the same snapshots (rebalance and repack plans), a
  stale plan is rejected at ``poll``, a stale snapshot is never decided, a
  worker error surfaces on the training thread, and the mailbox is
  latest-wins.  Its train CLI with ``--async-controller --async-drain``
  gives the inline run's losses bitwise with the same resizes (the
  reference's ``test_async_controller_loss_parity`` flags).
* ``StageTimer`` pairs, scales and resets as the reference's does: both
  read the same stamps on one fake clock and agree exactly.
* On a skewed ``[8, 1, 1, 1]`` split of 11 layers (``tests/test_obs.py``'s
  setup) the in-step times and the probe both rank stage 0 slowest and
  strictly above each 1-layer stage (the port's two sources against each
  other; the reference's own ranking test is not used as an oracle).
* In the CLI, in-step times come first and the probe fills in; in-step
  times alone are published but not consumed (no straggler detector), so
  the run's losses equal the untimed run's bitwise.

Sizes: reduced smollm (8-16 layers, d_model 64-128, heads 4/2, d_ff
256-2048, vocab 256-512) on the CPU.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.cluster.service import ControlPlane, StatsSnapshot
from repro_torch.configs import DistConfig, get_config, reduced_config
from repro_torch.core.controller import ControllerConfig, DynMoController
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.launch.train import run
from repro_torch.models import model as M
from repro_torch.obs import timing
from repro_torch.obs.timing import StageTimer

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the asynchronous decision service (tests/test_cluster.py:73-180)
# ---------------------------------------------------------------------------
def _setup(stages=4, layers=8, **ccfg_kw):
    cfg = reduced_config(get_config("smollm-360m"), num_layers=layers,
                         d_model=64, d_ff=2048)
    dcfg = DistConfig(num_stages=stages, slot_slack=3, remat="none",
                      param_dtype="float32")
    ctrl = DynMoController(
        cfg, dcfg, DynamicsConfig(kind="pruning"),
        ControllerConfig(method="partition", rebalance_every=1, **ccfg_kw))
    return cfg, dcfg, ctrl


def _snapshot(cfg, dcfg, iteration, epoch=0, seed=0):
    """Skewed per-slot stats (later stages keep most of their FFN) with a
    per-iteration jitter, as the reference test's."""
    tags = M.make_assignment(cfg, dcfg)["tags"].numpy()
    rng = np.random.RandomState(seed + iteration)
    num_micro = 4
    live = tags != 0
    S = tags.shape[0]
    grad = np.linspace(0.1, 1.0, S)[:, None] * np.ones_like(tags, float)
    ff = np.where(live, num_micro * np.clip(
        grad + rng.uniform(-0.05, 0.05, tags.shape), 0.02, 1.0), 0.0)
    stats = {"ff_active": ff,
             "attn_density": np.where(live, 0.1 * num_micro, 0.0),
             "expert_load": np.zeros(tags.shape + (1,))}
    return StatsSnapshot(iteration=iteration, epoch=epoch, stats=stats,
                         tags=tags, num_micro=num_micro, tokens=4096, seq=64)


def _plan_key(plan):
    if plan is None:
        return None
    rz = plan.resize
    return (plan.iteration, plan.epoch,
            tuple(plan.new_lps) if plan.new_lps is not None else None,
            (rz.target_stages, tuple(rz.layers_per_stage),
             tuple(rz.released_stages), tuple(rz.mem_per_stage))
            if rz is not None else None,
            plan.event.imbalance_before, plan.event.imbalance_after,
            plan.event.moved_layers, plan.event.rebalanced)


@pytest.mark.parametrize("repack", [False, True])
def test_async_decision_equals_inline_on_same_snapshots(repack):
    kw = (dict(repack=True, repack_mem_cap=1e18, repack_target=2)
          if repack else {})
    cfg, dcfg, ctrl_a = _setup(layers=16, **kw)
    _, _, ctrl_b = _setup(layers=16, **kw)
    inline = ControlPlane(ctrl_a, async_mode=False)
    with ControlPlane(ctrl_b, async_mode=True) as background:
        assert background._thread.is_alive()
        interesting = 0
        for it in range(1, 8):
            snap = _snapshot(cfg, dcfg, it)
            inline.publish(snap)
            background.publish(snap)
            background.drain()
            p_in, p_bg = inline.poll(0), background.poll(0)
            assert _plan_key(p_in) == _plan_key(p_bg)
            if p_in is None:
                continue
            if repack:
                interesting += p_in.resize is not None
            elif p_in.new_lps is not None:
                interesting += 1
                new = list(p_in.new_lps)
                inline.with_ctrl(lambda c: setattr(c, "lps", list(new)))
                background.with_ctrl(lambda c: setattr(c, "lps", list(new)))
        assert interesting >= 1
        assert background.decided == inline.decided == 7
    assert not background._thread.is_alive()     # close() stopped it


def test_stale_epoch_plan_rejected_on_poll():
    cfg, dcfg, ctrl = _setup()
    with ControlPlane(ctrl, async_mode=True) as cp:
        cp.publish(_snapshot(cfg, dcfg, 1, epoch=0))
        cp.drain()
        assert cp.poll(1) is None           # the world resized meanwhile
        assert cp.stale_rejected == 1
        cp.publish(_snapshot(cfg, dcfg, 2, epoch=0))
        cp.drain()
        assert cp.poll(0) is not None


def test_stale_epoch_snapshot_skipped_before_decide():
    cfg, dcfg, ctrl = _setup()
    epoch = [1]
    with ControlPlane(ctrl, async_mode=True,
                      epoch_fn=lambda: epoch[0]) as cp:
        cp.publish(_snapshot(cfg, dcfg, 1, epoch=0))
        cp.drain()
        assert cp.poll(1) is None
        assert cp.stale_rejected == 1
        assert ctrl.events == [] and cp.decided == 0


def test_worker_thread_error_surfaces_on_training_thread():
    cfg, dcfg, ctrl = _setup()
    with ControlPlane(ctrl, async_mode=True) as cp:
        bad = _snapshot(cfg, dcfg, 1)
        bad.tags = np.zeros(3)              # wrong rank: the profiler raises
        cp.publish(bad)
        with pytest.raises(RuntimeError, match="decision worker failed"):
            cp.drain()
        cp.publish(_snapshot(cfg, dcfg, 2))  # the worker is still alive
        cp.drain()
        assert cp.poll(0) is not None
        bad = _snapshot(cfg, dcfg, 3)
        bad.tags = np.zeros(3)
        cp.publish(bad)
        deadline = time.monotonic() + 30
        while cp._error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="decision worker failed"):
            cp.poll(0)                      # poll raises it too


def test_mailbox_is_latest_wins():
    cfg, dcfg, ctrl = _setup()
    cp = ControlPlane(ctrl, async_mode=True)
    cp.close()                              # freeze the worker
    for it in (1, 2, 3):
        cp.publish(_snapshot(cfg, dcfg, it))
    assert cp.published == 3 and cp.dropped == 2
    assert cp._inbox.iteration == 3


def test_inline_drain_is_a_no_op_and_the_default():
    cfg, dcfg, ctrl = _setup()
    cp = ControlPlane(ctrl)
    assert not cp.async_mode and cp._thread is None
    cp.publish(_snapshot(cfg, dcfg, 1))
    cp.drain()
    assert cp.poll(0) is not None
    cp.close()


# ---------------------------------------------------------------------------
# StageTimer
# ---------------------------------------------------------------------------
class _Clock:
    def __init__(self, ticks):
        self.ticks = list(ticks)

    def perf_counter(self):
        return self.ticks.pop(0)


def _stamps(timer):
    # stage 1 twice, stage 0 once, an unpaired close, a stage out of range
    timer.stamp(1, 0)
    timer.stamp(1, 1)
    timer.stamp(0, 1)            # no open stamp: ignored
    timer.stamp(0, 0)
    timer.stamp(0, 1)
    timer.stamp(5, 0)            # out of range: ignored
    timer.stamp(1, 0)
    timer.stamp(1, 1)


def test_stage_timer_semantics(monkeypatch):
    ticks = [0.0, 1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 7.0]
    monkeypatch.setattr(timing, "time", _Clock(ticks + ticks))
    t = StageTimer(3)
    assert t.snapshot() is None
    _stamps(t)
    assert t.samples.tolist() == [1, 2, 0]
    assert t.snapshot() is None           # stage 2 never stamped ...
    assert t.samples.tolist() == [0, 0, 0]    # ... and the read reset it
    t = StageTimer(2)
    _stamps(t)
    got = t.snapshot(ticks_per_step=4, reset=False)
    # stage 0: one 0.5 s call; stage 1: (1.0 + 3.0) / 2 per call
    np.testing.assert_array_equal(got, [0.5 * 4, 2.0 * 4])
    np.testing.assert_array_equal(t.snapshot(), [0.5, 2.0])
    assert t.snapshot() is None           # reset on read
    pytest.importorskip("jax")
    from repro.obs import timing as ref_timing
    monkeypatch.setattr(ref_timing, "time", _Clock(ticks))
    ref = ref_timing.StageTimer(2)
    _stamps(ref)
    np.testing.assert_array_equal(ref.snapshot(ticks_per_step=4),
                                  [0.5 * 4, 2.0 * 4])


# ---------------------------------------------------------------------------
# in-step times against the probe
# ---------------------------------------------------------------------------
def test_in_step_and_probe_rank_the_skewed_split_alike():
    from repro_torch.data.loader import DataConfig, make_loader
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.pipeline.pipeline import PipelineShapes
    cfg = reduced_config(get_config("smollm-360m"), num_layers=11,
                         d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                         vocab_size=256)
    dcfg = DistConfig(num_stages=4, slot_slack=6, remat="none",
                      param_dtype="float32")
    shapes = PipelineShapes(num_micro=4, mb_global=4, seq=64)
    engine = ElasticEngine(cfg, dcfg, DynamicsConfig(), shapes,
                           in_step_timing=True, device="cpu")
    state = engine.init_state(0, with_opt=True, lps=[8, 1, 1, 1])
    assert state.assignment["num_active"].tolist() == [8, 1, 1, 1]
    batch = next(make_loader(cfg, DataConfig(num_micro=4, mb_global=4,
                                             seq=64)))
    assert engine.in_step_stage_times(state) is None     # no window yet
    for _ in range(4):
        engine.step(state, batch, 1e-3)
    in_step = engine.in_step_stage_times(state)
    probe = engine.measure_stage_times(state, batch)
    assert in_step.shape == probe.shape == (4,)
    assert (in_step > 0).all() and (probe > 0).all()
    assert in_step.argmax() == 0 and probe.argmax() == 0, (in_step, probe)
    assert all(in_step[0] > in_step[i] for i in (1, 2, 3)), in_step
    assert all(probe[0] > probe[i] for i in (1, 2, 3)), probe
    assert engine.in_step_stage_times(state) is None     # reset on read
    # a timer-less engine has no in-step times
    plain = ElasticEngine(cfg, dcfg, DynamicsConfig(), shapes, device="cpu")
    assert plain.in_step_stage_times(state) is None


CLI = ["--layers", "8", "--d-model", "64", "--num-heads", "4",
       "--num-kv-heads", "2", "--d-ff", "256", "--vocab-size", "256",
       "--stages", "2", "--num-micro", "2", "--mb-global", "2", "--seq",
       "32", "--steps", "12", "--dynamism", "pruning", "--rebalance-every",
       "4", "--log-every", "100", "--device", "cpu"]


@pytest.mark.parametrize("flags,source,consumed", [
    (["--in-step-timing", "--measure-stage-times"], "in_step", True),
    (["--obs.in_step_timing", "true"], "in_step", False),
    (["--measure-stage-times"], "probe", True)],
    ids=["both", "in_step_alone", "probe"])
def test_cli_stage_time_sources(flags, source, consumed):
    base = run(CLI)
    rep = run(CLI + flags)
    assert rep["stage_time_source"] == source
    assert [e["step"] for e in rep["stage_times"]] == [3, 7, 11]
    assert {e["source"] for e in rep["stage_times"]} == {source}
    assert all(len(e["seconds"]) == 2 and min(e["seconds"]) > 0
               and len(e["expected"]) == 2 for e in rep["stage_times"])
    assert rep["measured_stage_times"] == rep["stage_times"][-1]["seconds"]
    assert base["stage_times"] == [] and base["stage_time_source"] is None
    if not consumed:
        # published but not consumed: no detector, the same run bit for bit
        assert rep["losses"] == base["losses"]
        assert [(e.iteration, e.moved_layers) for e in rep["events"]] == \
            [(e.iteration, e.moved_layers) for e in base["events"]]


ASYNC = ["--layers", "8", "--d-model", "128", "--num-heads", "4",
         "--num-kv-heads", "2", "--d-ff", "256", "--vocab-size", "512",
         "--stages", "4", "--num-micro", "4", "--mb-global", "2", "--seq",
         "32", "--steps", "20", "--dynamism", "pruning", "--repack",
         "--rebalance-every", "5", "--log-every", "1000", "--device", "cpu"]


def _resizes(rep):
    return [(r["kind"], r["step"], r["from_stages"], r["to_stages"])
            for r in rep["resizes"]]


def test_async_controller_with_drain_is_the_inline_run():
    """tests/test_cluster.py:467-491's flags on the port's CLI."""
    a = run(ASYNC)
    b = run(ASYNC + ["--async-controller", "--async-drain"])
    assert a["losses"] == b["losses"]
    assert _resizes(a) == _resizes(b) == [("shrink", 14, 4, 2)]
    assert a["stages_history"] == b["stages_history"]
    assert a["pool_log"] == b["pool_log"]
    assert a["controller"]["mode"] == "inline"
    assert b["controller"]["mode"] == "async"
    assert b["controller"]["decided"] == a["controller"]["decided"] == 4
    # without the drain the thread still decides; a stale plan is dropped,
    # never applied
    c = run(ASYNC + ["--async-controller"])
    assert c["controller"]["decided"] >= 1
    assert len(c["losses"]) == 20
    assert all(np.isfinite(c["losses"]))


def test_mailbox_counts_survive_a_stress_of_threads():
    """Publishers on several threads against the decision thread, with a
    short switch interval: every snapshot is either decided or dropped
    (overwritten), so no counter update was lost."""
    import sys
    import threading
    cfg, dcfg, ctrl = _setup()
    snaps = [_snapshot(cfg, dcfg, it) for it in range(1, 9)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ControlPlane(ctrl, async_mode=True) as cp:
            def publish(k):
                for i in range(40):
                    cp.publish(snaps[(k + i) % len(snaps)])
                    cp.poll(0)
            threads = [threading.Thread(target=publish, args=(k,))
                       for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            cp.drain(timeout=120)
            assert cp.published == 8 * 40
            assert cp.decided + cp.dropped == cp.published, (
                cp.decided, cp.dropped)
            assert cp.decided >= 1 and cp.stale_rejected == 0
    finally:
        sys.setswitchinterval(old)


def _straggler_plan(P, stage_times):
    """The plan ``P``'s controller (the port's or the reference's
    modules) decides for a reduced smollm's profile with these measured
    stage times."""
    cfg = P.reduced_config(P.get_config("smollm-360m"), num_layers=8,
                           d_model=64, num_heads=4, num_kv_heads=2,
                           d_ff=256, vocab_size=512)
    dcfg = P.DistConfig(num_stages=4, param_dtype="float32")
    tags = np.asarray(P.make_assignment(cfg, dcfg)["tags"])
    live = np.where(tags != 0, 4.0, 0.0)
    stats = {"ff_active": live, "attn_density": live,
             "expert_load": np.zeros(tags.shape + (1,))}
    ctrl = P.DynMoController(cfg, dcfg, P.DynamicsConfig(kind="pruning"),
                             P.ControllerConfig(rebalance_every=3),
                             straggler=P.StragglerDetector(4))
    ctrl.straggler.update(np.asarray(stage_times, dtype=np.float64))
    prof = P.profile_from_stats(cfg, stats, tags, 4, 256, 32,
                                bytes_per_param=4)
    return ctrl.decide(prof, 3)[0]


def _modules(root):
    import importlib
    import types
    names = {"configs.base": ("DistConfig", "get_config", "reduced_config"),
             "core.controller": ("ControllerConfig", "DynMoController"),
             "core.profiler": ("profile_from_stats",),
             "dynamics.config": ("DynamicsConfig",),
             "models.model": ("make_assignment",),
             "runtime.fault_tolerance": ("StragglerDetector",)}
    P = types.SimpleNamespace()
    for mod, attrs in names.items():
        m = importlib.import_module(f"{root}.{mod}")
        for a in attrs:
            setattr(P, a, getattr(m, a))
    return P


def test_straggler_decision_does_not_depend_on_the_step_wall_time():
    """A simulated 3x straggler's stage times are the step's wall time
    split by layer counts: at every wall time the port's controller
    decides the plan the reference's decides for the exact times [1, 3,
    1, 1].  The relative slowdown is 2.0 up to the last bits of the
    scale, and the balancer breaks an exact tie between two cuts on those
    bits; unrounded, about a quarter of wall times gave no rebalance (the
    one-process run of the test below then had no event)."""
    want = _straggler_plan(_modules("repro"), [1.0, 3.0, 1.0, 1.0])
    assert want is not None
    port = _modules("repro_torch")
    decided = {}
    for wall in np.linspace(0.2, 0.4, 401):
        lps = _straggler_plan(port, np.full(4, wall / 4) * [1, 3, 1, 1])
        decided.setdefault(str(lps), []).append(float(wall))
    assert list(decided) == [str(want)], {
        k: (len(v), v[:3]) for k, v in decided.items()}


LATENCY = ["--layers", "8", "--d-model", "64", "--num-heads", "4",
           "--num-kv-heads", "2", "--d-ff", "256", "--vocab-size", "512",
           "--stages", "4", "--num-micro", "4", "--mb-global", "2", "--seq",
           "32", "--steps", "10", "--rebalance-every", "3", "--straggler",
           "1:3.0", "--dynamism", "pruning", "--log-every", "1000",
           "--device", "cpu"]


def test_async_without_drain_across_ranks_applies_each_plan_at_one_step(
        monkeypatch):
    """``--async-controller`` without ``--async-drain`` over 4 ranks, with
    decisions that take two steps (``_dist_targets.fixed_latency``): every
    rank applies the same plans at the same steps, and the run is bitwise
    the one-process run with the same latency."""
    from repro_torch.api.specs import RunSpec
    from repro_torch.cluster import service
    from repro_torch.launch.dist import launch

    import _dist_targets as T
    for name in ("ControlPlane", "RankControlPlane"):
        monkeypatch.setattr(service, name, getattr(service, name))
    T.patch_latency(2)
    one = run(LATENCY + ["--async-controller"])
    ranks = launch("_dist_targets:latency_train", 4, device="cpu",
                   kwargs=dict(spec=RunSpec.from_dict(one["spec"]), k=2))
    rep = ranks[0]["report"]
    applied = one["controller"]["applied"]
    # published after steps 2, 5 and 8; applied two steps later (the last
    # after the run's end), the first migrating under the straggler
    assert [a[0] - a[1] for a in applied] == [1, 1]
    assert one["events"][0].moved_layers > 0
    assert [r["rank"]["applied"] for r in ranks] == [applied] * 4
    assert rep["controller"]["applied"] == applied
    assert rep["losses"] == one["losses"]
    assert rep["stages_history"] == one["stages_history"]
    assert rep["controller"]["decided"] == one["controller"]["decided"] == 3
