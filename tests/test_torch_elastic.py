"""Live elastic resizes in the port, against the JAX package.

* ``resplit_indices`` and the repack policies (first fit, adjacent) equal
  the reference's on seeded inputs.
* The controller's ``ResizePlan`` (and its event) equals the reference's on
  the same stats, through ``profile_from_stats``: reduced configs under
  both balancers and policies, and full-width smollm-360m on 4 stage
  buffers with ``slot_slack`` 8 after the step-10 prune of a 24-step run
  at the default ``--repack-mem-cap`` 1.1 (the card's elastic-train phase).
* A 4 -> 2 -> 4 round trip through ``ElasticEngine.resize`` is bit-identical
  for params, dyn, both Adam moments, the step count and the dense and
  paged caches (PAD slots are zeros after any re-split).
* Engine behaviour: the loss is kept across ``resize(2)`` within 1e-6, a
  step in the 2-buffer world still trains, ``evict([1])`` leaves workers
  [0, 2, 3] with worker 1 dead and the epoch bumped, evicting an unknown
  worker is a no-op, a fresh worker id granted later takes the dead one's
  stage column (one with no free column goes back to the pool), and the
  control plane drops a plan decided before a
  resize (epoch fencing) while ``rebind`` resets the straggler EMAs.
* The serving resize on ``test_paged.py``'s trace (``resize_at={4: 2, 9:
  4}``): completions equal to the fixed run's and to the reference's
  elastic run (a 4-device subprocess), and the page pool bitwise equal
  after one more shrink / grow cycle on the live state, the trash block
  excluded.
* The same serve over four ranks (``ElasticServer(mesh=)``, one rank a
  stage, each holding its stage's rows of the params and the page pool
  and running the paged decode attention on its own layers): the
  completions, resizes and pool log of the reference and of one process;
  after one more shrink / grow cycle the pool, gathered whole, bitwise the
  one-process pool (the trash block excluded), the released ranks holding
  nothing in between; phase 7e of ``chip_smoke.py`` accepts the run and
  refuses wrong ones.
"""
import copy
import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from conftest import run_in_subprocess  # noqa: E402
from repro_torch.api.specs import (ModelSpec, ParallelSpec,  # noqa: E402
                                   RunSpec, ServeSpec)
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.elastic import (_resplit_stage_tree,  # noqa: E402
                                            resplit_indices)
from repro_torch.cluster.service import ControlPlane, StatsSnapshot  # noqa: E402,E501
from repro_torch.configs import DistConfig as TDist  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduce  # noqa: E402
from repro_torch.core import repack as trp  # noqa: E402
from repro_torch.core.controller import (ControllerConfig,  # noqa: E402
                                         DynMoController)
from repro_torch.dynamics.config import DynamicsConfig as TDyn  # noqa: E402
from repro_torch.launch.dist import launch  # noqa: E402
from repro_torch.launch.engine import ElasticEngine  # noqa: E402
from repro_torch.pipeline.pipeline import PipelineShapes  # noqa: E402
from repro_torch.runtime.fault_tolerance import StragglerDetector  # noqa: E402,E501
from repro_torch.serve import ElasticServer  # noqa: E402
from repro_torch.serve.kv import PagedKVConfig  # noqa: E402
from repro_torch.serve.requests import Request  # noqa: E402
from test_torch_train import _leaves  # noqa: E402

torch.set_num_threads(1)
W8 = dict(num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, d_ff=256,
          vocab_size=512)


@pytest.mark.parametrize("old,new,L", [
    ([2, 2, 2, 2], [4, 4], 6), ([4, 4], [2, 2, 2, 2], 4),
    ([3, 1, 2, 2], [5, 3], 6), ([2, 2, 2, 2], [2, 3, 1, 2], 4),
    ([8, 8, 8, 8], [16, 16], 24)])
def test_resplit_indices_match_reference(old, new, L):
    from repro.checkpoint.elastic import resplit_indices as ref
    for got, want in zip(resplit_indices(old, new, L), ref(old, new, L)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("policy", ["first_fit", "adjacent"])
def test_repack_policies_match_reference(policy):
    from repro.core.repack import repack as ref
    r = np.random.RandomState(5)
    for _ in range(40):
        n = int(r.randint(2, 9))
        mem = r.rand(n) * 10
        nl = r.randint(0, 6, n)
        cap = float(r.rand() * 20 + 2)
        target = int(r.randint(1, n + 1))
        max_layers = int(r.randint(3, 12))
        got = trp.repack(policy, mem, nl, cap, target, max_layers)
        want = ref(policy, mem, nl, cap, target, max_layers)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError):
        trp.repack("best_fit", [1.0], [1], max_mem=1.0)


def _stats(S, L, lps, ff_active, num_micro, E=1):
    """Per-slot stats [S, L_max, ...] with ``ff_active`` (per micro) in the
    active slots."""
    ffa = np.zeros((S, L), np.float32)
    for s, n in enumerate(lps):
        ffa[s, :n] = ff_active[sum(lps[:s]):sum(lps[:s]) + n] * num_micro
    return {"ff_active": ffa, "attn_density": np.zeros((S, L), np.float32),
            "expert_load": np.zeros((S, L, E), np.float32),
            "moe_dropped": np.zeros((S, L), np.float32)}


CASES = [
    # (config, stages, slack, controller kwargs, mem-cap factor, retained)
    ("reduced", 4, 2, dict(method="diffusion"), 1.1, 0.3),
    ("reduced", 4, 2, dict(method="partition",
                           repack_policy="first_fit"), 1.1, 0.3),
    ("reduced", 4, 4, dict(method="partition", repack_target=3), 1.1, 0.2),
    ("reduced", 4, 2, dict(method="diffusion"), 1.1, 0.9),
    ("full", 4, 8, dict(method="diffusion"), 1.1, None),
    ("full", 4, 2, dict(method="diffusion"), 1.1, None),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_resize_plan_matches_reference(case):
    from repro.configs import DistConfig, get_config, reduced_config
    from repro.core import controller as rc
    from repro.core.cost_model import stage_memory_budget as ref_budget
    from repro.core.profiler import profile_from_stats as ref_profile
    from repro.dynamics import pruning as rprn
    from repro.dynamics.config import DynamicsConfig
    from repro.dynamics.trajectories import zhu_gupta_sparsity
    from repro_torch.core.cost_model import stage_memory_budget
    from repro_torch.core.profiler import profile_from_stats
    name, S, slack, ckw, cap, retained = CASES[case]
    if name == "full":
        jcfg, tcfg = get_config("smollm-360m"), tget("smollm-360m")
        m, tokens, seq = 4, 8192, 1024
        # the chip phase's prune: step 10 of a 24-step run
        sp = zhu_gupta_sparsity(1000, dataclasses.replace(
            DynamicsConfig(kind="pruning"), prune_start_iter=0,
            prune_end_iter=2400, prune_frequency=1))
        npb = 2560 // 128
        keep = rprn.target_keep_blocks(jcfg, jcfg.total_blocks(), sp)
        retained = keep / (npb * jcfg.total_blocks())
    else:
        jcfg = reduced_config(get_config("smollm-360m"), **W8)
        tcfg = treduce(tget("smollm-360m"), **W8)
        m, tokens, seq = 4, 256, 32
    kw = dict(num_stages=S, slot_slack=slack, remat="none",
              param_dtype="float32")
    jd, td = DistConfig(**kw), TDist(**kw)
    lps = [jcfg.total_blocks() // S] * S
    stats = _stats(S, jd.slots_for(jcfg), lps,
                   np.full(jcfg.total_blocks(), retained), m)
    tags = np.zeros((S, jd.slots_for(jcfg)), np.int32)
    for s in range(S):
        tags[s, :lps[s]] = 1
    budget = stage_memory_budget(tcfg, tokens, seq, 4.0, S, cap_factor=cap)
    assert budget == ref_budget(jcfg, tokens, seq, 4.0, S, cap_factor=cap)
    plans = []
    for mod, cfg, dcfg, dyn, prof in (
            (rc, jcfg, jd, DynamicsConfig(kind="pruning"), ref_profile),
            (None, tcfg, td, TDyn(kind="pruning"), profile_from_stats)):
        ccls = rc.ControllerConfig if mod else ControllerConfig
        ctrl_cls = rc.DynMoController if mod else DynMoController
        ctrl = ctrl_cls(cfg, dcfg, dyn, ccls(
            rebalance_every=5, repack=True, repack_mem_cap=budget, **ckw))
        profile = prof(cfg, stats, tags, m, tokens, seq,
                       bytes_per_param=dcfg.bytes_per_param)
        new_lps, ev = ctrl.decide(profile, 15)
        plan = ctrl.take_resize()
        ev = dataclasses.asdict(ev)
        ev.pop("decision_s")
        plans.append((new_lps, ev, None if plan is None
                      else dataclasses.asdict(plan)))
    assert plans[0] == plans[1]
    if name == "full":
        # the chip phase's decision: a shrink to 2 buffers of 16 layers
        # needs the slack; slot_slack 2 (10 slots a buffer) cannot merge
        got = plans[1][2]
        if slack == 8:
            assert got["target_stages"] == 2
            assert got["layers_per_stage"] == [16, 16]
        else:
            assert got is None


def _engine(S=4, paged=None, kind="none"):
    cfg = treduce(tget("smollm-360m"), **W8)
    dcfg = TDist(num_stages=S, slot_slack=2, remat="none",
                 param_dtype="float32", kernel_impl="pallas")
    shapes = PipelineShapes(2, 2, 32, cache_len=48)
    return ElasticEngine(cfg, dcfg, TDyn(kind=kind), shapes, paged=paged,
                         device="cpu")


def _batch(cfg, seed=0):
    r = np.random.RandomState(seed)
    return {"tokens": r.randint(0, cfg.vocab_size, (2, 2, 32)),
            "labels": r.randint(0, cfg.vocab_size, (2, 2, 32)),
            "label_mask": np.ones((2, 2, 32), np.float32)}


@pytest.mark.parametrize("paged", [False, True])
def test_round_trip_4_2_4_is_bit_identical(paged):
    pg = PagedKVConfig(page_size=4, pool_pages=24) if paged else None
    eng = _engine(paged=pg, kind="mod")
    st = eng.init_state(0, with_opt=True, with_cache=True)
    eng.step(st, _batch(eng.cfg), 3e-4)     # non-zero Adam moments
    g = torch.Generator().manual_seed(1)
    st.cache = {k: torch.randn(v.shape, generator=g)
                for k, v in st.cache.items()}
    st.dyn = {k: torch.rand(v.shape, generator=g)
              for k, v in st.dyn.items()}
    L4 = eng.dcfg_for(4).slots_for(eng.cfg)
    lps = st.lps

    def norm(tree):       # PAD slots hold zeros after any re-split
        return _resplit_stage_tree(tree, lps, lps, L4)

    want = {"params": norm(st.params["stages"]), "dyn": norm(st.dyn),
            "m": norm(st.opt_state["m"]["stages"]),
            "v": norm(st.opt_state["v"]["stages"]),
            "cache": norm(st.cache)}
    rest = {k: v.clone() for k, v in st.params.items() if k != "stages"
            and torch.is_tensor(v)}
    count = st.opt_state["count"].clone()
    s2 = eng.resize(st, 2)
    assert s2.lps == [4, 4] and eng.epoch == 1
    assert s2.params["stages"]["wq"].shape[:2] == (2, 6)
    s4 = eng.resize(s2, 4)
    assert s4.lps == lps and eng.epoch == 2
    got = {"params": s4.params["stages"], "dyn": s4.dyn,
           "m": s4.opt_state["m"]["stages"],
           "v": s4.opt_state["v"]["stages"], "cache": s4.cache}
    for name in want:
        for (k, a), (_, b) in zip(_leaves(got[name]), _leaves(want[name])):
            assert torch.equal(a, b), (name, k)
    for k, v in rest.items():
        assert torch.equal(s4.params[k], v), k
    assert torch.equal(s4.opt_state["count"], count)


def test_engine_resize_keeps_the_loss_and_trains():
    eng = _engine()
    st = eng.init_state(0, with_opt=True)
    batch = _batch(eng.cfg)
    l4 = float(eng.eval_loss(st, batch))
    s2 = eng.resize(st, 2)
    assert float(eng.eval_loss(s2, batch)) == pytest.approx(l4, abs=1e-6)
    assert eng.pool.num_active == 4           # resize() alone: pool-neutral
    before = s2.params["stages"]["wq"].clone()
    loss, _, gnorm = eng.step(s2, batch, 3e-4)
    assert np.isfinite(float(loss)) and np.isfinite(float(gnorm))
    assert eng.last_step_compiled             # the 2-buffer world's first
    assert not torch.equal(before, s2.params["stages"]["wq"])


def test_engine_evict():
    eng = _engine()
    st = eng.init_state(0, with_opt=True)
    batch = _batch(eng.cfg)
    l4 = float(eng.eval_loss(st, batch))
    s3 = eng.evict(st, [1], step=7)
    assert eng.epoch == 1
    assert eng.stage_workers == [0, 2, 3]
    assert eng.pool.dead == {1} and not eng.pool.released
    assert eng.pool.num_active == 3
    assert eng.jm.request(1) == []            # dead workers are not granted
    assert float(eng.eval_loss(s3, batch)) == pytest.approx(l4, abs=1e-6)
    rz = eng.resizes[-1]
    assert (rz.kind, rz.workers, rz.step, rz.from_stages, rz.to_stages) \
        == ("evict", [1], 7, 4, 3)
    assert eng.evict(s3, [9]) is s3           # unknown worker: no-op
    assert eng.epoch == 1
    # the dead worker is never granted back: a shrink releases the tail
    # worker and a grow of two gets that one only
    s2 = eng.shrink(s3, 2, step=9)
    assert eng.stage_workers == [0, 2] and eng.pool.released == {3}
    s3b = eng.grow(s2, 2, step=10)
    assert eng.stage_workers == [0, 2, 3] and s3b.stages == 3
    assert eng.epoch == 3
    assert float(eng.eval_loss(s3b, batch)) == pytest.approx(l4, abs=1e-6)
    assert eng.pool.log == ["fail:1", "release:3", "grant:3"]
    eng.pool.check_consistent()


def test_shrink_grow_and_epoch_fencing():
    eng = _engine()
    st = eng.init_state(0, with_opt=True)
    det = StragglerDetector(4)
    det.update(np.array([1.0, 2.0, 1.0, 1.0]))
    ctrl = DynMoController(eng.cfg, eng.base_dcfg, eng.dyncfg,
                           ControllerConfig(rebalance_every=1),
                           straggler=det)
    cp = ControlPlane(ctrl, async_mode=False, epoch_fn=lambda: eng.epoch)
    L = eng.base_dcfg.slots_for(eng.cfg)
    snap = StatsSnapshot(
        iteration=1, epoch=eng.epoch,
        stats=_stats(4, L, [2] * 4, np.ones(8), 2),
        tags=st.assignment["tags"].numpy(), num_micro=2, tokens=128,
        seq=32, stage_times=np.array([1.0, 2.0, 1.0, 1.0]))
    cp.publish(snap)                          # decided against epoch 0
    s2 = eng.shrink(st, 2, step=3)
    assert eng.stage_workers == [0, 1] and eng.pool.released == {2, 3}
    assert cp.poll(eng.epoch) is None and cp.stale_rejected == 1
    cp.publish(snap)                          # a stale snapshot: not decided
    assert cp.stale_rejected == 2 and cp.poll(eng.epoch) is None
    cp.rebind(eng.dcfg_for(2), s2.lps)
    assert ctrl.lps == [4, 4] and not det.initialized
    assert det.times.shape == (2,)
    plan = cp.inject_resize(eng.epoch, 1, policy="scripted")
    assert cp.poll(eng.epoch) is plan and plan.resize.target_stages == 1
    s4 = eng.grow(s2, 2, step=5)
    assert s4.stages == 4 and eng.stage_workers == [0, 1, 2, 3]
    assert eng.pool.log == ["release:2", "release:3", "grant:2", "grant:3"]
    assert eng.grow(s4, 1) is s4              # nothing left to grant
    assert [(r.kind, r.ticks_before, r.ticks_after)
            for r in eng.resizes] == [("shrink", 5, 3), ("grow", 3, 5)]
    eng.pool.check_consistent()


# ---------------------------------------------------------------------------
# the serving resize
# ---------------------------------------------------------------------------
SERVE_REF = """
import copy, json
import jax
import numpy as np
from repro.configs import DistConfig, get_config, reduced_config
from repro.dynamics.config import DynamicsConfig
from repro.pipeline.pipeline import PipelineShapes
from repro.serve import ElasticServer
from repro.serve.kv import PagedKVConfig
from repro.serve.requests import Request

cfg = reduced_config(get_config("smollm-360m"), num_layers=6, d_model=64,
                     num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256)
dcfg = DistConfig(num_stages=4, slot_slack=2, remat="none",
                  param_dtype="float32")
rng = np.random.RandomState(9)
base = [Request(rid=i, arrival=[0, 0, 1, 3, 4, 6][i],
                prompt=rng.randint(0, 256, [8, 6, 8, 4, 7, 8][i])
                .astype(np.int32),
                gen=[6, 4, 5, 6, 3, 5][i]) for i in range(6)]
paged = PagedKVConfig(page_size=4, pool_pages=16, prefix_cache=False)
shapes = PipelineShapes(num_micro=2, mb_global=2, seq=8, cache_len=16)
srv = ElasticServer(cfg, dcfg, DynamicsConfig(), shapes, seed=0,
                    paged=paged)
rep = srv.serve(copy.deepcopy(base), resize_at={4: 2, 9: 4})
flat = {}

def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        flat[prefix] = np.asarray(jax.device_get(tree))

put("params", srv.state.params)
np.savez(NPZ, **flat)
print("REPORT " + json.dumps({
    "tokens": {c["rid"]: c["tokens"] for c in rep["completions"]},
    "resizes": [[r["kind"], r["from_stages"], r["to_stages"], r["workers"],
                 r["step"]] for r in rep["resizes"]],
    "pool_log": rep["pool_log"]}))
"""


def _serve_port(params, resize_at):
    cfg = treduce(tget("smollm-360m"), num_layers=6, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256)
    dcfg = TDist(num_stages=4, slot_slack=2, remat="none",
                 param_dtype="float32")
    rng = np.random.RandomState(9)
    base = [Request(rid=i, arrival=[0, 0, 1, 3, 4, 6][i],
                    prompt=rng.randint(0, 256, [8, 6, 8, 4, 7, 8][i])
                    .astype(np.int32),
                    gen=[6, 4, 5, 6, 3, 5][i]) for i in range(6)]
    srv = ElasticServer(cfg, dcfg, TDyn(),
                        PipelineShapes(num_micro=2, mb_global=2, seq=8,
                                       cache_len=16),
                        seed=0, device="cpu", params=params,
                        paged=PagedKVConfig(page_size=4, pool_pages=16,
                                            prefix_cache=False))
    rep = srv.serve(copy.deepcopy(base), resize_at=resize_at)
    return srv, rep, {c["rid"]: c["tokens"] for c in rep["completions"]}


@pytest.fixture(scope="module")
def serve_ref(tmp_path_factory):
    """The reference's elastic serve (a 4-device subprocess) and its
    params, handed over."""
    npz = os.path.join(str(tmp_path_factory.mktemp("ref")), "params.npz")
    out = run_in_subprocess(f"NPZ = {npz!r}\n" + SERVE_REF, devices=4)
    line = [ln for ln in out.splitlines() if ln.startswith("REPORT ")][-1]
    want = json.loads(line[7:])
    tree = {"params": {"shared": {}}}
    with np.load(npz) as z:
        for key in z.files:
            node = tree
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return want, convert.to_torch(tree["params"], "cpu")


def test_serving_resize_matches_fixed_and_reference(serve_ref):
    want, params = serve_ref
    _, _, fixed = _serve_port(params, None)
    srv, rep, elastic = _serve_port(params, {4: 2, 9: 4})
    assert elastic == fixed
    assert {str(k): v for k, v in elastic.items()} == want["tokens"]
    assert [[r["kind"], r["from_stages"], r["to_stages"], r["workers"],
             r["step"]] for r in rep["resizes"]] == want["resizes"]
    assert rep["pool_log"] == want["pool_log"]
    # the pool through one more shrink / grow cycle on the live state:
    # bitwise, the trash block (the last, nothing reads it) excluded
    before = {k: v.clone() for k, v in srv.state.cache.items()}
    st = srv.engine.shrink(srv.state, 2, step=100)
    st = srv.engine.grow(st, 2, step=101)
    assert set(st.cache) == set(before)
    for k, v in before.items():
        assert st.cache[k].shape == v.shape, k
        assert torch.equal(st.cache[k][:, :, :-1], v[:, :, :-1]), k


# ---------------------------------------------------------------------------
# the serving resize over four ranks
# ---------------------------------------------------------------------------
RESIZE_AT = {4: 2, 9: 4}
SPEC = RunSpec(model=ModelSpec(arch="smollm-360m", layers=6, d_model=64,
                               num_heads=4, num_kv_heads=2, d_ff=128,
                               vocab_size=256),
               parallel=ParallelSpec(stages=4, num_micro=2, mb_global=2),
               serve=ServeSpec(prompt_len=8, gen=8, kv_page_size=4,
                               kv_pool_pages=16), seed=0)


def _trace():
    rng = np.random.RandomState(9)
    return [Request(rid=i, arrival=[0, 0, 1, 3, 4, 6][i],
                    prompt=rng.randint(0, 256, [8, 6, 8, 4, 7, 8][i])
                    .astype(np.int32),
                    gen=[6, 4, 5, 6, 3, 5][i]) for i in range(6)]


@pytest.fixture(scope="module")
def served(serve_ref):
    want, params = serve_ref
    ranks = launch("_dist_targets:serve_cycle", 4, device="cpu",
                   run_timeout_s=240,
                   kwargs=dict(spec=SPEC, trace=_trace(),
                               resize_at=RESIZE_AT, params=params))
    srv, rep, tokens = _serve_port(params, RESIZE_AT)
    st = srv.engine.shrink(srv.state, 2, step=100)
    st = srv.engine.grow(st, 2, step=101)
    return want, ranks, (rep, tokens, st.cache)


def test_paged_serve_over_four_ranks_matches_reference(served):
    want, ranks, (one, one_tokens, _) = served
    rep = ranks[0]["report"]
    got = {c["rid"]: c["tokens"] for c in rep["completions"]}
    assert got == one_tokens
    assert {str(k): v for k, v in got.items()} == want["tokens"]
    assert [[r["kind"], r["from_stages"], r["to_stages"], r["workers"],
             r["step"]] for r in rep["resizes"]] == want["resizes"] == [
        ["shrink", 4, 2, [2, 3], 4], ["grow", 2, 4, [2, 3], 9]]
    assert rep["pool_log"] == want["pool_log"] == one["pool_log"]
    assert rep["stages_history"] == one["stages_history"]
    assert [r["role"] for r in ranks] == ["active"] * 4
    assert all(r["foreign"] == [] for r in ranks)


def test_page_pool_after_a_cycle_is_bitwise_one_process(served):
    _, ranks, (_, _, pool) = served
    got = ranks[0]["pool"]
    assert set(got) == set(pool) == {"kp", "vp"}
    for k, v in pool.items():
        assert got[k].shape == v.shape, k
        assert torch.equal(got[k][:, :, :-1], v[:, :, :-1]), k
    # the cycle's shrink released ranks 2 and 3: they held nothing
    assert [r["held_after_shrink"] > 0 for r in ranks] == [True, True,
                                                           False, False]


def test_chip_smoke_7e_checks_refuse_a_wrong_run(served):
    """Phase 7e holds the ranks' serve to 4i's one process: the run above
    passes; a rank that launched no K6, a token or a pool entry that
    differs fails it."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, ranks, (one, one_tokens, pool) = served
    rep = dict(ranks[0]["report"],
               pool_digests=smoke.pool_digests(ranks[0]["pool"]))
    infos = [{"rank": i, "launches": {"paged_attention": {
        "launches": 3, "tc": 0, "bwd": 0, "split": 3}}} for i in range(4)]
    want = {"tokens": one_tokens, "pool_digests": smoke.pool_digests(pool),
            "launches": {"paged_attention": 12},
            "resizes": [(r["kind"], r["step"], r["from_stages"],
                         r["to_stages"]) for r in one["resizes"]]}
    assert smoke.check_elastic_serve_across(rep, infos, want) == 12
    idle = copy.deepcopy(infos)
    idle[3]["launches"]["paged_attention"].update(launches=0, split=0)
    idle[0]["launches"]["paged_attention"].update(launches=6, split=6)
    with pytest.raises(AssertionError, match="launched no K6"):
        smoke.check_elastic_serve_across(rep, idle, want)
    bad = copy.deepcopy(rep)
    bad["completions"][0]["tokens"][0] += 1
    with pytest.raises(AssertionError, match="tokens differ"):
        smoke.check_elastic_serve_across(bad, infos, want)
    moved = {k: v.clone() for k, v in ranks[0]["pool"].items()}
    moved["kp"][1, 0, 0] += 1.0
    bad = dict(rep, pool_digests=smoke.pool_digests(moved))
    with pytest.raises(AssertionError, match=r"rows of stages \[1\]"):
        smoke.check_elastic_serve_across(bad, infos, want)
    # the trash block (the last) is not compared: nothing reads it
    moved = {k: v.clone() for k, v in ranks[0]["pool"].items()}
    moved["vp"][2, 0, -1] += 1.0
    assert smoke.check_elastic_serve_across(
        dict(rep, pool_digests=smoke.pool_digests(moved)), infos, want) == 12
