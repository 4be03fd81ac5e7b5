"""The port's training path against the JAX package's, at the test size
(reduced smollm: 4 layers, d_model 64, heads 4/2, d_ff 256, vocab 256).

* the loader yields bit-identical batches;
* ``build_loss_fn`` + ``value_and_grad``: loss and every gradient leaf
  against ``jax.value_and_grad`` of the reference's pipelined loss, S = 1
  in this process and S = 2 in a 2-device subprocess (pruned ff_mask, a
  frozen slot; sparse attention with the reference's hash projection);
* ``reference_loss`` against the reference's and against the pipelined
  loss;
* AdamW and Adafactor with clipping and the frozen mask over 3 updates;
* ``global_block_prune`` masks are equal;
* on identical snapshots the controller decides the same splits, and its
  migration is bitwise the reference's and loss-neutral.
Both sides run ``kernel_impl="pallas"``: the reference's Pallas kernels in
interpret mode, the port's kernels' plain versions on the CPU.
Tolerances (fp32 on both sides, summation order differs): losses 1e-5
relative; each gradient leaf within 1e-5 of that leaf's largest |entry|;
optimizer states 1e-6 (params move by lr·O(1) per step).
"""
import os

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import run_in_subprocess  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import DistConfig as TDist  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduce  # noqa: E402
from repro_torch.dynamics.config import DynamicsConfig as TDyn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.pipeline import pipeline as TP  # noqa: E402

torch.set_num_threads(1)
SMALL = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=256)
M_, B_, SEQ = 2, 2, 160        # two 128-blocks, the second partial


def _worlds(stages, kind="pruning"):
    from repro.configs import DistConfig, get_config, reduced_config
    from repro.dynamics.config import DynamicsConfig
    kw = dict(num_stages=stages, slot_slack=2, remat="none",
              param_dtype="float32", kernel_impl="pallas")
    dkw = dict(kind=kind, sparse_block=32)
    return ((reduced_config(get_config("smollm-360m"), **SMALL),
             DistConfig(**kw), DynamicsConfig(**dkw)),
            (treduce(tget("smollm-360m"), **SMALL), TDist(**kw),
             TDyn(**dkw)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seq=SEQ, seed=0):
    from repro.data.loader import DataConfig, make_loader
    return next(make_loader(cfg, DataConfig(M_, B_, seq, seed=seed)))


def _dyn(jcfg, jd, jdyn):
    from repro.models import model as JM
    dyn = _np(JM.init_dyn(jcfg, jd, jdyn))
    dyn["ff_mask"] = dyn["ff_mask"].copy()
    dyn["ff_mask"][0, 0, 1] = 0.0          # a pruned block
    dyn["ff_mask"][-1, 1, 0] = 0.0
    return dyn


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _assert_grads(got, want, rel=1e-5):
    want = dict(_leaves(want))
    got = dict(_leaves(got))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, k
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, (k, err, scale)


def _port_value_and_grad(tcfg, td, tdyn, params, assign, dyn, batch,
                         hash_proj=None):
    shapes = TP.PipelineShapes(M_, B_, batch["tokens"].shape[-1])
    loss_fn = TP.build_loss_fn(tcfg, td, tdyn, shapes, hash_proj=hash_proj)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return TP.value_and_grad(loss_fn, params, assign, dyn, tb)


def test_loader_batches_are_bit_identical():
    from repro.configs import get_config
    from repro.data.loader import DataConfig, make_loader
    from repro_torch.data.loader import DataConfig as TDC
    from repro_torch.data.loader import make_loader as tmake
    cfg = get_config("smollm-360m")
    ref = make_loader(cfg, DataConfig(4, 2, 1024, seed=3))
    got = tmake(tget("smollm-360m"), TDC(4, 2, 1024, seed=3))
    for _ in range(3):
        a, b = next(ref), next(got)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("kind", ["pruning", "freezing", "sparse_attention"])
def test_loss_and_grads_match_reference_one_stage(kind):
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as JM
    from repro.pipeline.pipeline import PipelineShapes, build_loss_fn
    (jcfg, jd, jdyn), (tcfg, td, tdyn) = _worlds(1, kind)
    seq = 256 if kind == "sparse_attention" else SEQ
    params = _np(JM.init_params(jax.random.PRNGKey(1), jcfg, jd))
    assign = _np(JM.make_assignment(jcfg, jd))
    dyn = _dyn(jcfg, jd, jdyn)
    if kind == "freezing":
        dyn["frozen"] = dyn["frozen"].copy()
        dyn["frozen"][0, 1] = 1.0
    batch = _batch(jcfg, seq)
    loss_fn = build_loss_fn(jcfg, jd, jdyn, make_host_mesh(data=1, model=1),
                            PipelineShapes(M_, B_, seq))
    (jl, jstats), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, assign, dyn, batch)
    proj = None
    if kind == "sparse_attention":
        from repro_torch.models.blocks import hash_bits
        proj = torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(17), (64, hash_bits(8)), jnp.float32)))
    tl, tstats, tg = _port_value_and_grad(
        tcfg, td, tdyn, convert.to_torch(params, "cpu"),
        convert.to_torch(assign, "cpu"), convert.to_torch(dyn, "cpu"),
        batch, hash_proj=proj)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_grads(tg, _np(jg))
    for k in ("ff_active", "attn_density"):
        # the reference's shard_map flattens [S, L_max] to [S * L_max]
        np.testing.assert_allclose(
            tstats[k].numpy(),
            np.asarray(jstats[k]).reshape(tstats[k].shape), rtol=1e-6)
    if kind == "freezing":                       # frozen: no weight grad
        assert not tg["stages"]["wq"][0, 1].any()
    if kind == "sparse_attention":               # the hash mask was live
        assert float(np.asarray(jstats["attn_density"]).max()) < M_


def test_loss_and_grads_match_reference_two_stages(tmp_path):
    npz = os.path.join(str(tmp_path), "ref.npz")
    run_in_subprocess(f"""
import numpy as np
import jax
from repro.configs import DistConfig, get_config, reduced_config
from repro.data.loader import DataConfig, make_loader
from repro.dynamics.config import DynamicsConfig
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro.pipeline.pipeline import PipelineShapes, build_loss_fn

cfg = reduced_config(get_config("smollm-360m"), **{SMALL!r})
dcfg = DistConfig(num_stages=2, slot_slack=2, remat="none",
                  param_dtype="float32", kernel_impl="pallas")
dyncfg = DynamicsConfig(kind="pruning")
params = JM.init_params(jax.random.PRNGKey(2), cfg, dcfg)
assign = JM.make_assignment(cfg, dcfg, [1, 3])
dyn = jax.tree.map(np.asarray, JM.init_dyn(cfg, dcfg, dyncfg))
dyn["ff_mask"] = dyn["ff_mask"].copy()
dyn["ff_mask"][1, 2, 0] = 0.0
batch = next(make_loader(cfg, DataConfig({M_}, {B_}, {SEQ}, seed=1)))
loss_fn = build_loss_fn(cfg, dcfg, dyncfg, make_host_mesh(data=1, model=2),
                        PipelineShapes({M_}, {B_}, {SEQ}))
(loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
    params, assign, dyn, batch)
flat = {{"loss": np.asarray(loss)}}

def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        flat[prefix] = np.asarray(jax.device_get(tree))

for name, tree in (("params", params), ("grads", grads), ("dyn", dyn),
                   ("assign", assign), ("batch", batch), ("stats", stats)):
    put(name, tree)
np.savez({npz!r}, **flat)
""", devices=2)
    tree = {"params": {"shared": {}}, "grads": {"shared": {}}}
    with np.load(npz) as z:
        for key in z.files:
            node = tree
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    _, (tcfg, td, tdyn) = _worlds(2)
    tl, tstats, tg = _port_value_and_grad(
        tcfg, td, tdyn, convert.to_torch(tree["params"], "cpu"),
        convert.to_torch(tree["assign"], "cpu"),
        convert.to_torch(tree["dyn"], "cpu"), tree["batch"])
    np.testing.assert_allclose(float(tl), float(tree["loss"]), rtol=1e-5)
    _assert_grads(tg, tree["grads"])
    np.testing.assert_allclose(
        tstats["ff_active"].numpy(),
        tree["stats"]["ff_active"].reshape(tstats["ff_active"].shape),
        rtol=1e-6)


def test_reference_loss_matches_reference_and_pipeline():
    from repro.models import model as JM
    (jcfg, jd, jdyn), (tcfg, td, tdyn) = _worlds(2)
    params = _np(JM.init_params(jax.random.PRNGKey(4), jcfg, jd))
    assign = _np(JM.make_assignment(jcfg, jd, [3, 1]))
    dyn = _dyn(jcfg, jd, jdyn)
    batch = _batch(jcfg, seed=2)
    tok, lab = batch["tokens"][0], batch["labels"][0]
    want = JM.reference_loss(jcfg, jd, jdyn, params, assign, dyn, tok, lab)
    tp, ta, tdy = (convert.to_torch(t, "cpu") for t in (params, assign, dyn))
    got = TM.reference_loss(tcfg, td, tdyn, tp, ta, tdy,
                            torch.from_numpy(tok), torch.from_numpy(lab))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the pipelined loss over both microbatches == the mean of the
    # unpipelined one over the same tokens
    loss_fn = TP.build_loss_fn(tcfg, td, tdyn, TP.PipelineShapes(M_, B_, SEQ))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pipe, _ = loss_fn(tp, ta, tdy, tb)
    flat = TM.reference_loss(tcfg, td, tdyn, tp, ta, tdy,
                             tb["tokens"].reshape(-1, SEQ),
                             tb["labels"].reshape(-1, SEQ))
    np.testing.assert_allclose(float(pipe), float(flat), rtol=1e-5)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_match_reference_over_three_updates(name):
    from repro.optim.optimizers import OptConfig, make_optimizer
    from repro_torch.optim import optimizers as TO
    rng = np.random.RandomState(7)
    shapes = {"embed": (256, 128), "final_norm": (128,),
              "stages": {"w": (2, 3, 128, 256), "norm": (2, 3, 128)},
              "shared": {}}

    def draw(sc):
        def go(t):
            if isinstance(t, dict):
                return {k: go(v) for k, v in t.items()}
            return (rng.randn(*t) * sc).astype(np.float32)
        return go(shapes)

    params = draw(0.5)
    frozen = np.array([[0, 1, 0], [0, 0, 1]], np.float32)
    jinit, jupd = make_optimizer(OptConfig(name=name))
    tinit, tupd = TO.make_optimizer(TO.OptConfig(name=name))
    jp, tp = params, convert.to_torch(params, "cpu")
    js, ts = jinit(jp), tinit(tp)
    for i, lr in enumerate((1e-3, 3e-4, 1e-4)):
        g = draw(0.3 if i != 1 else 1e-3)          # clipped, then tiny
        jp, js, jn = jupd(g, js, jp, jnp.float32(lr), frozen=frozen)
        tp, ts, tn = tupd(convert.to_torch(g, "cpu"), ts, tp, lr,
                          frozen=torch.from_numpy(frozen))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for (k, a), (k2, b) in zip(_leaves(_np(js)), _leaves(ts)):
            assert k == k2
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        for (k, a), (_, b) in zip(_leaves(_np(jp)), _leaves(tp)):
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6,
                                       err_msg=k)
    # frozen slots never moved, not even by weight decay
    w0 = torch.from_numpy(params["stages"]["w"])
    assert torch.equal(tp["stages"]["w"][0, 1], w0[0, 1])


def test_global_block_prune_masks_are_equal():
    from repro.dynamics import pruning as jprn
    from repro.models import model as JM
    from repro_torch.dynamics import pruning as tprn
    from repro.configs import DistConfig, get_config, reduced_config
    for seed, layers, dff in ((0, 8, 512), (1, 6, 256)):
        cfg = reduced_config(get_config("smollm-360m"), num_layers=layers,
                             d_model=64, d_ff=dff, vocab_size=256)
        dcfg = DistConfig(num_stages=2, slot_slack=2, param_dtype="float32")
        params = _np(JM.init_params(jax.random.PRNGKey(seed), cfg, dcfg))
        tags = np.asarray(JM.make_assignment(cfg, dcfg)["tags"])
        tcfg = treduce(tget("smollm-360m"), num_layers=layers, d_model=64,
                       d_ff=dff, vocab_size=256)
        tp = convert.to_torch(params["stages"], "cpu")
        for sp in (0.3, 0.867):
            keep = jprn.target_keep_blocks(cfg, cfg.total_blocks(), sp)
            assert keep == tprn.target_keep_blocks(tcfg, layers, sp)
            want = np.asarray(jprn.global_block_prune(
                cfg, params["stages"], jnp.asarray(tags), keep))
            got = tprn.global_block_prune(
                tcfg, tp, torch.from_numpy(tags.copy()), keep).numpy()
            assert np.array_equal(got, want), (seed, sp)
            np.testing.assert_allclose(
                tprn.block_magnitudes(tcfg, tp).numpy(),
                np.asarray(jprn.block_magnitudes(cfg, params["stages"])),
                rtol=1e-6)


def _controllers(layers, stages, method):
    from repro.cluster.service import ControlPlane
    from repro.configs import DistConfig, get_config, reduced_config
    from repro.core.controller import ControllerConfig, DynMoController
    from repro.dynamics.config import DynamicsConfig
    from repro.runtime.fault_tolerance import StragglerDetector
    from repro_torch.cluster.service import ControlPlane as TCP
    from repro_torch.core import controller as TC
    from repro_torch.runtime.fault_tolerance import StragglerDetector as TSD
    kw = dict(num_layers=layers, d_model=64, d_ff=256, vocab_size=256)
    cfg = reduced_config(get_config("smollm-360m"), **kw)
    dcfg = DistConfig(num_stages=stages, slot_slack=2,
                      param_dtype="float32")
    jc = ControlPlane(DynMoController(
        cfg, dcfg, DynamicsConfig(kind="pruning"),
        ControllerConfig(method=method, rebalance_every=1),
        straggler=StragglerDetector(stages)), async_mode=False)
    tcfg = treduce(tget("smollm-360m"), **kw)
    td = TDist(num_stages=stages, slot_slack=2, param_dtype="float32")
    tc = TCP(TC.DynMoController(
        tcfg, td, TDyn(kind="pruning"),
        TC.ControllerConfig(method=method, rebalance_every=1),
        straggler=TSD(stages)))
    return (cfg, dcfg), (tcfg, td), jc, tc


@pytest.mark.parametrize("method", ["diffusion", "partition"])
def test_controller_decides_and_migrates_like_reference(method):
    from repro.cluster.service import StatsSnapshot
    from repro.models import model as JM
    from repro_torch.cluster.service import StatsSnapshot as TSnap
    (cfg, dcfg), (tcfg, td), jc, tc = _controllers(12, 3, method)
    rng = np.random.RandomState(0)
    params = _np(JM.init_params(jax.random.PRNGKey(5), cfg, dcfg))
    dyn = _np(JM.init_dyn(cfg, dcfg, jc.ctrl.dyncfg))
    opt = {"m": params, "v": params, "count": np.int32(3)}
    jstate = (params, opt, dyn)
    tstate = tuple(convert.to_torch(t, "cpu") for t in jstate)
    assign = _np(JM.make_assignment(cfg, dcfg))
    moved = 0
    for it in range(1, 6):
        tags = np.asarray(assign["tags"])
        stats = {"ff_active": np.where(tags != 0, 4 * rng.uniform(
                     0.1, 1.0, tags.shape), 0.0).astype(np.float32),
                 "attn_density": np.where(tags != 0, 4.0, 0.0)
                 .astype(np.float32)}
        times = rng.uniform(0.5, 2.0, 3)
        times[it % 3] *= 3.0                      # a straggler that moves
        snap = dict(iteration=it, epoch=0, stats=stats, tags=tags,
                    num_micro=4, tokens=8192, seq=1024,
                    frozen=np.zeros(tags.shape, np.float32),
                    stage_times=times)
        jc.publish(StatsSnapshot(**snap))
        tc.publish(TSnap(**snap))
        jplan, tplan = jc.poll(0), tc.poll(0)
        assert jplan.new_lps == tplan.new_lps
        je, te = jplan.event, tplan.event
        assert (je.rebalanced, je.moved_layers) == (te.rebalanced,
                                                    te.moved_layers)
        np.testing.assert_allclose(te.imbalance_before, je.imbalance_before,
                                   rtol=1e-12)
        if jplan.new_lps is None:
            continue
        moved += je.moved_layers
        jp, jo, jd, ja, _ = jc.apply(jplan, *jstate)
        tp, to, tdy, ta, _ = tc.apply(tplan, *tstate)
        for (k, a), (k2, b) in zip(_leaves(_np({"p": jp, "o": jo, "d": jd,
                                                 "a": ja})),
                                   _leaves({"p": tp, "o": to, "d": tdy,
                                            "a": ta})):
            assert k == k2
            assert np.array_equal(np.asarray(b), a), k     # bitwise
        jstate, tstate, assign = (jp, jo, jd), (tp, to, tdy), _np(ja)
    assert moved > 0
    assert jc.ctrl.lps == tc.ctrl.lps


def test_migration_preserves_loss():
    """Rebalance + migrate: the reference loss is unchanged (the paper's
    'no impact on model accuracy'; mirrors test_controller.py)."""
    from repro_torch.core.controller import ControllerConfig, DynMoController
    from repro_torch.core.profiler import LayerProfile
    tcfg = treduce(tget("smollm-360m"), num_layers=8, d_model=64, d_ff=256,
                   vocab_size=256)
    td = TDist(num_stages=4, slot_slack=2, param_dtype="float32",
               kernel_impl="pallas")
    tdyn = TDyn(kind="pruning")
    params = TM.init_params(torch.Generator().manual_seed(0), tcfg, td)
    assign = TM.make_assignment(tcfg, td)
    dyn = TM.init_dyn(tcfg, td, tdyn)
    dyn["ff_mask"][1, 0, 1] = 0.0
    tok = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 40)))
    before = TM.reference_loss(tcfg, td, tdyn, params, assign, dyn, tok, tok)
    ctrl = DynMoController(tcfg, td, tdyn, ControllerConfig(
        method="partition", rebalance_every=1))
    L = tcfg.total_blocks()
    times = np.concatenate([np.full(L - 2, 0.1), np.full(2, 2.0)])
    new_lps, _ = ctrl.decide(LayerProfile(times, np.full(L, 1e6),
                                          np.zeros(4), [None] * L), 1)
    assert new_lps is not None and new_lps != [2, 2, 2, 2]
    p2, _, d2, a2, _ = ctrl.apply(new_lps, params, None, dyn)
    after = TM.reference_loss(tcfg, td, tdyn, p2, a2, d2, tok, tok)
    assert abs(float(before) - float(after)) < 1e-5
    # PAD destinations hold zeros
    pad = a2["tags"] == 0
    assert not p2["stages"]["wq"][pad].any()
