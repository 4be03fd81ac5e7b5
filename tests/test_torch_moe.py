"""The port's MoE slice against the JAX package's, module by module.

* The grouped matmul (K4) and its weight gradient (K5): the plain versions
  (the CPU path of ``repro_torch.kernels.grouped_matmul``) against the
  reference's ``grouped_matmul_ref`` and its Pallas kernels in interpret
  mode (``grouped_matmul``, ``grouped_matmul_bwd_p``,
  ``grouped_matmul_dw_p``) on the ragged cases of ``test_moe_grouped.py``
  (empty groups, one group taking all, counts off the row tile, garbage in
  dead rows), forward and gradients, with and without an expert placement.
* ``moe_ffn``: the port's "scan" and "pallas" impls against the
  reference's on the same numpy inputs, with tight capacity (real drops)
  and at s = 1 (decode): y within 1e-5, load and dropped exact, aux within
  1e-6, every gradient (the router's through aux too) within 2e-4; inside
  the port, routing is shared (load / aux / dropped equal across impls) and
  any placement gives the same y, load, dropped and weight gradients
  bitwise.
* ``expert_layout`` and the controller's re-layout decision against the
  reference's.
The inputs come from numpy with fixed seeds; top-k ties between torch and
jax would order differently, and these seeds give no ties (checked).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.kernels.grouped_matmul import (grouped_matmul,  # noqa: E402
                                          grouped_matmul_bwd_p,
                                          grouped_matmul_dw_p,
                                          grouped_matmul_ref)
from repro.models.blocks import moe_ffn  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduce  # noqa: E402
from repro_torch.kernels import grouped_matmul as TG  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402

torch.set_num_threads(1)

# the reference's kernel cases (tests/test_moe_grouped.py): G=8 groups over
# E=4 experts, cap 20 (not a multiple of the 8-row tile), K 96, N 72
CASES = {
    "uniform": [10, 10, 10, 10, 10, 10, 10, 10],
    "empty_experts": [20, 0, 7, 0, 0, 13, 0, 0],
    "one_takes_all": [20, 0, 0, 0, 20, 0, 0, 0],
    "all_empty": [0, 0, 0, 0, 0, 0, 0, 0],
    "ragged": [1, 19, 3, 8, 20, 0, 5, 2],
}
PERM = [2, 0, 3, 1]        # logical expert -> physical group


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_matmul_plain_matches_reference(case):
    rng = np.random.RandomState(0)
    G, cap, K, N, E = 8, 20, 96, 72, 4
    x = (rng.randn(G, cap, K) * 0.3).astype(np.float32)
    w = (rng.randn(E, K, N) * 0.3).astype(np.float32)
    cot = (rng.randn(G, cap, N) * 0.3).astype(np.float32)
    counts = np.asarray(CASES[case], np.int32)
    live = np.arange(cap)[None, :] < counts[:, None]
    garbage = x + (~live[..., None]) * np.float32(1e6)

    # forward: the plain version == the reference's oracle and its kernel
    want = np.asarray(grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(counts), interpret=True))
    np.testing.assert_allclose(np.asarray(grouped_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(counts))), want,
        rtol=1e-5, atol=1e-5)
    got = TG.grouped_matmul(t(garbage), t(w), t(counts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[~live] == 0.0)
    np.testing.assert_allclose(TG.grouped_matmul_ref(t(x), t(w),
                                                     t(counts)).numpy(),
                               want, rtol=1e-5, atol=1e-5)

    # gradients through the autograd Function == jax.grad of the kernel
    def jloss(xx, ww):
        return jnp.sum(grouped_matmul(xx, ww, jnp.asarray(counts),
                                      interpret=True) * cot)
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(w))
    tx, tw = t(x).requires_grad_(True), t(w).requires_grad_(True)
    (TG.grouped_matmul(tx, tw, t(counts)) * t(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-4,
                               atol=1e-5, err_msg="dx")
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-4,
                               atol=1e-5, err_msg="dw")

    # a placement is folded into the weight index: group p of batch row b
    # runs the logical expert placed on p
    inv = np.argsort(PERM)
    want_p = np.asarray(grouped_matmul_ref(
        jnp.asarray(x), jnp.asarray(w[inv]), jnp.asarray(counts)))
    got_p = TG.grouped_matmul(t(x), t(w), t(counts),
                              expert_map=t(np.float32(PERM))).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-5)

    # the flat backward at the kernels' padded shapes (cap 24 = 3 x 8
    # rows, K / N one 128 tile), garbage in the dead rows of x and g
    cap2, K2, N2 = 24, 128, 128
    x2 = (rng.randn(G * cap2, K2) * 0.3).astype(np.float32)
    w2 = (rng.randn(E, K2, N2) * 0.3).astype(np.float32)
    g2 = (rng.randn(G * cap2, N2) * 0.3).astype(np.float32)
    dead = ~(np.arange(G * cap2) % cap2
             < np.repeat(np.minimum(counts, cap2), cap2))
    x2[dead] += 1e6
    g2[dead] += 1e6
    jdx2, jdw2 = grouped_matmul_bwd_p(
        jnp.asarray(np.where(dead[:, None], 0, x2)), jnp.asarray(w2),
        jnp.asarray(counts), jnp.asarray(g2), gpb=3, bm=8, bn=128, bk=128,
        interpret=True)
    tdx2, tdw2 = TG.grouped_matmul_bwd(t(x2), t(w2), t(counts), t(g2),
                                       cap=cap2)
    np.testing.assert_allclose(tdx2.numpy(), np.asarray(jdx2), rtol=1e-4,
                               atol=1e-5, err_msg="flat dx")
    np.testing.assert_allclose(tdw2.numpy(), np.asarray(jdw2), rtol=1e-4,
                               atol=1e-5, err_msg="flat dw")
    # K5 alone: garbage in dead rows of x and g is read as zero
    jdw3 = grouped_matmul_dw_p(
        jnp.asarray(np.where(dead[:, None], 0, x2)),
        jnp.asarray(np.where(dead[:, None], 0, g2)), jnp.asarray(counts),
        num_experts=E, gpb=3, bm=8, bn=128, bk=128, interpret=True)
    tdw3 = TG.grouped_matmul_dw_ref(t(x2).reshape(G, cap2, K2),
                                    t(g2).reshape(G, cap2, N2), t(counts), E)
    np.testing.assert_allclose(tdw3.numpy(), np.asarray(jdw3), rtol=1e-4,
                               atol=1e-5, err_msg="K5")
    # with a placement, K5's output stays in logical-expert order
    tdw4 = TG.grouped_product_dw(t(x2), t(g2), t(counts), cap2, E,
                                 gmap=t(np.int32(PERM)))
    np.testing.assert_array_equal(tdw4.numpy(), tdw3.numpy()[PERM])


def test_tile_work_matches_reference():
    from repro.kernels.grouped_matmul import grouped_tile_work
    for counts in CASES.values():
        for cap in (20, 320, 4):
            assert (TG.grouped_tile_work(counts, cap)
                    == grouped_tile_work(counts, cap))


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------
def _cfgs(capacity_factor):
    jcfg = dataclasses.replace(
        reduced_config(get_config("mixtral-8x7b"), num_layers=4, d_model=64,
                       d_ff=128), moe_capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(
        treduce(tget("mixtral-8x7b"), num_layers=4, d_model=64, d_ff=128),
        moe_capacity_factor=capacity_factor)
    return jcfg, tcfg


def _params(rng, E, d, ff):
    return {"router": (rng.randn(d, E) * 0.4).astype(np.float32),
            "ewi": (rng.randn(E, d, ff) * 0.2).astype(np.float32),
            "ewg": (rng.randn(E, d, ff) * 0.2).astype(np.float32),
            "ewo": (rng.randn(E, ff, d) * 0.2).astype(np.float32)}


# (label, capacity factor, b, s, seed): tight capacity drops pairs; s = 1
# is the decode shape
FFN_CASES = [("tight", 1.0, 2, 32, 2), ("decode", 4.0, 4, 1, 3)]


def _ffn_inputs(cf, b, s, seed):
    jcfg, tcfg = _cfgs(cf)
    rng = np.random.RandomState(seed)
    p = _params(rng, jcfg.num_experts, jcfg.d_model, jcfg.d_ff)
    x = (rng.randn(b, s, jcfg.d_model) * 0.5).astype(np.float32)
    # no top-k ties: torch and jax may order ties differently
    logits = x.reshape(-1, x.shape[-1]) @ p["router"]
    top = np.sort(logits, axis=-1)[:, ::-1]
    assert np.min(top[:, 1] - top[:, 2]) > 1e-5
    return jcfg, tcfg, p, x


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("label,cf,b,s,seed", FFN_CASES)
def test_moe_ffn_matches_reference(impl, label, cf, b, s, seed):
    jcfg, tcfg, p, x = _ffn_inputs(cf, b, s, seed)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: t(v).requires_grad_(True) for k, v in p.items()}
    jy, jload, jaux, jdrop = moe_ffn(jp, jnp.asarray(x), jcfg,
                                     kernel_impl=impl)
    tx = t(x).requires_grad_(True)
    ty, tload, taux, tdrop = TB.moe_ffn(tp, tx, tcfg, kernel_impl=impl)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tload.numpy(), np.asarray(jload))
    assert float(tdrop) == float(jdrop)
    assert abs(float(taux.detach()) - float(jaux)) <= 1e-6
    if label == "tight":
        assert float(tdrop) > 0.0          # the tight capacity drops

    def total(pp, xx):
        y, _, aux, _ = moe_ffn(pp, xx, jcfg, kernel_impl=impl)
        return jnp.sum(y ** 2) + aux       # router grads via aux too

    jg, jgx = jax.grad(total, argnums=(0, 1))(jp, jnp.asarray(x))
    ((ty ** 2).sum() + taux).backward()
    for k in sorted(p):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=2e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=2e-4,
                               atol=1e-5, err_msg="x")


@pytest.mark.parametrize("label,cf,b,s,seed", FFN_CASES)
def test_moe_ffn_routing_shared_and_placement_bit_neutral(label, cf, b, s,
                                                          seed):
    _, tcfg, p, x = _ffn_inputs(cf, b, s, seed)
    outs = {}
    for impl in ("scan", "pallas"):
        outs[impl] = TB.moe_ffn({k: t(v) for k, v in p.items()}, t(x), tcfg,
                                kernel_impl=impl)
    for i in (1, 2, 3):      # load, aux, dropped: equal across impls
        assert torch.equal(outs["scan"][i], outs["pallas"][i])

    def run(em):
        tp = {k: t(v).requires_grad_(True) for k, v in p.items()}
        y, load, aux, drop = TB.moe_ffn(tp, t(x), tcfg, kernel_impl="pallas",
                                        expert_map=em)
        ((y ** 2).sum() + aux).backward()
        return y.detach(), load, drop, {k: v.grad for k, v in tp.items()}

    base = run(None)
    for perm in ([0, 1, 2, 3], [1, 0, 3, 2], [3, 2, 1, 0], PERM):
        got = run(t(np.float32(perm)))
        assert torch.equal(got[0], base[0]), perm
        assert torch.equal(got[1], base[1]) and torch.equal(got[2], base[2])
        for k in p:
            assert torch.equal(got[3][k], base[3][k]), (perm, k)


# ---------------------------------------------------------------------------
# expert layout and the controller's re-layout decision
# ---------------------------------------------------------------------------
def test_expert_layout_matches_reference():
    from repro.core import expert_layout as jel
    from repro_torch.core import expert_layout as tel
    loads = ([100, 2, 3, 1], [10, 9, 11, 10], [5, 50, 0, 7], [0, 0, 0, 0],
             [3, 3, 40, 40])
    for load in loads:
        for wm, mt in ((2.0, 16), (1.01, 1), (1.5, 1000)):
            for cur in ((0, 1, 2, 3), (2, 0, 3, 1)):
                jp = jel.build_relayout(load, jel.ExpertLayout(
                    cur, (1.0,) * 4), watermark=wm, min_tokens=mt,
                    iteration=3)
                tp = tel.build_relayout(load, tel.ExpertLayout(
                    cur, (1.0,) * 4), watermark=wm, min_tokens=mt,
                    iteration=3)
                assert (jp is None) == (tp is None)
                if jp is not None:
                    assert tp.new.placement == jp.new.placement
                    assert tp.new.capacity_weights == jp.new.capacity_weights
                    assert (tp.skew, tp.total_tokens, tp.moved_experts) == (
                        jp.skew, jp.total_tokens, jp.moved_experts)
        assert tel.measure_skew(load) == jel.measure_skew(load)
    rng = np.random.RandomState(5)
    old = tel.ExpertLayout.identity(4)
    new = tel.ExpertLayout((2, 0, 3, 1), (1.0,) * 4)
    tplan = tel.as_migration_plan(old, new)
    jplan = jel.as_migration_plan(jel.ExpertLayout.identity(4),
                                  jel.ExpertLayout((2, 0, 3, 1), (1.0,) * 4))
    for f in ("src_stage", "src_slot", "valid"):
        np.testing.assert_array_equal(getattr(tplan, f), getattr(jplan, f))
    assert tplan.moved_layers == jplan.moved_layers
    tree = {"a": (rng.randn(4, 3, 5)).astype(np.float32),
            "b": (rng.randn(4)).astype(np.float32)}
    want = jel.apply_expert_plan({k: jnp.asarray(v) for k, v in tree.items()},
                                 jplan)
    got = tel.apply_expert_plan({k: t(v) for k, v in tree.items()}, tplan)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = tel.apply_expert_plan(got, tel.as_migration_plan(new, old))
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), tree[k])


def test_controller_relayout_decision_matches_reference():
    from repro.configs import DistConfig
    from repro.core.controller import ControllerConfig, DynMoController
    from repro.core.cost_model import LayerDynState
    from repro.core.profiler import LayerProfile
    from repro.dynamics.config import DynamicsConfig
    from repro_torch.configs import DistConfig as TDist
    from repro_torch.core import controller as TC
    from repro_torch.core.cost_model import LayerDynState as TLDS
    from repro_torch.core.profiler import LayerProfile as TLP
    from repro_torch.dynamics.config import DynamicsConfig as TDyn
    jcfg, tcfg = _cfgs(1.25)
    kw = dict(method="partition", rebalance_every=1, expert_relayout=True,
              expert_watermark=1.5, expert_min_tokens=8)
    jc = DynMoController(jcfg, DistConfig(num_stages=2, slot_slack=2),
                         DynamicsConfig(kind="moe"), ControllerConfig(**kw))
    tc = TC.DynMoController(tcfg, TDist(num_stages=2, slot_slack=2),
                            TDyn(kind="moe"), TC.ControllerConfig(**kw))
    assert tc.expert_layout.placement == jc.expert_layout.placement
    L = jcfg.total_blocks()
    for it, (load, drop) in enumerate((([100.0, 2.0, 3.0, 1.0], 0.125),
                                       ([26.0, 27.0, 26.0, 27.0], 0.0),
                                       ([1.0, 90.0, 4.0, 5.0], 0.25)), 5):
        common = dict(time_per_layer=np.ones(L), param_bytes=np.ones(L),
                      mem_per_stage=np.zeros(2),
                      expert_load=np.asarray(load), moe_drop_frac=drop)
        _, jev = jc.decide(LayerProfile(
            dyn_states=[LayerDynState() for _ in range(L)], **common), it)
        _, tev = tc.decide(TLP(dyn_states=[TLDS() for _ in range(L)],
                               **common), it)
        assert (tev.relayout, tev.expert_skew, tev.expert_dropped) == (
            jev.relayout, jev.expert_skew, jev.expert_dropped)
        jplan, tplan = jc.take_expert_relayout(), tc.take_expert_relayout()
        assert (jplan is None) == (tplan is None)
        assert tc.take_expert_relayout() is None
        if jplan is not None:
            assert tplan.new.placement == jplan.new.placement
            # the layout advances only at commit (the safe point)
            assert tc.expert_layout.placement == tplan.old.placement
            jc.commit_relayout(jplan)
            tc.commit_relayout(tplan)
            assert tc.expert_layout.placement == tplan.new.placement
    assert len(tc.relayouts) == len(jc.relayouts) == 2


def test_profiler_and_cost_model_match_reference_on_moe_stats():
    """The per-slot stats of a real MoE loss (the port's pipelined loss on
    reduced Mixtral, tight capacity so pairs drop) fold into the same
    per-layer profile in both packages: expert load, drop fraction, the
    cost model's hottest-expert term and the layer times."""
    from repro.core.profiler import profile_from_stats
    from repro_torch.configs import DistConfig as TDist
    from repro_torch.core.profiler import profile_from_stats as tprofile
    from repro_torch.dynamics.config import DynamicsConfig as TDyn
    from repro_torch.models import model as TM
    from repro_torch.pipeline import pipeline as TP
    jcfg, tcfg = _cfgs(1.0)
    dcfg = TDist(num_stages=2, slot_slack=2, param_dtype="float32",
                 kernel_impl="pallas")
    dyncfg = TDyn(kind="moe")
    params = TM.init_params(torch.Generator().manual_seed(1), tcfg, dcfg)
    rng = np.random.RandomState(6)
    m, B, seq = 2, 2, 32
    batch = {"tokens": t(rng.randint(0, 256, (m, B, seq))),
             "labels": t(rng.randint(0, 256, (m, B, seq))),
             "label_mask": torch.ones((m, B, seq))}
    assign = TM.make_assignment(tcfg, dcfg)
    loss_fn = TP.build_loss_fn(tcfg, dcfg, dyncfg,
                               TP.PipelineShapes(m, B, seq))
    with torch.no_grad():
        _, stats = loss_fn(params, assign, TM.init_dyn(tcfg, dcfg, dyncfg),
                           batch)
    stats = {k: v.numpy() for k, v in stats.items()}
    tags = assign["tags"].numpy()
    tokens = m * B * seq
    assert stats["moe_dropped"].sum() > 0
    want = profile_from_stats(jcfg, stats, tags, m, tokens, seq,
                              bytes_per_param=4.0)
    got = tprofile(tcfg, stats, tags, m, tokens, seq, bytes_per_param=4.0)
    np.testing.assert_array_equal(got.expert_load, want.expert_load)
    assert got.moe_drop_frac == want.moe_drop_frac > 0
    assert ([d.expert_hot for d in got.dyn_states]
            == [d.expert_hot for d in want.dyn_states])
    assert max(d.expert_hot for d in got.dyn_states) > 1.0
    np.testing.assert_allclose(got.time_per_layer, want.time_per_layer,
                               rtol=1e-12)
    np.testing.assert_allclose(got.param_bytes, want.param_bytes,
                               rtol=1e-12)
    np.testing.assert_allclose(got.mem_per_stage, want.mem_per_stage,
                               rtol=1e-12)
