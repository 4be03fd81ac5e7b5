"""The Mamba2 family (zamba2) in the port, against the JAX package.

* ``ssd_chunked`` (a sequence off the chunk, with and without an incoming
  state) against ``ssd_decode_step`` unrolled over the same tokens in the
  port, and both against the reference's; ``causal_conv`` whole and
  streamed token by token; gradients through ``_segsum``'s masked
  exponentials are finite.
* An S = 2 pipelined train step of reduced zamba2 (MAMBA and HYBRID_ATTN
  slots on both stage buffers, the shared attention block in
  ``params["shared"]``): loss and every gradient leaf, the shared params'
  included, against the reference's in a 2-device subprocess.
* Serving: ``ElasticServer`` with contiguous caches (the k/v lines and the
  conv / SSM state) token-identical to the reference's at temperature 0.
* A migration (``core.migration.migrate``) and an elastic resize 2 -> 1 ->
  2 of the zamba2 state are bitwise the unmoved run: the loss after each
  equals the unmoved loss, and the round trip returns every leaf.
* Across 2 ranks (one process per stage, gloo): the S = 2 train step's
  loss and every gradient (the shared ``ga_*`` ones, summed over the
  stages in order) bitwise the one-process step's; training with a
  migration that moves MAMBA and HYBRID_ATTN rows across the ranks, and a
  resume from its rank-written safe point (``ga_*`` and their moments in
  ``common.npz``), bitwise the one-process run.
Both sides run ``kernel_impl="pallas"``.  Tolerances: the unit functions
1e-5 (fp32, summation order differs); the train step 1e-5 relative on the
loss and 1e-5 of each gradient leaf's largest entry.
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
from repro_torch.configs import BLOCK_HYBRID_ATTN, BLOCK_MAMBA  # noqa: E402
from repro_torch.configs import DistConfig as TDist  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduce  # noqa: E402
from repro_torch.dynamics.config import DynamicsConfig as TDyn  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.pipeline import pipeline as TP  # noqa: E402
from test_torch_train import _assert_grads, _leaves  # noqa: E402

torch.set_num_threads(1)
SMALL = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=256)
M_, B_, SEQ = 2, 2, 40


def _ssd_inputs(rng, b=2, s=37, nh=3, dh=8, st=5):
    x = rng.randn(b, s, nh, dh).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, nh))).astype(np.float32)
    A_log = np.log(np.linspace(1.0, 4.0, nh)).astype(np.float32)
    B = rng.randn(b, s, st).astype(np.float32)
    C = rng.randn(b, s, st).astype(np.float32)
    D = rng.randn(nh).astype(np.float32)
    init = rng.randn(b, nh, dh, st).astype(np.float32) * 0.3
    return x, dt, A_log, B, C, D, init


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_decode_steps_and_reference(with_init):
    from repro.models import mamba as jmamba
    rng = np.random.RandomState(0)
    x, dt, A_log, B, C, D, init = _ssd_inputs(rng)
    init = init if with_init else None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    y, S = tmamba.ssd_chunked(t(x), t(dt), t(A_log), t(B), t(C), t(D),
                              chunk=8, init_state=t(init))
    jy, jS = jmamba.ssd_chunked(*(jnp.asarray(a) for a in
                                  (x, dt, A_log, B, C, D)), chunk=8,
                                init_state=None if init is None
                                else jnp.asarray(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-5,
                               atol=1e-5)
    # the recurrent form, one token at a time, reaches the same outputs
    state = (torch.zeros_like(S) if init is None else t(init))
    ys = []
    for i in range(x.shape[1]):
        yi, state = tmamba.ssd_decode_step(
            t(x[:, i]), t(dt[:, i]), t(A_log), t(B[:, i]), t(C[:, i]),
            t(D), state)
        ys.append(yi)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(state.numpy(), S.numpy(), rtol=1e-4,
                               atol=1e-4)
    jyi, jstate = jmamba.ssd_decode_step(
        *(jnp.asarray(a) for a in (x[:, 0], dt[:, 0], A_log, B[:, 0],
                                   C[:, 0], D)),
        jnp.zeros(S.shape) if init is None else jnp.asarray(init))
    yi, si = tmamba.ssd_decode_step(
        t(x[:, 0]), t(dt[:, 0]), t(A_log), t(B[:, 0]), t(C[:, 0]), t(D),
        torch.zeros_like(S) if init is None else t(init))
    np.testing.assert_allclose(yi.numpy(), np.asarray(jyi), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(si.numpy(), np.asarray(jstate), rtol=1e-5,
                               atol=1e-6)


def test_ssd_gradients_are_finite():
    rng = np.random.RandomState(1)
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in _ssd_inputs(rng)[:6]]
    y, S = tmamba.ssd_chunked(*args, chunk=8)
    (y.square().sum() + S.sum()).backward()
    for a in args:
        assert torch.isfinite(a.grad).all()
        assert float(a.grad.abs().sum()) > 0


def test_causal_conv_streams_and_matches_reference():
    from repro.models import mamba as jmamba
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 6).astype(np.float32)
    w = rng.randn(4, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    out, st = tmamba.causal_conv(*map(torch.from_numpy, (x, w, b)))
    jout, jst = jmamba.causal_conv(*map(jnp.asarray, (x, w, b)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    state = torch.zeros(2, 3, 6)
    outs = []
    for i in range(9):
        o, state = tmamba.causal_conv(torch.from_numpy(x[:, i:i + 1]),
                                      torch.from_numpy(w),
                                      torch.from_numpy(b), state=state)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), out.numpy(),
                               rtol=1e-5, atol=1e-6)


def _load_npz(path):
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *keys, leaf = key.split("/")
            for k in keys:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return tree


SAVE = """
flat = {}

def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        flat[prefix] = np.asarray(jax.device_get(tree))
"""


def reference_two_stage_step(tmp_path, arch, shapes_kw, seq, extra=""):
    """value_and_grad of the reference's pipelined loss at S = 2 for the
    reduced ``arch`` (params from PRNGKey(2), the loader's batch with its
    modality inputs); returns the saved tree."""
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

cfg = reduced_config(get_config({arch!r}), **{SMALL!r})
dcfg = DistConfig(num_stages=2, slot_slack=2, remat="none",
                  param_dtype="float32", kernel_impl="pallas")
dyncfg = DynamicsConfig(kind="pruning")
params = JM.init_params(jax.random.PRNGKey(2), cfg, dcfg)
assign = JM.make_assignment(cfg, dcfg)
dyn = jax.tree.map(np.asarray, JM.init_dyn(cfg, dcfg, dyncfg))
{extra}
batch = next(make_loader(cfg, DataConfig({M_}, {B_}, {seq}, seed=1)))
loss_fn = build_loss_fn(cfg, dcfg, dyncfg, make_host_mesh(data=1, model=2),
                        PipelineShapes({M_}, {B_}, {seq}, **{shapes_kw!r}))
(loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
    params, assign, dyn, batch)
{SAVE}
put("loss", loss)
for name, tree in (("params", params), ("grads", grads), ("dyn", dyn),
                   ("assign", assign), ("batch", batch)):
    put(name, tree)
np.savez({npz!r}, **flat)
""", devices=2)
    tree = _load_npz(npz)
    for k in ("params", "grads"):
        tree[k].setdefault("shared", {})
    return tree


def port_step(arch, tree, shapes):
    tcfg = treduce(tget(arch), **SMALL)
    td = TDist(num_stages=2, slot_slack=2, remat="none",
               param_dtype="float32", kernel_impl="pallas")
    loss_fn = TP.build_loss_fn(tcfg, td, TDyn(kind="pruning"), shapes)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in
          tree["batch"].items()}
    return TP.value_and_grad(
        loss_fn, convert.to_torch(tree["params"], "cpu"),
        convert.to_torch(tree["assign"], "cpu"),
        convert.to_torch(tree["dyn"], "cpu"), tb)


def ranks_step(arch, tree, shapes):
    """``port_step`` as 2 ranks (``_dist_targets.family_step``): rank 0's
    loss and gradients, the stage rows gathered whole."""
    from repro_torch.launch.dist import launch
    tcfg = treduce(tget(arch), **SMALL)
    td = TDist(num_stages=2, slot_slack=2, remat="none",
               param_dtype="float32", kernel_impl="pallas")
    res = launch("_dist_targets:family_step", 2, device="cpu", kwargs=dict(
        cfg=tcfg, dcfg=td, dyncfg=TDyn(kind="pruning"), shapes=shapes,
        tree=tree))
    return res[0]["loss"], res[0]["grads"]


def assert_bitwise(got, want):
    got = dict(_leaves(got))
    for k, t in _leaves(want):
        assert torch.equal(got[k], t), k


@pytest.fixture(scope="module")
def zamba2_step(tmp_path_factory):
    """The reference's S = 2 train step of reduced zamba2."""
    return reference_two_stage_step(tmp_path_factory.mktemp("zamba2"),
                                    "zamba2-1.2b", {}, SEQ)


def test_zamba2_two_stage_train_step_matches_reference(zamba2_step):
    tree = zamba2_step
    tl, _, tg = port_step("zamba2-1.2b", tree,
                          TP.PipelineShapes(M_, B_, SEQ))
    np.testing.assert_allclose(float(tl), float(tree["loss"]), rtol=1e-5)
    _assert_grads(tg, tree["grads"])
    assert sorted(tg["shared"]) == ["ga_norm", "ga_wk", "ga_wo", "ga_wq",
                                    "ga_wv"]
    assert float(tg["shared"]["ga_wq"].abs().sum()) > 0
    for _, g in _leaves(tg):
        assert torch.isfinite(g).all()


def test_zamba2_step_over_two_ranks_is_bitwise_one_process(zamba2_step):
    shapes = TP.PipelineShapes(M_, B_, SEQ)
    tl, _, tg = port_step("zamba2-1.2b", zamba2_step, shapes)
    rl, rg = ranks_step("zamba2-1.2b", zamba2_step, shapes)
    assert float(rl) == float(tl)
    assert_bitwise(rg, tg)
    assert float(rg["shared"]["ga_wq"].abs().sum()) > 0
    _assert_grads(rg, zamba2_step["grads"])


ZAMBA_TRAIN = ["--arch", "zamba2-1.2b", "--layers", "12", "--d-model", "64",
               "--num-heads", "4", "--num-kv-heads", "2", "--d-ff", "256",
               "--vocab-size", "256", "--seq", "32", "--num-micro", "2",
               "--mb-global", "2", "--stages", "2", "--kernel-impl",
               "pallas", "--dynamism", "none", "--steps", "6",
               "--rebalance-every", "2", "--straggler", "1:3.0",
               "--log-every", "100"]


@pytest.fixture(scope="module")
def zamba2_ranks(tmp_path_factory):
    """ZAMBA_TRAIN as 2 ranks with a safe point after step 3 and the
    resume from it (one launch, gathered), the one-process run, and the
    safe point's directory."""
    from repro_torch.api.cli import (TRAIN_ALIASES, TRAIN_CLI_DEFAULTS,
                                     build_spec)
    from repro_torch.launch.dist import launch
    from repro_torch.launch.train import build_parser, run
    ck = str(tmp_path_factory.mktemp("zamba2") / "ck")
    one = run(ZAMBA_TRAIN + ["--device", "cpu"])
    spec = build_spec(build_parser().parse_args(
        ZAMBA_TRAIN + ["--ckpt-dir", ck, "--ckpt-every", "4"]),
        TRAIN_ALIASES, cli_defaults=TRAIN_CLI_DEFAULTS)
    tail = spec.override({"ckpt_every": 0, "ckpt_dir": None})
    res = launch("_dist_targets:runs", 2, device="cpu", kwargs=dict(parts=[
        ("train", spec, dict(gather=True)),
        ("train", tail, dict(gather=True, resume=(ck, 3)))]))
    return {"one": one, "full": res[0][0]["report"],
            "resumed": res[0][1]["report"],
            "ranks": [r[0]["rank"] for r in res], "ck": ck}


def test_zamba2_migration_and_safe_point_across_ranks(zamba2_ranks):
    """Migrations after steps 1 and 3 move one MAMBA and one HYBRID_ATTN
    layer from rank 1 to rank 0; the run, its safe point after step 3
    (``ga_*`` and both moments in ``common.npz``) and the resume from it
    are bitwise the one-process run."""
    one, full = zamba2_ranks["one"], zamba2_ranks["full"]
    resumed, ranks = zamba2_ranks["resumed"], zamba2_ranks["ranks"]
    assert full["losses"] == one["losses"]
    events = [(e.iteration, e.moved_layers) for e in full["events"]]
    assert events == [(e.iteration, e.moved_layers) for e in one["events"]]
    assert events == [(2, 1), (4, 1)]
    tags = one["assignment"]["tags"].tolist()
    pattern = [t for row in tags for t in row if t]
    moved = {pattern[i] for i in range(full["lps_history"][0][0],
                                       full["final_lps"][0])}
    assert moved == {BLOCK_MAMBA, BLOCK_HYBRID_ATTN}, moved
    assert sum(r["comm"]["rows_sent"] for r in ranks) == sum(
        r["comm"]["rows_recv"] for r in ranks) > 0
    for rep in (full, resumed):
        for tree in ("params", "opt_state", "dyn"):
            assert_bitwise(rep[tree], one[tree])
    assert resumed["losses"] == one["losses"][4:]
    with np.load(os.path.join(zamba2_ranks["ck"], "step_00000003",
                              "common.npz")) as z:
        ga = [k for k in z.files if "/shared/ga_" in k]
    assert len(ga) == 15, ga          # params, m and v of the 5 leaves


def test_chip_smoke_7i_check_refuses_a_wrong_run(zamba2_ranks):
    """7i takes this run (with the card's counters, K1 / K2a / K2b each
    step as 6b's); a split, a migration or a loss that differs, no rows
    moved, or K2a's count short fail."""
    import copy

    from test_torch_moe_cli import _smoke, launched
    smoke = _smoke()
    one, rep = zamba2_ranks["one"], zamba2_ranks["full"]
    want = {"losses": one["losses"], "lps_history": one["lps_history"],
            "events": [[e.iteration, e.moved_layers] for e in one["events"]]}
    per_step = smoke.ZAMBA_LAUNCHES_PER_STEP
    steps = len(rep["losses"])
    good = launched(zamba2_ranks["ranks"], per_step, steps)
    got, _, moved = smoke.check_zamba_across(rep, good, want)
    assert moved == {BLOCK_MAMBA, BLOCK_HYBRID_ATTN}
    assert got["block_sparse_attention"] == 48 * steps
    short = launched(zamba2_ranks["ranks"], dict(
        per_step, block_sparse_attention_bwd_dq=22), steps)
    with pytest.raises(AssertionError, match="bwd_dq launched"):
        smoke.check_zamba_across(rep, short, want)
    still = copy.deepcopy(good)
    for r in still:
        r["comm"]["rows_sent"] = r["comm"]["rows_recv"] = 0
    with pytest.raises(AssertionError, match="rows sent"):
        smoke.check_zamba_across(rep, still, want)
    split = copy.deepcopy(want)
    split["lps_history"][-1] = [6, 6]
    with pytest.raises(AssertionError, match="splits"):
        smoke.check_zamba_across(rep, good, split)
    moves = dict(want, events=[[2, 2], [4, 1]])
    with pytest.raises(AssertionError, match="migrations"):
        smoke.check_zamba_across(rep, good, moves)
    loss = dict(want, losses=want["losses"][:2] + [0.0] + want["losses"][3:])
    with pytest.raises(AssertionError, match="step 2"):
        smoke.check_zamba_across(rep, good, loss)


def _trace(request_cls, vocab=256):
    rng = np.random.RandomState(5)
    plens, gens, arrive = [8, 5, 8, 3, 6, 8], [4, 6, 2, 5, 3, 4], \
        [0, 0, 1, 3, 5, 6]
    return [request_cls(rid=i, arrival=arrive[i],
                        prompt=rng.randint(0, vocab, plens[i]).astype(
                            np.int32), gen=gens[i]) for i in range(6)]


def serve_both(arch, paged=None, with_params=False, **cfg_kw):
    """The reference's and the port's ElasticServer at S = 1 on one trace
    (the port on the reference's params): completions of each (and the
    params, ``with_params``)."""
    from repro.configs import DistConfig, get_config, reduced_config
    from repro.dynamics.config import DynamicsConfig
    from repro.pipeline.pipeline import PipelineShapes
    from repro.serve import ElasticServer
    from repro.serve.requests import Request
    from repro_torch.serve import ElasticServer as TServer
    from repro_torch.serve.requests import Request as TRequest
    kw = dict(num_stages=1, slot_slack=2, remat="none",
              param_dtype="float32", kernel_impl="pallas")
    small = {**SMALL, **cfg_kw}
    jcfg = reduced_config(get_config(arch), **small)
    shapes_kw = dict(num_micro=2, mb_global=2, seq=8, cache_len=16)
    jpaged = tpaged = None
    if paged:
        from repro.serve.kv import PagedKVConfig
        from repro_torch.serve.kv import PagedKVConfig as TPaged
        jpaged, tpaged = PagedKVConfig(**paged), TPaged(**paged)
    srv = ElasticServer(jcfg, DistConfig(**kw), DynamicsConfig(),
                        PipelineShapes(**shapes_kw), seed=0, paged=jpaged)
    want = {c["rid"]: c["tokens"]
            for c in srv.serve(_trace(Request))["completions"]}
    params = convert.to_torch(jax.tree.map(np.asarray, srv.state.params),
                              "cpu")
    srv.close()
    tsrv = TServer(treduce(tget(arch), **small), TDist(**kw), TDyn(),
                   TP.PipelineShapes(**shapes_kw), seed=0, paged=tpaged,
                   device="cpu", params=params)
    got = {c["rid"]: c["tokens"]
           for c in tsrv.serve(_trace(TRequest))["completions"]}
    tsrv.close()
    return (got, want, params) if with_params else (got, want)


def test_zamba2_server_matches_reference():
    got, want = serve_both("zamba2-1.2b")
    assert got == want and len(got) == 6


def _engine(stages=2):
    from repro_torch.launch.engine import ElasticEngine
    cfg = treduce(tget("zamba2-1.2b"), num_layers=6, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=256)
    dcfg = TDist(num_stages=stages, slot_slack=4, remat="none",
                 param_dtype="float32", kernel_impl="pallas")
    return ElasticEngine(cfg, dcfg, TDyn(), TP.PipelineShapes(2, 2, 16),
                         device="cpu")


def _loader_batch(cfg):
    from repro_torch.data.loader import DataConfig, make_loader
    return next(make_loader(cfg, DataConfig(2, 2, 16, seed=3)))


def test_zamba2_migration_and_resize_are_bitwise_the_unmoved_run():
    from repro_torch.checkpoint.elastic import _resplit_stage_tree
    from repro_torch.core.migration import migrate
    eng = _engine()
    st = eng.init_state(0, with_opt=True)
    batch = _loader_batch(eng.cfg)
    eng.step(st, batch, 3e-4)                    # non-zero moments
    base = float(eng.eval_loss(st, batch))
    tags = st.assignment["tags"]
    both = {BLOCK_MAMBA, BLOCK_HYBRID_ATTN}
    assert both <= set(tags.flatten().tolist())
    # a migration moves two layers (one HYBRID_ATTN) from stage 1 to 0
    new_lps = [st.lps[0] + 2, st.lps[1] - 2]
    params_s, opt_s, dyn, assign, _, _ = migrate(
        st.params["stages"], st.opt_state, st.dyn, st.lps, new_lps,
        eng.cfg.block_pattern(), eng.dcfg_for(2).slots_for(eng.cfg))
    moved_tags = assign["tags"].tolist()[0][st.lps[0]:new_lps[0]]
    assert set(moved_tags) == both, moved_tags
    moved = type(st)({**st.params, "stages": params_s}, opt_s, dyn, assign,
                     new_lps, 2, None)
    assert float(eng.eval_loss(moved, batch)) == base
    # the elastic round trip 2 -> 1 -> 2 returns every leaf bitwise
    s1 = eng.resize(st, 1)
    assert float(eng.eval_loss(s1, batch)) == base
    s2 = eng.resize(s1, 2)
    L = eng.dcfg_for(2).slots_for(eng.cfg)
    norm = lambda t: _resplit_stage_tree(t, st.lps, st.lps, L)  # noqa
    for a, b in ((s2.params["stages"], norm(st.params["stages"])),
                 (s2.opt_state["m"]["stages"],
                  norm(st.opt_state["m"]["stages"])),
                 (s2.dyn, norm(st.dyn))):
        for (k, x), (_, y) in zip(_leaves(a), _leaves(b)):
            assert torch.equal(x, y), k
    for k, v in st.params["shared"].items():
        assert torch.equal(s2.params["shared"][k], v), k
        assert torch.equal(s2.opt_state["m"]["shared"][k],
                           st.opt_state["m"]["shared"][k]), k
    assert float(eng.eval_loss(s2, batch)) == base
