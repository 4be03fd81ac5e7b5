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


def test_zamba2_two_stage_train_step_matches_reference(tmp_path):
    tree = reference_two_stage_step(tmp_path, "zamba2-1.2b", {}, SEQ)
    tl, _, tg = port_step("zamba2-1.2b", tree,
                          TP.PipelineShapes(M_, B_, SEQ))
    np.testing.assert_allclose(float(tl), float(tree["loss"]), rtol=1e-5)
    _assert_grads(tg, tree["grads"])
    assert sorted(tg["shared"]) == ["ga_norm", "ga_wk", "ga_wo", "ga_wq",
                                    "ga_wv"]
    assert float(tg["shared"]["ga_wq"].abs().sum()) > 0
    for _, g in _leaves(tg):
        assert torch.isfinite(g).all()


def _trace(request_cls, vocab=256):
    rng = np.random.RandomState(5)
    plens, gens, arrive = [8, 5, 8, 3, 6, 8], [4, 6, 2, 5, 3, 4], \
        [0, 0, 1, 3, 5, 6]
    return [request_cls(rid=i, arrival=arrive[i],
                        prompt=rng.randint(0, vocab, plens[i]).astype(
                            np.int32), gen=gens[i]) for i in range(6)]


def serve_both(arch, paged=None, **cfg_kw):
    """The reference's and the port's ElasticServer at S = 1 on one trace
    (the port on the reference's params): completions of each."""
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
    return got, want


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
