"""The whisper encoder–decoder family in the port, against the JAX package.

* ``gelu_mlp`` (the dense impls and the pruned one, with a block mask, on a
  sequence and on one token) and ``layer_norm`` against the reference's.
* An S = 2 pipelined train step of reduced whisper (2 encoder + 4 decoder
  layers over 2 stage buffers, 16 frames from the loader riding the carry as
  ``enc``, ``dec_pos`` in ``params["shared"]``, a pruned FFN block): loss
  and every gradient leaf against the reference's in a 2-device
  subprocess.
* Serving the reference's encoder–decoder path: a prefill with frames (the
  cross K/V written into ``ck`` / ``cv``) and scalar-position decode steps
  at S = 1: ids equal, logprobs within 1e-4, caches within one bf16 ulp;
  per-lane positions raise the reference's refusal as a ``ValueError``.
* A safe point carries ``params["shared"]`` and its Adam moments: a run
  resumed from it ends bitwise the uninterrupted run.
* Across 2 ranks (one process per stage, gloo): the S = 2 train step (the
  frames' encoder stream riding the carry between the ranks) bitwise the
  one-process step, ``dec_pos``'s gradient included; the one-shot serve
  (fed no frames, as the reference's) token-identical to one process's.
  The reference's one-shot serve of whisper fails (ROADMAP Queue 3).
Both sides run ``kernel_impl="pallas"``.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import DistConfig as TDist  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduce  # noqa: E402
from repro_torch.dynamics.config import DynamicsConfig as TDyn  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.pipeline import pipeline as TP  # noqa: E402
from test_torch_families_mamba import (B_, M_, SMALL,  # noqa: E402
                                       assert_bitwise,
                                       port_step, ranks_step,
                                       reference_two_stage_step)
from test_torch_train import _assert_grads, _leaves  # noqa: E402

torch.set_num_threads(1)
BF16 = dict(atol=1e-4, rtol=2 ** -7)   # one bf16 ulp


@pytest.mark.parametrize("impl,s,masked", [
    ("pallas", 12, True), ("pallas", 12, False), ("scan", 12, True),
    ("pallas", 1, True)])
def test_gelu_mlp_and_layer_norm_match_reference(impl, s, masked):
    from repro.models import blocks as JB
    from repro.models import layers as JL
    rng = np.random.RandomState(3)
    d, ff = 32, 256
    x = rng.randn(2, s, d).astype(np.float32)
    w1 = (rng.randn(d, ff) * d ** -0.5).astype(np.float32)
    b1 = rng.randn(ff).astype(np.float32) * 0.1
    w2 = (rng.randn(ff, d) * ff ** -0.5).astype(np.float32)
    b2 = rng.randn(d).astype(np.float32) * 0.1
    mask = np.array([1.0, 0.0], np.float32) if masked else None
    want = JL.gelu_mlp(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                       None if mask is None else jnp.asarray(mask),
                       impl=impl)
    got = TL.gelu_mlp(*map(torch.from_numpy, (x, w1, b1, w2, b2)),
                      None if mask is None else torch.from_numpy(mask),
                      impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    scale, bias = rng.randn(d).astype(np.float32), rng.randn(d).astype(
        np.float32)
    np.testing.assert_allclose(
        TL.layer_norm(*map(torch.from_numpy, (x, scale, bias)), 1e-5)
        .numpy(), np.asarray(JB._layer_norm(*map(jnp.asarray,
                                                 (x, scale, bias)), 1e-5)),
        rtol=1e-5, atol=1e-5)


WHISPER_EXTRA = """
dyn["ff_mask"] = dyn["ff_mask"].copy()
dyn["ff_mask"][1, 1, 0] = 0.0
"""


# run_serving's one-shot flags (its reduced widths: 4 heads, 2 KV heads,
# d_ff 2 x d_model, vocab 512)
ONE_SHOT = dict(stages=2, micro=2, mb_global=2, prompt_len=8, gen=5,
                layers=4, d_model=64, seed=0)


@pytest.fixture(scope="module")
def whisper_step(tmp_path_factory):
    """The reference's S = 2 train step of reduced whisper."""
    return reference_two_stage_step(tmp_path_factory.mktemp("whisper"),
                                    "whisper-large-v3", {"enc_seq": 16}, 24,
                                    WHISPER_EXTRA)


def test_whisper_two_stage_train_step_matches_reference(whisper_step):
    tree = whisper_step
    assert tree["batch"]["frames"].shape == (M_, B_, 16, 64)
    tcfg = treduce(tget("whisper-large-v3"), **SMALL)
    tl, _, tg = port_step("whisper-large-v3", tree,
                          TP.PipelineShapes.for_model(tcfg, M_, B_, 24))
    np.testing.assert_allclose(float(tl), float(tree["loss"]), rtol=1e-5)
    _assert_grads(tg, tree["grads"])
    assert float(tg["shared"]["dec_pos"][:24].abs().sum()) > 0
    # the encoder's weights get gradients through the cross attention
    assert float(tg["stages"]["e_wq"].abs().sum()) > 0
    for _, g in _leaves(tg):
        assert torch.isfinite(g).all()


def test_whisper_over_two_ranks_matches_one_process(whisper_step):
    from repro_torch.launch.serve import run_serving
    tree = whisper_step
    tcfg = treduce(tget("whisper-large-v3"), **SMALL)
    shapes = TP.PipelineShapes.for_model(tcfg, M_, B_, 24)
    tl, _, tg = port_step("whisper-large-v3", tree, shapes)
    rl, rg = ranks_step("whisper-large-v3", tree, shapes)
    assert float(rl) == float(tl)
    assert_bitwise(rg, tg)
    assert float(rg["shared"]["dec_pos"][:24].abs().sum()) > 0
    _assert_grads(rg, tree["grads"])
    # the one-shot serve over 2 ranks (the reference's fails on whisper:
    # ROADMAP Queue 3)
    got = run_serving("whisper-large-v3", device="cpu", procs=2, **ONE_SHOT)
    one = run_serving("whisper-large-v3", device="cpu", **ONE_SHOT)
    assert got["tokens"].tolist() == one["tokens"].tolist()
    assert [r["stage"] for r in got["ranks"]] == [0, 1]


def test_whisper_prefill_and_scalar_decode_match_reference():
    from repro.configs import DistConfig, get_config, reduced_config
    from repro.dynamics.config import DynamicsConfig
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as JM
    from repro.pipeline.pipeline import (PipelineShapes, build_decode_fn,
                                         build_prefill_fn)
    kw = dict(num_stages=1, slot_slack=2, remat="none",
              param_dtype="float32", kernel_impl="pallas")
    jcfg = reduced_config(get_config("whisper-large-v3"), **SMALL)
    jd = DistConfig(**kw)
    tcfg = treduce(tget("whisper-large-v3"), **SMALL)
    td = TDist(**kw)
    m, B, seq, cap = 2, 2, 8, 16
    jshapes = PipelineShapes(m, B, seq, enc_seq=16, cache_len=cap)
    tshapes = TP.PipelineShapes.for_model(tcfg, m, B, seq, cache_len=cap)
    mesh = make_host_mesh(data=1, model=1)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg, jd)
    assign = JM.make_assignment(jcfg, jd)
    dyn = JM.init_dyn(jcfg, jd, DynamicsConfig())
    tp = convert.to_torch(jax.tree.map(np.asarray, params), "cpu")
    tdyn = convert.to_torch(jax.tree.map(np.asarray, dyn), "cpu")
    tas = TM.make_assignment(tcfg, td)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 256, (m, B, seq)).astype(np.int32)
    frames = (rng.randn(m, B, 16, 64) * 0.1).astype(np.float32)
    with mesh:
        jids, jcache, _ = jax.jit(build_prefill_fn(
            jcfg, jd, DynamicsConfig(), mesh, jshapes))(
            params, assign, dyn, JM.init_cache(jcfg, jd, m, B, cap),
            {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})
    tids, tcache, _ = TP.build_prefill_fn(tcfg, td, TDyn(), tshapes)(
        tp, tas, tdyn, TM.init_cache(tcfg, td, m, B, cap),
        {"tokens": torch.from_numpy(tokens),
         "frames": torch.from_numpy(frames)})
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert sorted(tcache) == ["ck", "cv", "k", "v"]
    for k in tcache:
        np.testing.assert_allclose(tcache[k].float().numpy(),
                                   np.asarray(jcache[k], np.float32), **BF16)
    assert float(tcache["ck"].float().abs().sum()) > 0
    nxt = np.array(jids)
    jdec = jax.jit(build_decode_fn(jcfg, jd, DynamicsConfig(), mesh,
                                   jshapes))
    tdec = TP.build_decode_fn(tcfg, td, TDyn(), tshapes)
    for i in range(3):
        with mesh:
            j_ids, j_lp, jcache, _ = jdec(params, assign, dyn, jcache,
                                          jnp.asarray(nxt),
                                          jnp.int32(seq + i))
        t_ids, t_lp, tcache, _ = tdec(tp, tas, tdyn, tcache,
                                      torch.from_numpy(nxt),
                                      torch.tensor(seq + i))
        assert np.array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp),
                                   atol=1e-4, rtol=1e-4)
        nxt = np.array(j_ids)
    for k in tcache:
        np.testing.assert_allclose(tcache[k].float().numpy(),
                                   np.asarray(jcache[k], np.float32), **BF16)
    with pytest.raises(ValueError, match="per-lane dec_pos"):
        tdec(tp, tas, tdyn, tcache, torch.from_numpy(nxt),
             torch.full((m, B), seq + 3, dtype=torch.int32))


WHISPER_TRAIN = ["--arch", "whisper-large-v3", "--layers", "4", "--d-model",
                 "64", "--num-heads", "4", "--num-kv-heads", "2", "--d-ff",
                 "256", "--vocab-size", "256", "--seq", "16", "--num-micro",
                 "2", "--mb-global", "2", "--stages", "2", "--steps", "6",
                 "--dynamism", "pruning", "--kernel-impl", "pallas",
                 "--device", "cpu"]


def test_safe_point_carries_the_shared_params(tmp_path):
    from repro_torch.api import Session
    from repro_torch.launch.train import run
    ck = str(tmp_path / "ck")
    full = run(WHISPER_TRAIN + ["--ckpt-dir", ck, "--ckpt-every", "3"])
    assert "dec_pos" in full["params"]["shared"]
    with Session.resume(ck, step=2, device="cpu") as s:
        rep = s.train()
    assert rep["losses"] == full["losses"][3:]
    for tree in ("params", "opt_state"):
        for (k, a), (_, b) in zip(_leaves(rep[tree]), _leaves(full[tree])):
            if torch.is_tensor(a):
                assert torch.equal(a, b), (tree, k)
    assert torch.equal(rep["opt_state"]["m"]["shared"]["dec_pos"],
                       full["opt_state"]["m"]["shared"]["dec_pos"])
    assert float(full["opt_state"]["m"]["shared"]["dec_pos"].abs().sum()) > 0
