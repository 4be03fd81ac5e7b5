"""The xLSTM family (mLSTM and sLSTM blocks) in the port, against the JAX
package.

* The three mLSTM forms — ``mlstm_parallel``, ``mlstm_chunked`` (a
  sequence off the chunk) and ``mlstm_decode_step`` unrolled — agree with
  one another in the port, and each with the reference's; ``slstm_scan``
  from a fresh and from a carried state against the reference's; the
  gradients through the stabilised exponentials are finite.
* Pruning: ``block_magnitudes`` of the mLSTM up-projection and
  ``global_block_prune``'s masks against the reference's (masks bit for
  bit), and the reference's ``ValueError`` for a stack with nothing to
  prune (Mamba2 / zamba2, sLSTM only).
* Serving: ``ElasticServer`` with the mLSTM / sLSTM state in the cache,
  token-identical to the reference's at temperature 0; over 2 ranks (one
  per stage, the reference's params split over 2 stage buffers, each
  rank's contiguous cache rows) token-identical to the reference's and to
  one process's at 2 stages.
Tolerances: fp32, summation order differs: 1e-5 (the unrolled recurrence
against the parallel form: 1e-4).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduce  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from test_torch_families_mamba import (SMALL, _trace,  # noqa: E402
                                       serve_both)

torch.set_num_threads(1)


def _mlstm_inputs(rng, b=2, s=37, nh=3, dh=8):
    q, k, v = (rng.randn(b, s, nh, dh).astype(np.float32) for _ in range(3))
    ig = rng.randn(b, s, nh).astype(np.float32)
    fg = (rng.randn(b, s, nh) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


def test_mlstm_forms_agree_and_match_reference():
    from repro.models import xlstm as jxl
    rng = np.random.RandomState(0)
    arrs = _mlstm_inputs(rng)
    t = [torch.from_numpy(a) for a in arrs]
    j = [jnp.asarray(a) for a in arrs]
    par = txl.mlstm_parallel(*t)
    chk = txl.mlstm_chunked(*t, chunk=8)
    np.testing.assert_allclose(par.numpy(), np.asarray(jxl.mlstm_parallel(
        *j)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(chk.numpy(), np.asarray(jxl.mlstm_chunked(
        *j, chunk=8)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(chk.numpy(), par.numpy(), rtol=1e-4,
                               atol=1e-4)
    b, s, nh, dh = arrs[0].shape
    C = torch.zeros((b, nh, dh, dh))
    n = torch.zeros((b, nh, dh))
    m = torch.full((b, nh), float("-inf"))
    hs = []
    for i in range(s):
        h, C, n, m = txl.mlstm_decode_step(*(x[:, i] for x in t), C, n, m)
        hs.append(h)
    np.testing.assert_allclose(torch.stack(hs, 1).numpy(), par.numpy(),
                               rtol=1e-4, atol=1e-4)
    jh, jC, jn, jm = jxl.mlstm_decode_step(
        *(x[:, 0] for x in j), jnp.zeros((b, nh, dh, dh)),
        jnp.zeros((b, nh, dh)), jnp.full((b, nh), -jnp.inf))
    h0, C0, n0, m0 = txl.mlstm_decode_step(
        *(x[:, 0] for x in t), torch.zeros((b, nh, dh, dh)),
        torch.zeros((b, nh, dh)), torch.full((b, nh), float("-inf")))
    for got, want in ((h0, jh), (C0, jC), (n0, jn), (m0, jm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_mlstm_and_slstm_gradients_are_finite():
    rng = np.random.RandomState(1)
    t = [torch.from_numpy(a).requires_grad_(True)
         for a in _mlstm_inputs(rng)]
    (txl.mlstm_parallel(*t).square().sum()
     + txl.mlstm_chunked(*t, chunk=8).sum()).backward()
    gates = torch.from_numpy(rng.randn(2, 9, 4, 6).astype(
        np.float32)).requires_grad_(True)
    r = torch.from_numpy(rng.randn(4, 6).astype(np.float32) * 0.1
                         ).requires_grad_(True)
    h, _ = txl.slstm_scan(gates, r)
    h.square().sum().backward()
    for a in t + [gates, r]:
        assert torch.isfinite(a.grad).all()
        assert float(a.grad.abs().sum()) > 0


@pytest.mark.parametrize("carried", [False, True])
def test_slstm_scan_matches_reference(carried):
    from repro.models import xlstm as jxl
    rng = np.random.RandomState(2)
    gates = rng.randn(2, 11, 4, 6).astype(np.float32)
    r = (rng.randn(4, 6) * 0.3).astype(np.float32)
    init = None
    if carried:
        init = tuple(rng.randn(2, 6).astype(np.float32) for _ in range(4))
        init = (init[0], np.abs(init[1]) + 1.0, init[2], init[3])
    jh, jc = jxl.slstm_scan(jnp.asarray(gates), jnp.asarray(r),
                            init=None if init is None else tuple(
                                map(jnp.asarray, init)))
    th, tc = txl.slstm_scan(torch.from_numpy(gates), torch.from_numpy(r),
                            init=None if init is None else tuple(
                                map(torch.from_numpy, init)))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def _stage_params(arch, **kw):
    from repro.configs import DistConfig, get_config, reduced_config
    from repro.models import model as JM
    cfg = reduced_config(get_config(arch), **kw)
    dcfg = DistConfig(num_stages=2, slot_slack=2, param_dtype="float32")
    params = jax.tree.map(np.asarray, JM.init_params(
        jax.random.PRNGKey(3), cfg, dcfg))
    tags = np.asarray(JM.make_assignment(cfg, dcfg)["tags"])
    return cfg, treduce(tget(arch), **kw), params["stages"], tags


@pytest.mark.parametrize("arch,kw", [
    ("xlstm-1.3b", dict(num_layers=6, d_model=128, d_ff=0)),
    ("whisper-large-v3", dict(num_layers=4, d_model=64, d_ff=512)),
    ("mixtral-8x7b", dict(num_layers=4, d_model=64, d_ff=384)),
])
def test_block_magnitudes_and_prune_masks_match_reference(arch, kw):
    from repro.dynamics import pruning as jprn
    from repro_torch.dynamics import pruning as tprn
    cfg, tcfg, sp, tags = _stage_params(arch, **kw)
    tsp = convert.to_torch(sp, "cpu")
    want = np.asarray(jprn.block_magnitudes(cfg, sp))
    got = tprn.block_magnitudes(tcfg, tsp).numpy()
    assert got.shape == want.shape and want.shape[-1] > 1
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for sparsity in (0.3, 0.7):
        keep = jprn.target_keep_blocks(cfg, cfg.total_blocks(), sparsity)
        assert keep == tprn.target_keep_blocks(tcfg, tcfg.total_blocks(),
                                               sparsity)
        jm = np.asarray(jprn.global_block_prune(cfg, sp, jnp.asarray(tags),
                                                keep))
        tm = tprn.global_block_prune(tcfg, tsp, torch.from_numpy(
            tags.copy()), keep).numpy()
        assert np.array_equal(tm, jm), sparsity


@pytest.mark.parametrize("arch,kw", [
    ("zamba2-1.2b", dict(num_layers=4, d_model=64)),
    ("xlstm-1.3b", dict(num_layers=2, d_model=64, d_ff=0)),
])
def test_nothing_to_prune_raises_as_the_reference(arch, kw):
    from repro.dynamics import pruning as jprn
    from repro_torch.dynamics import pruning as tprn
    cfg, tcfg, sp, _ = _stage_params(arch, **kw)
    if arch.startswith("xlstm"):
        # an sLSTM-only stack: drop the mLSTM fields
        sp = {k: v for k, v in sp.items() if not k.startswith("x_")}
    with pytest.raises(ValueError, match="no prunable"):
        jprn.block_magnitudes(cfg, sp)
    with pytest.raises(ValueError, match="no prunable"):
        tprn.block_magnitudes(tcfg, convert.to_torch(sp, "cpu"))


@pytest.fixture(scope="module")
def xlstm_served():
    """The reference's and the port's one-stage serve, and the params."""
    return serve_both("xlstm-1.3b", with_params=True, d_ff=0)


def test_xlstm_server_matches_reference(xlstm_served):
    got, want, _ = xlstm_served
    assert got == want and len(got) == 6


def test_xlstm_server_over_two_ranks_matches_reference(xlstm_served):
    from repro_torch.checkpoint.elastic import _resplit_stage_tree
    from repro_torch.configs import DistConfig
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.dist import launch
    from repro_torch.pipeline.pipeline import PipelineShapes
    from repro_torch.serve import ElasticServer
    from repro_torch.serve.requests import Request
    _, want, params = xlstm_served
    cfg = treduce(tget("xlstm-1.3b"), **{**SMALL, "d_ff": 0})
    dcfg = DistConfig(num_stages=2, slot_slack=2, remat="none",
                      param_dtype="float32", kernel_impl="pallas")
    n = cfg.total_blocks()
    params = dict(params, stages=_resplit_stage_tree(
        params["stages"], [n], [n // 2, n - n // 2], dcfg.slots_for(cfg)))
    shapes = PipelineShapes(num_micro=2, mb_global=2, seq=8, cache_len=16)
    kw = dict(cfg=cfg, dcfg=dcfg, dyncfg=DynamicsConfig(), shapes=shapes,
              trace=_trace(Request), params=params)
    got = launch("_dist_targets:server", 2, device="cpu", kwargs=kw)[0]
    srv = ElasticServer(cfg, dcfg, DynamicsConfig(), shapes, seed=0,
                        device="cpu", params=params)
    one = {c["rid"]: c["tokens"]
           for c in srv.serve(_trace(Request))["completions"]}
    srv.close()
    assert got == want == one and len(got) == 6
