"""The port's gradient-compression codecs against the reference's, on the
CPU (``repro_torch.runtime.compression`` vs ``repro.runtime.compression``).

* top-k sparsification: the same values, indices and residual, and
  top-k + residual reconstructs the input exactly;
* int8 quantization: the same codes and scale, the error within half a
  step;
* ``compressed_psum`` against the reference's under a one-device mesh
  (its ``test_runtime.py`` setup) for int8 and the plain sum, and against
  the reference's top-k codecs for top-k (the reference's top-k branch
  fails to trace), with and without a carried residual: the same
  reduction and new residual; over a group of two ranks (two processes,
  ``gloo``) it is the sum of the ranks' codes (``test_torch_dist.py``
  holds four ranks to the reference's ``compressed_psum`` on four
  devices).

The inputs are seeded normals, which have no ties in |g|: ``torch.topk``
and ``jax.lax.top_k`` may order ties differently.  ``torch.round`` and
``jnp.round`` both round half to even.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.runtime import compression as J  # noqa: E402
from repro_torch.runtime import compression as T  # noqa: E402

torch.set_num_threads(1)


def _g(seed, n=1000, shape=None):
    g = np.random.RandomState(seed).randn(n).astype(np.float32)
    assert len(np.unique(np.abs(g))) == n          # no ties in |g|
    return g.reshape(shape) if shape else g


@pytest.mark.parametrize("frac,shape", [(0.1, None), (0.05, (25, 40)),
                                        (0.001, None)])
def test_topk_matches_reference(frac, shape):
    g = _g(0, shape=shape)
    vals, idx, res = T.compress_topk(torch.from_numpy(g), frac)
    jv, ji, jr = J.compress_topk(jnp.asarray(g), frac)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jr))
    assert tuple(res.shape) == g.shape
    rec = T.decompress_topk(vals, idx, g.shape)
    np.testing.assert_array_equal(
        rec.numpy(), np.asarray(J.decompress_topk(jv, ji, g.shape)))
    # top-k + residual reconstructs exactly; the picks are the largest
    np.testing.assert_array_equal((rec + res).numpy(), g)
    assert np.abs(vals.numpy()).min() >= np.abs(res.numpy()).max()


@pytest.mark.parametrize("seed,scale", [(1, 1.0), (2, 1e-3), (3, 50.0)])
def test_int8_matches_reference(seed, scale):
    g = _g(seed, 4096) * scale
    q, s = T.int8_quantize(torch.from_numpy(g))
    jq, js = J.int8_quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    rec = T.int8_dequantize(q, s)
    np.testing.assert_array_equal(rec.numpy(),
                                  np.asarray(J.int8_dequantize(jq, js)))
    assert np.abs(rec.numpy() - g).max() <= float(s) * 0.5 + 1e-6


def _ref_psum(g, method, err):
    if method == "topk":
        # the reference's top-k branch cannot be traced (its
        # decompress_topk takes jnp.prod of the shape: a concretization
        # error under shard_map, ROADMAP Queue 3); over one rank the psum
        # is the identity, so its codecs give the reduction directly
        vals, idx, res = J.compress_topk(jnp.asarray(g) + jnp.asarray(err))
        return J.decompress_topk(vals, idx, g.shape), res
    from repro.launch.mesh import _auto_mesh
    from repro.pipeline.pipeline import _shard_map
    mesh = _auto_mesh((1,), ("d",))
    P = jax.sharding.PartitionSpec

    def f(x, e):
        return J.compressed_psum(x, "d", method=method, err=e)

    return jax.jit(_shard_map(f, mesh=mesh, in_specs=(P(), P()),
                              out_specs=P(), axis_names={"d"}))(
        jnp.asarray(g), jnp.asarray(err))


@pytest.mark.parametrize("method", ["int8", "topk", "none"])
@pytest.mark.parametrize("with_err", [False, True])
def test_compressed_psum_one_rank_matches_reference(method, with_err):
    g = _g(4, 256)
    err = (_g(5, 256) * 1e-2 if with_err else np.zeros(256, np.float32))
    red, new_err = T.compressed_psum(
        torch.from_numpy(g), method=method,
        err=torch.from_numpy(err) if with_err else None)
    jred, jerr = _ref_psum(g, method, err)
    np.testing.assert_allclose(red.numpy(), np.asarray(jred), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(new_err.numpy(), np.asarray(jerr), rtol=0,
                               atol=1e-6)
    # error feedback: what was sent plus what is carried is the input
    np.testing.assert_allclose((red + new_err).numpy(), g + err, rtol=0,
                               atol=1e-5)


def test_compressed_psum_refuses_more_than_one_rank():
    """The name is historical: across ranks the sum is real now.  Two
    ranks reduce their own inputs — the plain sum is the sum, int8 the sum
    of codes on a common scale — and a group of one (or none) is the
    identity."""
    from repro_torch.launch.dist import launch
    gs = [torch.from_numpy(_g(10 + r, 64)) for r in range(2)]
    red, err = T.compressed_psum(torch.ones(8), group=None)
    assert torch.equal(red, torch.ones(8)) and not err.any()
    for method in ("none", "int8"):
        out = launch("_dist_targets:compressed_psum", 2, device="cpu",
                     kwargs=dict(gs=gs, errs=None, method=method),
                     timeout_s=60, run_timeout_s=120)
        assert torch.equal(out[0]["red"], out[1]["red"])
        if method == "none":
            np.testing.assert_array_equal(out[0]["red"].numpy(),
                                          (gs[0] + gs[1]).numpy())
        else:
            scale = max(float(g.abs().max()) for g in gs) / 127.0
            q = [torch.clamp(torch.round(g / scale), -127, 127) for g in gs]
            np.testing.assert_allclose(out[0]["red"].numpy(),
                                       ((q[0] + q[1]) * scale).numpy(),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(
                (out[0]["red"] - q[1] * scale + out[0]["err"]).numpy(),
                gs[0].numpy(), rtol=0, atol=1e-5)
