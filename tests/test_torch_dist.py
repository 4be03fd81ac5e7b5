"""The port's ranks (``repro_torch.launch.dist``, ``launch.mesh``) on the
CPU, four processes over ``gloo``, against the reference on four host
devices.

* the vocab-parallel ``cross_entropy_with_head`` over four ranks (vocab
  shard s on rank s): its value equals the reference's ``shard_map`` over
  a ``model`` axis of four devices; its gradients equal the reference's
  unsharded loss's (the reference's vocab-parallel loss cannot be
  differentiated: ``pmax`` has no differentiation rule, ROADMAP Queue 3),
  and summing the ranks' ``dh`` gives the whole ``dh``;
* ``compressed_psum`` over four ranks equals the reference's under a
  ``shard_map`` of four devices for int8 and the plain sum; top-k is held
  to the reference's codecs (its ``compressed_psum`` top-k branch cannot
  be traced, Queue 3);
* a migration's rows (here a KV-cache-shaped tree and a params-shaped
  one) move across four ranks to exactly the one-process ``apply_plan``
  result, PAD destinations zeroed;
* a rank that raises ends the run non-zero within its limit, and no rank
  hangs;
* every rank's ``sys.modules`` is free of jax and of the reference;
* the backend follows the layout, and an explicit ``nccl`` on a shared
  card (or on the CPU) raises.
"""
import time

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from conftest import run_in_subprocess  # noqa: E402
from repro_torch.launch.dist import choose_backend, launch  # noqa: E402
from repro_torch.runtime import compression as T  # noqa: E402

torch.set_num_threads(1)
RANKS = 4
V, D = 256, 64


def _inputs():
    rng = np.random.RandomState(0)
    h = rng.randn(2, 8, D).astype(np.float32)
    w = (rng.randn(D, V) * 0.1).astype(np.float32)
    lab = rng.randint(0, V, (2, 8)).astype(np.int32)
    mask = (rng.rand(2, 8) > 0.2).astype(np.float32)
    gs = [np.random.RandomState(20 + r).randn(512).astype(np.float32)
          * (1.0 + r) for r in range(RANKS)]
    errs = [np.random.RandomState(30 + r).randn(512).astype(np.float32)
            * 1e-2 for r in range(RANKS)]
    return h, w, lab, mask, gs, errs


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference on four host devices: the vocab-parallel loss's value
    (and its refusal to differentiate), the unsharded loss's gradients,
    and ``compressed_psum`` over the ``model`` axis."""
    tmp = tmp_path_factory.mktemp("ref")
    out, inp = str(tmp / "ref.npz"), str(tmp / "inputs.npz")
    h, w, lab, mask, gs, errs = _inputs()
    np.savez(inp, h=h, w=w, lab=lab, mask=mask, gs=np.stack(gs),
             errs=np.stack(errs))
    run_in_subprocess(f"""
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_host_mesh
from repro.models.layers import cross_entropy_with_head
from repro.pipeline.pipeline import _shard_map
from repro.runtime.compression import compressed_psum

z = np.load({inp!r})
h, w, lab, mask, G, E = (z[k] for k in ("h", "w", "lab", "mask", "gs",
                                        "errs"))
mesh = make_host_mesh(1, {RANKS})
Vl = {V // RANKS}

def body(h, w, lab, mask):
    off = jax.lax.axis_index("model") * Vl
    return cross_entropy_with_head(h, w, lab, label_mask=mask,
                                   vocab_offset=off, axis_name="model")

ce = _shard_map(body, mesh=mesh, in_specs=(P(), P(None, "model"), P(),
                P()), out_specs=P(), axis_names={{"model"}})
val = jax.jit(ce)(h, w, lab, mask)
try:
    jax.jit(jax.grad(ce, argnums=1))(h, w, lab, mask)
    grad_fails = ""
except NotImplementedError as e:
    grad_fails = str(e)
full = lambda h, w: cross_entropy_with_head(h, w, lab, label_mask=mask)
v0, (gh, gw) = jax.value_and_grad(full, argnums=(0, 1))(h, w)
res = {{"val": np.asarray(val), "v0": np.asarray(v0), "gh": np.asarray(gh),
        "gw": np.asarray(gw), "grad_fails": np.asarray(grad_fails)}}
for method in ("int8", "none"):
    for we in (0, 1):
        def f(g, e, method=method, we=we):
            r, ne = compressed_psum(g[0], "model", method=method,
                                    err=e[0] if we else None)
            return r[None], ne[None]
        red, ne = jax.jit(_shard_map(
            f, mesh=mesh, in_specs=(P("model"), P("model")),
            out_specs=(P("model"), P("model")),
            axis_names={{"model"}}))(G, E)
        res[f"{{method}}_{{we}}_red"] = np.asarray(red)
        res[f"{{method}}_{{we}}_err"] = np.asarray(ne)
np.savez({out!r}, **res)
""", devices=RANKS)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def test_vocab_parallel_cross_entropy_matches_reference(reference):
    h, w, lab, mask, _, _ = _inputs()
    out = launch("_dist_targets:cross_entropy", RANKS, device="cpu",
                 kwargs=dict(h=torch.from_numpy(h), head=torch.from_numpy(w),
                             labels=torch.from_numpy(lab).long(),
                             mask=torch.from_numpy(mask)),
                 timeout_s=60, run_timeout_s=120)
    assert "pmax" in str(reference["grad_fails"])
    for r in out:
        np.testing.assert_allclose(float(r["loss"]), float(reference["val"]),
                                   rtol=1e-6)
    np.testing.assert_allclose(float(reference["val"]),
                               float(reference["v0"]), rtol=1e-6)
    dw = torch.cat([r["dw"] for r in sorted(out, key=lambda r: r["offset"])],
                   dim=1)
    np.testing.assert_allclose(dw.numpy(), reference["gw"], rtol=1e-6,
                               atol=1e-7)
    dh = sum(r["dh"] for r in out)
    np.testing.assert_allclose(dh.numpy(), reference["gh"], rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("method,with_err", [("int8", 0), ("int8", 1),
                                             ("none", 0), ("none", 1)])
def test_compressed_psum_over_ranks_matches_reference(reference, method,
                                                      with_err):
    _, _, _, _, gs, errs = _inputs()
    out = launch("_dist_targets:compressed_psum", RANKS, device="cpu",
                 kwargs=dict(gs=[torch.from_numpy(g) for g in gs],
                             errs=([torch.from_numpy(e) for e in errs]
                                   if with_err else None), method=method),
                 timeout_s=60, run_timeout_s=120)
    for r in range(RANKS):
        np.testing.assert_allclose(
            out[r]["red"].numpy(),
            reference[f"{method}_{with_err}_red"][r], rtol=1e-6, atol=1e-6)
        # the residual g - q * scale cancels: XLA may fuse it into one
        # multiply-add, so it is held to a few ulps of the input's size
        np.testing.assert_allclose(
            out[r]["err"].numpy(),
            reference[f"{method}_{with_err}_err"][r], rtol=0,
            atol=1e-6 * float(np.abs(gs[r]).max()))


def test_compressed_psum_topk_over_ranks_matches_reference_codecs():
    import jax.numpy as jnp

    from repro.runtime import compression as J
    _, _, _, _, gs, errs = _inputs()
    out = launch("_dist_targets:compressed_psum", RANKS, device="cpu",
                 kwargs=dict(gs=[torch.from_numpy(g) for g in gs],
                             errs=[torch.from_numpy(e) for e in errs],
                             method="topk"),
                 timeout_s=60, run_timeout_s=120)
    want, res = 0.0, []
    for g, e in zip(gs, errs):
        vals, idx, r = J.compress_topk(jnp.asarray(g + e), 0.05)
        want = want + np.asarray(J.decompress_topk(vals, idx, g.shape))
        res.append(np.asarray(r))
    for r in range(RANKS):
        np.testing.assert_allclose(out[r]["red"].numpy(), want, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(out[r]["err"].numpy(), res[r])


@pytest.mark.parametrize("old,new", [([2, 2, 2, 2], [3, 1, 2, 2]),
                                     ([2, 2, 2, 2], [1, 3, 3, 1]),
                                     ([1, 3, 3, 1], [4, 0, 2, 2])])
def test_migration_moves_rows_across_ranks(old, new):
    from repro_torch.core.migration import apply_plan, build_plan
    L = 4
    g = torch.Generator().manual_seed(0)
    tree = {"k": torch.randn((RANKS, L, 2, 3, 5, 4), generator=g),
            "w": torch.randn((RANKS, L, 6, 7), generator=g)}
    out = launch("_dist_targets:migrate_rows", RANKS, device="cpu",
                 kwargs=dict(tree=tree, old_lps=old, new_lps=new, L_max=L),
                 timeout_s=60, run_timeout_s=120)
    want = apply_plan(tree, build_plan(old, new, L))
    for s, r in enumerate(out):
        for k in tree:
            assert torch.equal(r["row"][k][0], want[k][s]), (s, k)
    plan = build_plan(old, new, L)
    crossing = int((plan.valid & (plan.src_stage != np.arange(RANKS)[:, None]
                                  )).sum())
    assert sum(r["sent"] for r in out) == sum(r["recv"] for r in out) \
        == crossing > 0


def test_a_rank_that_raises_ends_the_run():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="exited 1"):
        launch("_dist_targets:ring", RANKS, device="cpu",
               kwargs=dict(rounds=4, fail_rank=2, fail_round=1),
               timeout_s=30, run_timeout_s=90)
    assert time.perf_counter() - t0 < 60


def test_every_rank_is_free_of_jax_and_the_reference():
    import sys
    assert "jax" in sys.modules          # this test process has both
    out = launch("_dist_targets:modules", RANKS, device="cpu",
                 timeout_s=60, run_timeout_s=120)
    assert [r["foreign"] for r in out] == [[]] * RANKS
    assert [r["sum"] for r in out] == [6.0] * RANKS
    ring = launch("_dist_targets:ring", RANKS, device="cpu",
                  timeout_s=60, run_timeout_s=120)
    for r in ring:
        prv = (r["rank"] - 1) % RANKS
        assert r["got"] == [(float(prv * 10 + i), float(60 + 4 * i))
                            for i in range(3)]
        assert r["foreign"] == []


def test_backend_follows_the_layout():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert choose_backend(cpu, 4) == "gloo"
    assert choose_backend(cuda, 4, device_count=4) == "nccl"
    assert choose_backend(cuda, 4, device_count=1) == "gloo"
    assert choose_backend(cuda, 4, "gloo", device_count=4) == "gloo"
    with pytest.raises(ValueError, match="refuses two ranks on one device"):
        choose_backend(cuda, 4, "nccl", device_count=1)
    with pytest.raises(ValueError, match="CUDA cards"):
        choose_backend(cpu, 4, "nccl")
    with pytest.raises(ValueError, match="data=3"):
        launch("_dist_targets:ring", 4, data=3, device="cpu")


def test_one_rank_group_is_the_identity():
    red, err = T.compressed_psum(torch.ones(8), group=None, method="int8")
    assert torch.allclose(red, torch.ones(8)) and err.abs().max() < 1e-6
