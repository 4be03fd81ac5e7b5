"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version; these tests hold that version to the reference's Pallas kernel in
interpret mode and to its ``ref.py`` oracle on identical numpy inputs, in
fp32 at atol/rtol 2e-5 (the two differ only in summation order).  The tile
accounting helpers must return exactly the reference's values.  The CUDA
kernels themselves are held to these plain versions on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.block_sparse_attention import (  # noqa: E402
    attention_tile_work as jax_attention_tile_work,
    block_sparse_attention as jax_bsa, block_sparse_attention_ref as jax_bsa_ref)
from repro.kernels.block_sparse_attention.block_sparse_attention import (  # noqa: E402
    block_sparse_attention_p)
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention as jax_paged, paged_attention_ref as jax_paged_ref,
    paged_tile_work as jax_paged_tile_work)
from repro.kernels.pruned_matmul import (  # noqa: E402
    matmul_tile_work as jax_matmul_tile_work, pruned_matmul as jax_pm,
    pruned_matmul_ref as jax_pm_ref, pruned_swiglu as jax_swiglu,
    pruned_swiglu_ref as jax_swiglu_ref)
from repro_torch.kernels.block_sparse_attention import ops as bsa  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pa_ref  # noqa: E402
from repro_torch.kernels.pruned_matmul import ops as pm  # noqa: E402
from repro_torch.kernels.pruned_matmul import ref as pm_ref  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# K1: block-sparse flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,hq,hkv,d,block", [
    (256, 4, 2, 16, 64),       # GQA
    (100, 4, 2, 16, 32),       # s not a multiple of the block
    (600, 2, 1, 16, 512),      # 512-blocks, partial trailing block
])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("causal", [True, False])
def test_block_sparse_attention_matches_pallas(s, hq, hkv, d, block, density,
                                               causal):
    rng = np.random.RandomState(s + hq + int(10 * density) + causal)
    b = 2
    q = (rng.randn(b, s, hq, d) * 0.4).astype(np.float32)
    k = (rng.randn(b, s, hkv, d) * 0.4).astype(np.float32)
    v = (rng.randn(b, s, hkv, d) * 0.4).astype(np.float32)
    n = -(-s // block)
    mask = (rng.rand(b, hq, n, n) < density).astype(np.int32)
    if density == 0.5:
        mask[:, :, 0, :] = 0                 # fully masked rows -> zeros
    out, lse = bsa.block_sparse_attention_fwd(_t(q), _t(k), _t(v), _t(mask),
                                              causal=causal, block=block)
    # the JAX wrapper (GQA repeat, padding) around the interpret-mode kernel
    want = jax_bsa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(mask), causal=causal, block_q=block,
                   block_k=block, interpret=True)
    close(out, want)
    # the kernel itself, for the lse: flattened + padded like the wrapper
    pad = n * block - s
    rep = hq // hkv

    def flat(a, r=1):
        a = np.repeat(a, r, axis=2)
        a = np.pad(a, ((0, 0), (0, pad), (0, 0), (0, 0)))
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * hq, n * block,
                                                           d))
    kout, klse = block_sparse_attention_p(
        flat(q), flat(k, rep), flat(v, rep),
        jnp.asarray(mask.reshape(b * hq, n, n)), causal=causal,
        block_q=block, block_k=block, kv_len=s, interpret=True)
    klse = np.asarray(klse).reshape(b, hq, n * block)[:, :, :s]
    live = klse > -1e29
    close(lse.numpy()[live], klse[live])
    assert (lse.numpy()[~live] < -1e29).all()
    if density == 0.5 and causal:
        assert float(out[:, :block].abs().max()) == 0.0
    # the reference's ref.py on the padded shapes
    ref = jax_bsa_ref(flat(q), flat(k, rep), flat(v, rep),
                      jnp.asarray(mask.reshape(b * hq, n, n)), causal=causal,
                      block_q=block, block_k=block)
    ref = np.asarray(ref).reshape(b, hq, n * block, d).transpose(0, 2, 1, 3)
    if not causal and pad:
        return      # ref.py attends the zero-padded keys; the kernels do not
    close(out, ref[:, :s])


def test_attention_tile_work_matches_reference():
    rng = np.random.RandomState(0)
    for causal in (True, False):
        for bq, bk in ((128, 128), (512, 512), (64, 128)):
            m = (rng.rand(2, 3, 5, 6) < 0.4).astype(np.float32)
            assert bsa.attention_tile_work(
                m, causal=causal, block_q=bq, block_k=bk) == \
                jax_attention_tile_work(m, causal=causal, block_q=bq,
                                        block_k=bk)


# ---------------------------------------------------------------------------
# K3: block-pruned matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N,axis,blk", [
    (64, 256, 384, "n", 128),
    (37, 96, 256, "n", 128),       # K = 960-like non-multiple (padded)
    (100, 256, 96, "k", 128),      # N not a multiple of the tile
    (257, 384, 256, "k", 128),
    (50, 128, 192, "n", 64),
])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_pruned_matmul_matches_pallas(M, K, N, axis, blk, density):
    rng = np.random.RandomState(M + K + N + int(10 * density))
    x = (rng.randn(M, K) * 0.2).astype(np.float32)
    w = (rng.randn(K, N) * 0.2).astype(np.float32)
    nb = (N if axis == "n" else K) // blk
    mask = (rng.rand(nb) < density).astype(np.float32)
    out = pm.pruned_matmul(_t(x), _t(w), _t(mask), mask_axis=axis, bn=blk,
                           bk=blk)
    kw = dict(bn=blk) if axis == "n" else dict(bk=blk)
    want = jax_pm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask),
                  mask_axis=axis, interpret=True, **kw)
    close(out, want, atol=2e-5, rtol=2e-5)
    ref = jax_pm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask),
                     mask_axis=axis, bn=blk, bk=blk)
    close(out, ref)
    close(pm_ref.pruned_matmul_ref(_t(x), _t(w), _t(mask), mask_axis=axis,
                                   bn=blk, bk=blk), ref)


@pytest.mark.parametrize("sparsity,bf", [(0.0, 128), (0.5, 128), (0.9, 128),
                                         (0.5, 64)])
def test_pruned_swiglu_matches_pallas(sparsity, bf):
    rng = np.random.RandomState(int(sparsity * 10) + bf)
    M, d, ff = 48, 96, 512
    x = (rng.randn(2, M // 2, d) * 0.3).astype(np.float32)
    wi, wg = [(rng.randn(d, ff) * 0.05).astype(np.float32) for _ in range(2)]
    wo = (rng.randn(ff, d) * 0.05).astype(np.float32)
    mask = (rng.rand(ff // bf) >= sparsity).astype(np.float32)
    out = pm.pruned_swiglu(_t(x), _t(wi), _t(wg), _t(wo), _t(mask), bf=bf)
    args = [jnp.asarray(a) for a in (x, wi, wg, wo, mask)]
    close(out, jax_swiglu(*args, bf=bf, interpret=True))
    close(out, jax_swiglu_ref(*args, bf=bf))


def test_matmul_tile_work_matches_reference():
    rng = np.random.RandomState(1)
    for axis in ("n", "k"):
        m = (rng.rand(20) > 0.3).astype(np.float32)
        for M, K, N in ((4096, 960, 2560), (100, 2560, 960)):
            assert pm.matmul_tile_work(M, K, N, m, mask_axis=axis) == \
                jax_matmul_tile_work(M, K, N, m, mask_axis=axis)


# ---------------------------------------------------------------------------
# K6: paged decode attention
# ---------------------------------------------------------------------------
def _paged_inputs(seed, clen, n_q, n_kv, hd, page, J, pool, holes=False):
    rng = np.random.RandomState(seed)
    b = len(clen)
    kp = rng.randn(pool + 1, page, n_kv, hd).astype(np.float32)
    vp = rng.randn(pool + 1, page, n_kv, hd).astype(np.float32)
    q = rng.randn(b, 1, n_q, hd).astype(np.float32)
    pt = np.full((b, J), -1, np.int32)
    blocks = rng.permutation(pool)
    k = 0
    for i in range(b):
        for j in range(-(-int(clen[i]) // page)):
            pt[i, j] = blocks[k]
            k += 1
    if holes:
        pt[0, 1] = -1        # an unmapped page below cache_len: skipped
    return q, kp, vp, pt, np.asarray(clen, np.int32)


@pytest.mark.parametrize("clen,holes", [
    ([4, 7, 13, 16], False),       # per-lane lengths, tail pages
    ([5, 0, 16, 1], False),        # a lane with no live page
    ([9, 14, 3, 12], True),        # an unmapped page inside cache_len
])
@pytest.mark.parametrize("n_q,n_kv,hd", [(4, 2, 16), (6, 2, 8)])
def test_paged_attention_matches_pallas(clen, holes, n_q, n_kv, hd):
    q, kp, vp, pt, cl = _paged_inputs(sum(clen) + n_q, clen, n_q, n_kv, hd,
                                      page=4, J=4, pool=12, holes=holes)
    out = pa.paged_attention(_t(q), _t(kp), _t(vp), _t(pt), _t(cl))
    want = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                     jnp.asarray(pt), jnp.asarray(cl), interpret=True)
    close(out, want)
    if 0 in clen:
        assert float(out[clen.index(0)].abs().max()) == 0.0
    if not holes and 0 not in clen:
        # with every page below cache_len mapped, the kernel's function IS
        # the gather + dense decode_attention oracle (fp32 pool)
        ref = jax_paged_ref(jnp.asarray(q), jnp.asarray(kp),
                            jnp.asarray(vp), jnp.asarray(pt),
                            jnp.asarray(cl))
        close(out, ref)
        close(pa_ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(pt),
                                         _t(cl)), ref)


def test_paged_attention_bf16_pool_matches_pallas():
    """The path's types: q fp32, pool bf16 — the kernel upcasts the pool and
    computes in fp32, so the plain version matches it at fp32 tolerance."""
    q, kp, vp, pt, cl = _paged_inputs(3, [4, 7, 13, 16], 4, 2, 16, 4, 4, 12)
    kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (kp, vp))
    want = jax_paged(jnp.asarray(q), kb, vb, jnp.asarray(pt),
                     jnp.asarray(cl), interpret=True)
    out = pa.paged_attention(_t(q), _t(np.asarray(kb, np.float32)).bfloat16(),
                             _t(np.asarray(vb, np.float32)).bfloat16(),
                             _t(pt), _t(cl))
    assert out.dtype == torch.float32
    close(out, want)


def test_paged_tile_work_matches_reference():
    pt = np.array([[0, 1, -1, -1], [2, 3, 4, 5], [6, -1, 7, -1]], np.int32)
    for clen in ([5, 16, 9], [0, 0, 0], [16, 16, 16]):
        assert pa.paged_tile_work(pt, np.array(clen), 4) == \
            jax_paged_tile_work(pt, np.array(clen), 4)
