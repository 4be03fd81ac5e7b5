"""K6's split-and-combine arithmetic against the JAX package's Pallas kernel.

The CUDA kernel cuts each lane's live pages into ``pa_splits`` contiguous
ranges, keeps one online-softmax state per range and merges the states in
split order.  ``ref.paged_attention_split_ref`` is that order in plain
PyTorch; here it is held to ``repro.kernels.paged_attention`` in interpret
mode on the same numpy inputs, for split counts from 1 to more than a lane
has pages: within 2e-5 with an fp32 pool and within the same 2e-5 with a
bf16 pool (both sides upcast the same bf16 values and compute in fp32, as
``test_torch_kernels.py::test_paged_attention_bf16_pool_matches_pallas``
holds them).  The card holds the kernel to the same plain version
(``test_torch_cuda.py``).
"""
import inspect

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.paged_attention import paged_attention as jax_paged  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pa_ref  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, clen, n_q, n_kv, hd, page, J, hole=False):
    """Seeded numpy inputs: each lane's pages at random pool blocks, the
    pool's last block trash, and (``hole``) an unmapped page inside lane
    0's cache_len."""
    rng = np.random.RandomState(seed)
    b = len(clen)
    pool = sum(-(-c // page) for c in clen) + 2
    kp = rng.randn(pool + 1, page, n_kv, hd).astype(np.float32)
    vp = rng.randn(pool + 1, page, n_kv, hd).astype(np.float32)
    q = rng.randn(b, n_q, hd).astype(np.float32)
    pt = np.full((b, J), -1, np.int32)
    blocks, n = rng.permutation(pool), 0
    for i, c in enumerate(clen):
        for j in range(-(-c // page)):
            pt[i, j] = blocks[n]
            n += 1
    if hole:
        pt[0, 1] = -1
    return q, kp, vp, pt, np.asarray(clen, np.int32)


CASES = {
    # name: (clen, n_q, n_kv, hd, page, J, hole)
    "tails-g3": ([37, 64, 5, 50], 6, 2, 16, 8, 8, False),
    "hole-empty-one-g3": ([61, 0, 1, 33], 6, 2, 64, 8, 8, True),
    "g1-hd64": ([16, 9, 31], 2, 2, 64, 4, 8, False),
    "g8-hd16": ([29, 3], 8, 1, 16, 4, 8, True),
    "hole-tail-g8-hd64": ([47, 1, 0], 8, 1, 64, 16, 3, True),
}


def _jax(q, kp, vp, pt, cl):
    return np.asarray(jax_paged(jnp.asarray(q)[:, None], kp, vp,
                                jnp.asarray(pt), jnp.asarray(cl),
                                interpret=True))[:, 0]


@pytest.mark.parametrize("splits", [1, 2, 3, 8, 40])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_ref_matches_pallas(case, splits):
    clen, n_q, n_kv, hd, page, J, hole = CASES[case]
    q, kp, vp, pt, cl = _inputs(len(case) + splits, clen, n_q, n_kv, hd,
                                page, J, hole)
    want = _jax(q, jnp.asarray(kp), jnp.asarray(vp), pt, cl)
    got = pa_ref.paged_attention_split_ref(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pt), torch.from_numpy(cl), splits)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for i, c in enumerate(clen):
        if c == 0:                      # a lane with no live position
            assert float(got[i].abs().max()) == 0.0


@pytest.mark.parametrize("splits", [1, 3, 8, 40])
def test_split_ref_bf16_pool_matches_pallas(splits):
    clen, n_q, n_kv, hd, page, J, hole = CASES["hole-empty-one-g3"]
    q, kp, vp, pt, cl = _inputs(11 + splits, clen, n_q, n_kv, hd, page, J,
                                hole)
    kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (kp, vp))
    want = _jax(q, kb, vb, pt, cl)
    got = pa_ref.paged_attention_split_ref(
        torch.from_numpy(q),
        torch.from_numpy(np.asarray(kb, np.float32)).bfloat16(),
        torch.from_numpy(np.asarray(vb, np.float32)).bfloat16(),
        torch.from_numpy(pt), torch.from_numpy(cl), splits)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize("splits", [2, 8])
def test_split_ref_matches_unsplit_plain_version(splits):
    """More splits than the short lanes have pages: the empty states drop
    out of the merge, and the result is the plain version's."""
    q, kp, vp, pt, cl = (torch.from_numpy(a) for a in _inputs(
        5, [1056, 17, 1, 0], 15, 5, 16, 16, 66))
    got = pa_ref.paged_attention_split_ref(q, kp, vp, pt, cl, splits)
    want = pa_ref.paged_attention_fwd_ref(q, kp, vp, pt, cl)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert float(got[3].abs().max()) == 0.0


@pytest.mark.parametrize("b,n_kv,J,page", [
    (4, 5, 66, 16),       # the smollm serve's decode shape
    (4, 5, 128, 16),      # every lane at 2048 tokens
    (1, 1, 1, 16), (2, 1, 8, 64), (4, 2, 4, 4), (64, 8, 256, 16),
    (1, 8, 4096, 16),
])
def test_pa_splits_from_shapes(b, n_kv, J, page):
    assert list(inspect.signature(pa.pa_splits).parameters) == [
        "b", "n_kv", "J", "page"]
    n = pa.pa_splits(b, n_kv, J, page)
    assert isinstance(n, int) and n >= 1
    assert n == pa.pa_splits(b, n_kv, J, page)
    if n > 1:                            # a split holds 2 pages or more
        assert J // n >= 2
    if (b, n_kv, J, page) == (4, 5, 66, 16):
        assert b * n_kv * n >= pa.SMS     # at least one block an SM
        assert -(-J // n) >= 2 and J // n >= 2


def test_cpu_wrapper_runs_the_plain_version_at_any_split(monkeypatch):
    """On the CPU the wrapper takes the plain version, whatever split count
    ``pa_splits`` gives: the split changes the order of arithmetic only."""
    q, kp, vp, pt, cl = (torch.from_numpy(a) for a in _inputs(
        7, [40, 9], 6, 2, 16, 8, 8))
    want = pa_ref.paged_attention_fwd_ref(q, kp, vp, pt, cl)
    assert torch.equal(pa.paged_attention_fwd(q, kp, vp, pt, cl), want)
    for splits in (1, 3):
        monkeypatch.setattr(pa, "pa_splits", lambda *shape: splits)
        assert torch.equal(pa.paged_attention_fwd(q, kp, vp, pt, cl), want)
