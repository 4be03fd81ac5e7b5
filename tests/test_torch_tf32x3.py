"""The 3xTF32 arithmetic of the tensor-core kernels (K1, K2a, K2b, K3),
modelled on the CPU by ``repro_torch.kernels.tf32x3`` and held to fp32
here.

``split_tf32`` rounds on the fp32 bits as ``cvt.rna.tf32.f32`` does; the
3-term product hi·hi + hi·lo + lo·hi must land within K3's fp32 tolerance
(2e-4, as ``test_torch_cuda.py`` holds the kernel to its plain version) of
a float64 product and of the JAX package's ``pruned_matmul_p`` run in
interpret mode, under a mask over N and over K with a ragged M.

The attention models (K1's forward, K2a's dq: per 64-row kv tile, each
product summed from zero and added in fp32 through the online softmax's
rescale or dq's running sum) are held to the JAX package's block-sparse
attention and its gradient, run in interpret mode as
``tests/test_kernel_grads.py`` runs them, on the same seeded inputs: GQA
4/2, d 16, 32 and 64, ragged lengths with a fully masked q block, mask
blocks of 32 (cut inside the 64-row tile: the per-element path) and 128,
causal and not.  Tolerances are the ones ``chip_smoke.py`` holds the
kernels to: K1 1e-4 absolute plus 1e-4 relative, K2a 2e-4 of dq's largest
entry.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.block_sparse_attention import (  # noqa: E402
    block_sparse_attention as jax_bsa)
from repro.kernels.block_sparse_attention.block_sparse_attention import (  # noqa: E402
    block_sparse_attention_p)
from repro.kernels.pruned_matmul import pruned_matmul as jax_pm  # noqa: E402
from repro_torch.kernels.block_sparse_attention import ref as bsa_ref  # noqa: E402
from repro_torch.kernels.tf32x3 import (bsa_dq_tf32x3_ref,  # noqa: E402
                                        bsa_fwd_tf32x3_ref, split_tf32,
                                        tf32x3_matmul_ref, to_tf32)

torch.set_num_threads(1)


def _bits(t):
    return t.float().view(torch.int32)


def _values(seed, n=4096):
    """fp32 values over a wide exponent range, both signs, plus ties."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n) * np.exp2(rng.randint(-60, 60, size=n))
    x = torch.from_numpy(x.astype(np.float32))
    # exact ties: 1 + 2^-11 (and its negative, and scaled) round away
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 3 * 2 ** -11 + 1,
                         (1 + 2 ** -11) * 2 ** 20], dtype=torch.float32)
    return torch.cat([x, ties])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_zeroes_the_low_13_bits(seed):
    hi, lo = split_tf32(_values(seed))
    assert bool(((_bits(hi) & 0x1FFF) == 0).all())
    assert bool(((_bits(lo) & 0x1FFF) == 0).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_residual_is_below_2_to_the_minus_22(seed):
    x = _values(seed)
    hi, lo = split_tf32(x)
    res = (x.double() - hi.double() - lo.double()).abs()
    assert bool((res <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("x,hi", [
    (1 + 2 ** -11, 1 + 2 ** -10),          # a tie rounds away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 2 ** -12, 1.0),                   # below the tie: down
    (1 + 3 * 2 ** -12, 1 + 2 ** -10),      # above it: up
])
def test_round_to_nearest_ties_away(x, hi):
    got = to_tf32(torch.tensor([x], dtype=torch.float32))
    assert float(got[0]) == hi


@pytest.mark.parametrize("x,hi_kind", [
    (float("inf"), "inf"), (float("-inf"), "-inf"), (float("nan"), "nan"),
    (3.4028234663852886e38, "inf"),        # FLT_MAX rounds up to inf
    (-3.4028234663852886e38, "-inf"),
])
def test_non_finite_hi_gets_a_zero_lo(x, hi_kind):
    hi, lo = split_tf32(torch.tensor([x], dtype=torch.float32))
    h = float(hi[0])
    if hi_kind == "nan":
        assert h != h
    else:
        assert h == float(hi_kind)
    assert float(lo[0]) == 0.0


@pytest.mark.parametrize("bad,want", [
    (float("inf"), float("inf")), (float("-inf"), float("-inf")),
    (3.4028234663852886e38, 3.4028234663852886e38 + 1.5),   # FLT_MAX
])
def test_non_finite_rows_take_the_plain_fp32_product(bad, want):
    """An operand the split cannot carry (inf, NaN, or a value whose hi
    would round to inf) sends its outputs to the plain fp32 product, so inf
    stays inf; the other rows keep the 3-term product."""
    x = torch.tensor([[1.5, bad], [2.0, 3.0]])
    w = torch.tensor([[1.0], [1.0]])
    out = tf32x3_matmul_ref(x, w, torch.ones(1), mask_axis="n", blk=1)
    assert float(out[0, 0]) == float(torch.tensor(want, dtype=torch.float32))
    assert float(out[1, 0]) == 5.0
    nan = tf32x3_matmul_ref(torch.tensor([[float("nan"), 1.0]]), w,
                            torch.ones(1), mask_axis="n", blk=1)
    assert bool(torch.isnan(nan).all())


@pytest.mark.parametrize("M,K,N,axis,density", [
    (37, 256, 384, "n", 0.5),
    (200, 384, 256, "k", 0.5),
    (129, 256, 256, "n", 1.0),
    (65, 512, 128, "k", 0.25),
])
def test_three_term_product_is_fp32_accurate(M, K, N, axis, density):
    rng = np.random.RandomState(M + K + N)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * K ** -0.5).astype(np.float32)
    nb = (N if axis == "n" else K) // 128
    mask = (rng.rand(nb) < density).astype(np.float32)
    mask[0] = 1.0
    got = tf32x3_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(mask), mask_axis=axis, blk=128)
    m = np.repeat(mask.astype(np.float64), 128)
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    exact = ((x64 @ w64) * m[None, :] if axis == "n"
             else (x64 * m[None, :]) @ w64)
    np.testing.assert_allclose(got.numpy(), exact, atol=2e-4, rtol=2e-4)
    # the 3-term error is far inside one TF32 pass's
    one_pass = (to_tf32(torch.from_numpy(x)).double()
                @ to_tf32(torch.from_numpy(w)).double()).numpy()
    if axis == "n":
        one_pass = one_pass * m[None, :]
    else:
        one_pass = ((to_tf32(torch.from_numpy(x)).double().numpy()
                     * m[None, :]) @ to_tf32(torch.from_numpy(w)).double()
                    .numpy())
    assert (np.abs(got.numpy() - exact).max()
            < 0.05 * np.abs(one_pass - exact).max())
    kw = dict(bn=128) if axis == "n" else dict(bk=128)
    want = jax_pm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask),
                  mask_axis=axis, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64),
                               atol=2e-4, rtol=2e-4)


# (label, s, mask block): a ragged length whose mask blocks (32) cut the
# 64-row kernel tile, and one with 128-blocks and a ragged last block
ATTN_CASES = [("s100 blk32", 100, 32), ("s200 blk128", 200, 128)]
ATTN_B, ATTN_HQ, ATTN_HKV = 2, 4, 2


def _attention_inputs(s, d, block, causal):
    rng = np.random.RandomState(s + d + block + causal)
    q, k, v = ((rng.randn(ATTN_B, s, h, d) * 0.5).astype(np.float32)
               for h in (ATTN_HQ, ATTN_HKV, ATTN_HKV))
    n = -(-s // block)
    mask = (rng.rand(ATTN_B, ATTN_HQ, n, n) < 0.7).astype(np.int32)
    mask[:, :, 1, :] = 0                    # a fully masked q block
    dout = rng.randn(ATTN_B, s, ATTN_HQ, d).astype(np.float32)
    return q, k, v, mask, dout


def _jax_attention(q, k, v, mask, causal, block):
    return lambda q_: jax_bsa(q_, jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), causal=causal,
                              block_q=block, block_k=block, interpret=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("label,s,block", ATTN_CASES)
def test_attention_forward_model_matches_pallas(label, s, block, d, causal):
    q, k, v, mask, _ = _attention_inputs(s, d, block, causal)
    out, lse = bsa_fwd_tf32x3_ref(*map(torch.from_numpy, (q, k, v, mask)),
                                  causal=causal, block=block)
    want = _jax_attention(q, k, v, mask, causal, block)(jnp.asarray(q))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # the lse from the kernel itself, flattened and padded like its wrapper
    n = -(-s // block)
    rep = ATTN_HQ // ATTN_HKV

    def flat(a, r=1):
        a = np.pad(np.repeat(a, r, axis=2),
                   ((0, 0), (0, n * block - s), (0, 0), (0, 0)))
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(
            ATTN_B * ATTN_HQ, n * block, d))
    _, klse = block_sparse_attention_p(
        flat(q), flat(k, rep), flat(v, rep),
        jnp.asarray(mask.reshape(ATTN_B * ATTN_HQ, n, n)), causal=causal,
        block_q=block, block_k=block, kv_len=s, interpret=True)
    klse = np.asarray(klse).reshape(ATTN_B, ATTN_HQ, n * block)[:, :, :s]
    live = klse > -1e29
    np.testing.assert_allclose(lse.numpy()[live], klse[live], atol=1e-4,
                               rtol=1e-4)
    assert (lse.numpy()[~live] < -1e29).all()
    # the fully masked q block: zeros
    assert float(out[:, block:2 * block].abs().max()) == 0.0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("label,s,block", ATTN_CASES)
def test_attention_dq_model_matches_pallas(label, s, block, d, causal):
    q, k, v, mask, dout = _attention_inputs(s, d, block, causal)
    tq, tk, tv, tm, tdo = map(torch.from_numpy, (q, k, v, mask, dout))
    # K1 then K2a, as the card runs them: delta from K1's output
    out, lse = bsa_fwd_tf32x3_ref(tq, tk, tv, tm, causal=causal, block=block)
    delta = (tdo * out).sum(-1).transpose(1, 2).contiguous()
    got = bsa_dq_tf32x3_ref(tq, tk, tv, tm, tdo, lse, delta, causal=causal,
                            block=block)
    _, vjp = jax.vjp(_jax_attention(q, k, v, mask, causal, block),
                     jnp.asarray(q))
    want = np.asarray(vjp(jnp.asarray(dout))[0])
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 2e-4 * scale
    assert float(got[:, block:2 * block].abs().max()) == 0.0


@pytest.mark.parametrize("which", ["forward", "dq"])
def test_attention_models_are_fp32_accurate(which):
    """At least as close to a float64 computation as twice the plain fp32
    version's distance (the criterion chip_smoke.py holds the kernels to
    at the main shapes), causal, dense, d 64."""
    s, d, block = 256, 64, 128
    q, k, v, _, dout = _attention_inputs(s, d, block, True)
    mask = torch.ones((1, 1, 2, 2), dtype=torch.int32)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = bsa_fwd_tf32x3_ref(tq, tk, tv, mask, block=block)
    if which == "forward":
        got = out
        plain, _ = bsa_ref.block_sparse_attention_ref(tq, tk, tv, mask,
                                                      block=block)
        exact, _ = bsa_ref.block_sparse_attention_ref(
            tq, tk, tv, mask, block=block, compute_dtype=torch.float64)
    else:
        delta = (tdo * out).sum(-1).transpose(1, 2).contiguous()
        args = (tq, tk, tv, mask, tdo, lse, delta)
        got = bsa_dq_tf32x3_ref(*args, block=block)
        plain = bsa_ref.block_sparse_attention_bwd_dq_ref(*args, block=block)
        exact = bsa_ref.block_sparse_attention_bwd_dq_ref(
            *args, block=block, compute_dtype=torch.float64)
    got_64 = float((got.double() - exact).abs().max())
    plain_64 = float((plain.double() - exact).abs().max())
    assert got_64 <= 2 * plain_64, (got_64, plain_64)
