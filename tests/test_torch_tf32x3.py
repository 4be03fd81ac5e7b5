"""The 3xTF32 arithmetic of the tensor-core kernels (K3, K2b), modelled on
the CPU by ``repro_torch.kernels.tf32x3`` and held to fp32 here.

``split_tf32`` rounds on the fp32 bits as ``cvt.rna.tf32.f32`` does; the
3-term product hi·hi + hi·lo + lo·hi must land within K3's fp32 tolerance
(2e-4, as ``test_torch_cuda.py`` holds the kernel to its plain version) of
a float64 product and of the JAX package's ``pruned_matmul_p`` run in
interpret mode, under a mask over N and over K with a ragged M.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.pruned_matmul import pruned_matmul as jax_pm  # noqa: E402
from repro_torch.kernels.tf32x3 import (split_tf32, tf32x3_matmul_ref,  # noqa: E402
                                        to_tf32)

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
