"""Gradients of the port's kernel ops against the JAX package's.

The port's ``block_sparse_attention`` (K1 forward, K2a / K2b backward) and
``pruned_matmul`` / ``pruned_swiglu`` (K3 forward and backward products)
run here on CPU tensors, i.e. through their plain versions inside the same
autograd Functions the card uses.  The reference runs its Pallas kernels in
interpret mode under ``jax.grad``, as ``tests/test_kernel_grads.py`` does;
the cases mirror that file's oracles (density sweep with GQA and a
non-multiple length, fully masked rows with zero gradients, non-causal
rectangular attention, pruned-matmul and SwiGLU grads for both mask slots).
Each plain backward is also held to torch autograd of its plain forward.
Tolerance: fp32 on both sides, the two differ only in summation order —
atol 1e-5 (attention, |grad| up to ~10) and 2e-5 (matmuls over K up to
512).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.block_sparse_attention import (  # noqa: E402
    block_sparse_attention as jbsa)
from repro.kernels.pruned_matmul import pruned_matmul as jpm  # noqa: E402
from repro.kernels.pruned_matmul import pruned_swiglu as jswiglu  # noqa: E402
from repro_torch.kernels.block_sparse_attention import ops as bsa  # noqa: E402
from repro_torch.kernels.block_sparse_attention import ref as bsa_ref  # noqa: E402
from repro_torch.kernels.pruned_matmul import ops as pm  # noqa: E402
from repro_torch.kernels.pruned_matmul import ref as pm_ref  # noqa: E402
from repro_torch.kernels.pruned_matmul.backward import (  # noqa: E402
    pruned_matmul_bwd)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(True)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _attention_case(rng, b, sq, sk, hq, hkv, d, blk, density):
    q = rng.randn(b, sq, hq, d).astype(np.float32) * 0.4
    k = rng.randn(b, sk, hkv, d).astype(np.float32) * 0.4
    v = rng.randn(b, sk, hkv, d).astype(np.float32) * 0.4
    mask = (rng.rand(b, hq, -(-sq // blk), -(-sk // blk))
            <= density).astype(np.int32)
    return q, k, v, mask


def _attention_grads(q, k, v, mask, blk, causal):
    """(jax grads, port grads) of sum(sin(attention))."""
    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jbsa(q, k, v, jnp.asarray(mask),
                                    causal=causal, block_q=blk, block_k=blk,
                                    interpret=True)))

    want = jax.grad(jloss, (0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q), _t(k), _t(v)
    out = bsa.block_sparse_attention(tq, tk, tv, torch.from_numpy(mask),
                                     causal=causal, block=blk)
    got = torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv))
    return want, got


@pytest.mark.parametrize("density", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("s,hq,hkv", [(128, 2, 2), (256, 4, 2), (192, 4, 1)])
def test_attention_grads_match_reference(density, s, hq, hkv):
    rng = np.random.RandomState(int(density * 100) + s)
    q, k, v, mask = _attention_case(rng, 2, s, s, hq, hkv, 32, 64, density)
    want, got = _attention_grads(q, k, v, mask, 64, True)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_attention_fully_masked_rows_have_zero_grads():
    rng = np.random.RandomState(3)
    q, k, v, mask = _attention_case(rng, 1, 128, 128, 2, 2, 32, 64, 1.0)
    mask[:, :, 1, :] = 0                     # rows 64..127 see nothing
    want, got = _attention_grads(q, k, v, mask, 64, True)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w, 1e-5)
    assert float(got[0][:, 64:].abs().max()) == 0.0
    mask[:] = 0
    _, got = _attention_grads(q, k, v, mask, 64, True)
    for g in got:
        assert float(g.abs().max()) == 0.0


@pytest.mark.parametrize("density", [1.0, 0.5])
def test_noncausal_rectangular_attention_grads(density):
    rng = np.random.RandomState(int(density * 7))
    q, k, v, mask = _attention_case(rng, 2, 48, 80, 2, 2, 16, 32, density)
    want, got = _attention_grads(q, k, v, mask, 32, False)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_backward_is_autograd_of_plain_forward(causal):
    rng = np.random.RandomState(11)
    q, k, v, mask = _attention_case(rng, 2, 100, 100, 4, 2, 16, 32, 0.6)
    mask[:, :, 1, :] = 0
    tq, tk, tv = _t(q), _t(k), _t(v)
    tm = torch.from_numpy(mask)
    out, lse = bsa_ref.block_sparse_attention_ref(tq, tk, tv, tm,
                                                  causal=causal, block=32)
    dout = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    want = torch.autograd.grad((out * dout).sum(), (tq, tk, tv))
    delta = (dout * out).sum(-1).transpose(1, 2).detach()
    got = bsa_ref.block_sparse_attention_bwd_ref(
        tq.detach(), tk.detach(), tv.detach(), tm, dout, lse.detach(), delta,
        causal=causal, block=32)
    for g, w in zip(got, want):
        _close(g, w.numpy(), 1e-5)


@pytest.mark.parametrize("mask_axis", ["n", "k"])
@pytest.mark.parametrize("density", [1.0, 0.5, 0.25])
def test_pruned_matmul_grads_match_reference(mask_axis, density):
    rng = np.random.RandomState(int(density * 10))
    M, K, N = 100, 256, 384
    x = rng.randn(M, K).astype(np.float32) * 0.2
    w = rng.randn(K, N).astype(np.float32) * 0.2
    nb = (N if mask_axis == "n" else K) // 128
    keep = max(1, int(round(nb * density)))
    mask = np.array([1] * keep + [0] * (nb - keep), np.float32)

    want = jax.grad(lambda x, w: jnp.sum(jnp.cos(jpm(
        x, w, jnp.asarray(mask), mask_axis=mask_axis, interpret=True))),
        (0, 1))(x, w)
    tx, tw = _t(x), _t(w)
    out = pm.pruned_matmul(tx, tw, torch.from_numpy(mask),
                           mask_axis=mask_axis)
    got = torch.autograd.grad(torch.cos(out).sum(), (tx, tw))
    for g, w_ in zip(got, want):
        _close(g, w_, 2e-5)
    dead = np.repeat(mask, 128) == 0
    if mask_axis == "n":
        assert not got[1][:, dead].any()
    else:
        assert not got[1][dead].any()
        assert not got[0][:, dead].any()


@pytest.mark.parametrize("density", [1.0, 0.5])
def test_pruned_swiglu_grads_match_reference(density):
    rng = np.random.RandomState(int(density * 10) + 1)
    M, d, ff = 64, 128, 512
    x = rng.randn(M, d).astype(np.float32) * 0.3
    ws = [rng.randn(*sh).astype(np.float32) * 0.05
          for sh in ((d, ff), (d, ff), (ff, d))]
    nb = ff // 128
    keep = max(1, int(round(nb * density)))
    mask = np.array([1] * keep + [0] * (nb - keep), np.float32)
    want = jax.grad(lambda *a: jnp.sum(jswiglu(
        *a, jnp.asarray(mask), interpret=True) ** 2), (0, 1, 2, 3))(x, *ws)
    tx, *tws = _t(x), *(_t(w) for w in ws)
    out = pm.pruned_swiglu(tx, *tws, torch.from_numpy(mask))
    got = torch.autograd.grad((out ** 2).sum(), (tx, *tws))
    for g, w_ in zip(got, want):
        _close(g, w_, 2e-5)


@pytest.mark.parametrize("mask_axis", ["n", "k"])
def test_plain_pruned_matmul_backward_is_autograd_of_plain_forward(
        mask_axis):
    rng = np.random.RandomState(5)
    x, w = _t(rng.randn(37, 256) * 0.3), _t(rng.randn(256, 384) * 0.1)
    nb = (384 if mask_axis == "n" else 256) // 128
    mask = torch.tensor([1.0, 0.0, 1.0][:nb])
    out = pm_ref.pruned_matmul_ref(x, w, mask, mask_axis=mask_axis)
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    want = torch.autograd.grad((out * g).sum(), (x, w))
    got = pruned_matmul_bwd(x.detach(), w.detach(), mask, g,
                            mask_axis=mask_axis, blk=128)
    for a, b in zip(got, want):
        _close(a, b.numpy(), 1e-5)
    dx, dw = pruned_matmul_bwd(x.detach(), w.detach(), mask, g,
                               mask_axis=mask_axis, blk=128, need_dx=False)
    assert dx is None and torch.equal(dw, got[1])
