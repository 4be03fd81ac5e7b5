"""The scan attention's flash backward (``models.layers._FlashScan``)
against the reference's (``repro.models.layers._flash_vjp``, taken by
``jax.grad`` of ``flash_attention(impl="scan")``) on the CPU.

The same numpy inputs and output cotangent go through both; dq, dk and dv
agree within 1e-5 of each leaf's largest entry (fp32 inputs), and within
one bf16 ulp of it for bf16 inputs (the grads are rounded to bf16 once,
from fp32 sums that agree to 1e-5).  The cases: sliding window, GQA, 3-D
and 4-D block masks, a ragged ``sk`` (a partial last kv block), a query
offset, fully masked rows and bf16 inputs.  The port's old path (torch
autograd through the forward loop) gives the same grads, and saves the
per-block scores the new path does not.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(1)

# name: (b, sq, sk, h, kv, d, kv_block, kwargs, mask)
CASES = {
    "dense_causal": (2, 32, 32, 4, 4, 16, 8, dict(causal=True), None),
    "gqa_window": (1, 40, 40, 8, 2, 16, 8,
                   dict(causal=True, sliding_window=12), None),
    "ragged_sk_offset": (1, 12, 37, 4, 2, 8, 16,
                         dict(causal=True, q_offset=25), None),
    "mask3d": (2, 32, 32, 4, 2, 16, 8, dict(causal=True), "h"),
    "mask4d_dead_rows": (2, 32, 32, 4, 2, 16, 8, dict(causal=False),
                         "dead"),
    "mask4d_b1": (2, 40, 40, 4, 2, 16, 8, dict(causal=True), "b1"),
}


def _mask(kind, rng, b, h, sq, sk, blk):
    nq, nk = -(-sq // blk), -(-sk // blk)
    if kind is None:
        return None
    if kind == "h":
        return (rng.rand(h, nq, nk) < 0.6).astype(np.float32)
    if kind == "b1":
        # one row and one column short: the last blocks reuse the last
        return (rng.rand(b, 1, nq - 1, nk - 1) < 0.6).astype(np.float32)
    m = (rng.rand(b, h, nq, nk) < 0.6).astype(np.float32)
    m[0, 1, 2, :] = 0.0           # a query block with no key: dead rows
    m[1, :, 0, :] = 0.0
    return m


def _inputs(name, dtype):
    b, sq, sk, h, kv, d, blk, kw, mk = CASES[name]
    rng = np.random.RandomState(len(name))
    q = (rng.randn(b, sq, h, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, sk, kv, d) * 0.5).astype(np.float32)
    v = rng.randn(b, sk, kv, d).astype(np.float32)
    g = rng.randn(b, sq, h, d).astype(np.float32)
    if dtype == "bfloat16":
        # values exact in bf16, so both sides start from the same inputs
        q, k, v, g = (np.asarray(jnp.asarray(x, jnp.bfloat16)
                                 .astype(jnp.float32)) for x in (q, k, v, g))
    return (q, k, v, g, _mask(mk, rng, b, h, sq, sk, blk),
            dict(kw, kv_block=blk))


def _jax_grads(q, k, v, g, bm, kw, dtype):
    dt = jnp.dtype(dtype)

    def f(q, k, v):
        out = JL.flash_attention(q, k, v, impl="scan",
                                 block_mask=None if bm is None
                                 else jnp.asarray(bm), **kw)
        return jnp.sum(out.astype(jnp.float32) * g)
    args = [jnp.asarray(x, dt) for x in (q, k, v)]
    return [np.asarray(t.astype(jnp.float32))
            for t in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _torch_grads(q, k, v, g, bm, kw, dtype, fn=None):
    dt = getattr(torch, dtype)
    ts = [torch.tensor(x).to(dt).requires_grad_(True) for x in (q, k, v)]
    mask = None if bm is None else torch.tensor(bm)
    if fn is None:
        out = TL.flash_attention(*ts, impl="scan", block_mask=mask, **kw)
    else:
        out = fn(*ts, mask, **kw)
    (out.float() * torch.tensor(g)).sum().backward()
    return [t.grad.float().numpy() for t in ts]


def _old_path(q, k, v, block_mask, *, causal, kv_block, sliding_window=0,
              q_offset=0):
    """The port's path before ``_FlashScan``: autograd through the forward
    loop."""
    return TL._flash_fwd_impl(q, k, v, block_mask, causal, sliding_window,
                              q_offset, kv_block)[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_scan_grads_match_the_reference_flash_backward(name, dtype):
    q, k, v, g, bm, kw = _inputs(name, dtype)
    want = _jax_grads(q, k, v, g, bm, kw, dtype)
    got = _torch_grads(q, k, v, g, bm, kw, dtype)
    for leaf, a, b in zip("qkv", got, want):
        top = float(np.abs(b).max())
        assert top > 0, leaf
        tol = 1e-5 * top if dtype == "float32" else 2.0 ** -8 * top
        err = float(np.abs(a - b).max())
        assert err <= tol, (leaf, err, tol)


@pytest.mark.parametrize("name", list(CASES))
def test_scan_grads_match_the_old_autograd_path(name):
    q, k, v, g, bm, kw = _inputs(name, "float32")
    new = _torch_grads(q, k, v, g, bm, kw, "float32")
    old = _torch_grads(q, k, v, g, bm, kw, "float32", fn=_old_path)
    for a, b in zip(new, old):
        np.testing.assert_allclose(a, b, atol=1e-5 * float(np.abs(b).max()))


def test_the_scan_saves_inputs_out_and_lse_not_per_block_scores():
    """Bytes saved for the backward in one forward: the new path keeps
    q, k, v, out and lse (O(b s h d)); the old one kept every kv block's
    scores and probabilities (O(b h sq sk))."""
    b, s, h, kv, d, blk = 1, 256, 4, 2, 16, 32
    q = torch.randn(b, s, h, d, requires_grad=True)
    k = torch.randn(b, s, kv, d, requires_grad=True)
    v = torch.randn(b, s, kv, d, requires_grad=True)

    def saved(fn):
        seen = {}

        def pack(t):
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage()\
                .nbytes()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(q, k, v, None, causal=True, kv_block=blk)
        return sum(seen.values())

    def new(q, k, v, bm, **kw):
        return TL.flash_attention(q, k, v, impl="scan", block_mask=bm, **kw)

    io = 4 * (2 * b * s * h * d + 2 * b * s * kv * d + b * h * s)
    assert saved(new) <= io
    scores = 4 * b * h * s * s
    assert saved(_old_path) >= scores
