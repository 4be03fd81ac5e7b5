"""The port's CUDA kernels on the card, each against its plain PyTorch
version; reduced serves, trainings and live resizes on the card against
the same runs on the CPU.

Every test here needs a CUDA card and skips without one (the CPU tests in
``test_torch_kernels.py`` hold the plain versions to the JAX package).
Run on the card with ``PYTHONPATH=src python -m pytest -q
tests/test_torch_cuda.py``.
Tolerances: fp32 kernels vs plain at 1e-4 (attention, paged attention) and
2e-4 (pruned matmul over K up to 2560); the two differ only in summation
order.  The backward sweeps (K2a / K2b, K3's backward products) sum over
the sequence (up to 1024 rows) or the token count (up to 2048): 2e-4
relative to the largest entry in fp32, 3e-2 in bf16 (its 8-bit mantissa).
The grouped expert matmul (K4, K5) against its plain version: 1e-4
relative to the largest entry in fp32 (sums over K up to 4096 or over up to
640 routed rows), one bf16 rounding (2^-7 relative, plus 1e-2 absolute near
zero) when the output is bf16; a placement gives bitwise-equal results.
bf16 calls with cap > 16 and K, N multiples of 8 run the tensor-core
variant (wgmma on TMA-fed shared memory) under the same tolerances; each
case checks that the variant ``ops.gm_variant`` chose is the one that ran.
K3's tensor-core variant (3xTF32 ``mma.sync``) is held to the same fp32
tolerances in each of its five operand layouts, bf16 within one bf16
rounding; K2b (3xTF32 over a work schedule, fixed-order partial sums) at
2e-4 of the largest entry; both bitwise equal on a repeat.  K1 and K2a
run on the tensor cores (3xTF32) for every head dim (16, 32, 64, 128) and
both dtypes: every launch counts as a tensor-core launch, a repeat is
bitwise equal, and the results keep the tolerances above (bf16: 2e-2 for
K1 as chip_smoke.py holds it, 3e-2 of the largest entry for dq).  K6
(paged decode attention, its pages cut into splits merged in a fixed
order) is held at 1e-4 to both the unsplit plain version and the
split-order one at the same split count (bf16 output: one bf16 rounding),
bitwise on a repeat and under CUDA-graph replay.  A checkpoint of CUDA
state (fp32 and bf16) loads back onto the card bitwise; the in-step
CUDA-event stage timer and the probe both read an 8-layer stage above a
1-layer one; the asynchronous control plane with ``--async-drain`` is the
inline run bit for bit through a live shrink.
"""
import copy

import pytest
import torch

from repro_torch.kernels.block_sparse_attention import ops as bsa
from repro_torch.kernels.block_sparse_attention import ref as bsa_ref
from repro_torch.kernels.grouped_matmul import ops as gm
from repro_torch.kernels.grouped_matmul import ref as gm_ref
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.kernels.pruned_matmul import ops as pm
from repro_torch.kernels.pruned_matmul import ref as pm_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels build and run only "
                    "there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_block_sparse_attention_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for b, s, hq, hkv, d, block, causal in ((2, 300, 15, 5, 64, 128, True),
                                            (1, 1024, 15, 5, 64, 512, True),
                                            (2, 77, 4, 2, 16, 32, False)):
        q = torch.randn((b, s, hq, d), generator=g, device=cuda)
        k = torch.randn((b, s, hkv, d), generator=g, device=cuda)
        v = torch.randn((b, s, hkv, d), generator=g, device=cuda)
        n = -(-s // block)
        m = (torch.rand((b, hq, n, n), generator=g, device=cuda) < 0.6).int()
        before, tc0 = bsa.KERNEL.launches, bsa.KERNEL.launches_tc
        out, lse = bsa.block_sparse_attention_fwd(q, k, v, m, causal=causal,
                                                  block=block)
        assert bsa.KERNEL.launches == before + 1
        assert bsa.KERNEL.launches_tc == tc0 + 1
        rout, rlse = bsa_ref.block_sparse_attention_ref(q, k, v, m,
                                                        causal=causal,
                                                        block=block)
        torch.testing.assert_close(out, rout, atol=1e-4, rtol=1e-4)
        live = rlse > -1e29
        torch.testing.assert_close(lse[live], rlse[live], atol=1e-4,
                                   rtol=1e-4)


def test_pruned_matmul_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    for M, K, N, axis, blk in ((4096, 960, 2560, "n", 128),
                               (333, 2560, 960, "k", 128),
                               (50, 96, 70, "k", 48)):
        x = torch.randn((M, K), generator=g, device=cuda)
        w = torch.randn((K, N), generator=g, device=cuda) * K ** -0.5
        nb = (N if axis == "n" else K) // blk
        m = (torch.rand((nb,), generator=g, device=cuda) < 0.5).float()
        before = pm.KERNEL.launches
        out = pm.pruned_matmul(x, w, m, mask_axis=axis, bn=blk, bk=blk)
        assert pm.KERNEL.launches == before + 1
        want = pm_ref.pruned_matmul_ref(x, w, m, mask_axis=axis, bn=blk,
                                        bk=blk)
        torch.testing.assert_close(out, want, atol=2e-4, rtol=2e-4)


def _rel_close(got, want, rtol):
    """Every entry within ``rtol`` of the largest |entry| of ``want``."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("b,s,hq,hkv,d,block,dens,causal,dt", [
    (2, 1024, 15, 5, 64, 128, 1.0, True, torch.float32),
    (1, 1024, 15, 5, 64, 512, 0.5, True, torch.float32),
    (2, 300, 4, 2, 32, 128, 0.6, True, torch.float32),
    (2, 77, 4, 1, 16, 32, 0.5, False, torch.float32),
    (2, 256, 15, 5, 64, 128, 0.7, True, torch.bfloat16),
])
def test_attention_backward_matches_plain(cuda, b, s, hq, hkv, d, block,
                                          dens, causal, dt):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=cuda)
               .mul(0.5).to(dt) for h in (hq, hkv, hkv))
    n = -(-s // block)
    m = (torch.rand((b, hq, n, n), generator=g, device=cuda) < dens).int()
    m[:, :, min(1, n - 1), :] = 0                  # fully masked q rows
    out, lse = bsa.block_sparse_attention_fwd(q, k, v, m, causal=causal,
                                              block=block)
    dout = torch.randn(out.shape, generator=g, device=cuda).to(dt)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    n_dq, n_dkv = bsa.KERNEL_DQ.launches, bsa.KERNEL_DKV.launches
    got = bsa.block_sparse_attention_bwd(q, k, v, m, dout, lse, delta,
                                         causal=causal, block=block)
    assert bsa.KERNEL_DQ.launches == n_dq + 1
    assert bsa.KERNEL_DKV.launches == n_dkv + 1
    want = bsa_ref.block_sparse_attention_bwd_ref(q, k, v, m, dout, lse,
                                                  delta, causal=causal,
                                                  block=block)
    rows = slice(block * min(1, n - 1), block * min(2, n))
    assert float(got[0][:, rows].abs().max()) == 0.0   # masked rows: dq 0
    for a, w_ in zip(got, want):
        assert a.dtype == dt
        _rel_close(a, w_, 2e-4 if dt == torch.float32 else 3e-2)


@pytest.mark.parametrize("axis", ["n", "k"])
@pytest.mark.parametrize("M,K,N,dens", [(2048, 960, 2560, 1.0),
                                        (2048, 960, 2560, 0.13),
                                        (333, 256, 384, 0.5)])
def test_pruned_matmul_backward_matches_plain(cuda, axis, M, K, N, dens):
    from repro_torch.kernels.pruned_matmul.backward import pruned_matmul_bwd
    if axis == "k":
        K, N = N, K
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((M, K), generator=g, device=cuda)
    w = torch.randn((K, N), generator=g, device=cuda) * K ** -0.5
    gr = torch.randn((M, N), generator=g, device=cuda)
    nb = (N if axis == "n" else K) // 128
    m = (torch.rand((nb,), generator=g, device=cuda) < dens).float()
    m[0] = 1.0
    n0, b0 = pm.KERNEL.launches, pm.KERNEL.launches_bwd
    dx, dw = pruned_matmul_bwd(x, w, m, gr, mask_axis=axis, blk=128)
    assert (pm.KERNEL.launches, pm.KERNEL.launches_bwd) == (n0 + 2, b0 + 2)
    me = m.repeat_interleave(128)
    if axis == "n":
        wx, ww = (gr * me) @ w.T, x.T @ (gr * me)
    else:
        wx, ww = (gr @ w.T) * me, (x.T @ gr) * me[:, None]
    _rel_close(dx, wx, 2e-4)
    _rel_close(dw, ww, 2e-4)
    dead = me == 0
    if axis == "n":
        assert not dw[:, dead].any()
    else:
        assert not dx[:, dead].any()
        assert not dw[dead].any()


def test_pruned_matmul_backward_bf16(cuda):
    """bf16 weights and activations: the backward products run in fp32 on
    exactly upcast operands, their results rounded to bf16 once."""
    from repro_torch.kernels.pruned_matmul.backward import pruned_matmul_bwd
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((512, 256), generator=g, device=cuda).bfloat16()
    w = (torch.randn((256, 384), generator=g, device=cuda) * 0.06).bfloat16()
    gr = torch.randn((512, 384), generator=g, device=cuda)
    m = torch.tensor([1.0, 0.0, 1.0], device=cuda)
    dx, dw = pruned_matmul_bwd(x, w, m, gr, mask_axis="n", blk=128)
    assert (dx.dtype, dw.dtype) == (torch.bfloat16, torch.bfloat16)
    me = m.repeat_interleave(128)
    _rel_close(dx, (gr * me) @ w.float().T, 1e-2)
    _rel_close(dw, x.float().T @ (gr * me), 1e-2)


def _pm_layout(cuda, layout, axis, dt, M=333, D=256, F=384):
    """Operands of one K3 product as the forward or backward lays it out
    (``ops.pruned_matmul`` / ``backward.py``): (x view, w view, mask axis
    of the launch, out view or None, plain result in fp32)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    K, N = (D, F) if axis == "n" else (F, D)
    x = torch.randn((M, K), generator=g, device=cuda).to(dt)
    w = (torch.randn((K, N), generator=g, device=cuda) * K ** -0.5).to(dt)
    gr = torch.randn((M, N), generator=g, device=cuda).to(dt)
    m = torch.tensor([1.0, 0.0, 1.0], device=cuda)
    me = m.repeat_interleave(128)
    xf, wf, gf = x.float(), w.float(), gr.float()
    if layout == "fwd":
        want = xf @ wf * me if axis == "n" else (xf * me) @ wf
        return x, w, axis, None, want, m
    if layout == "dx":
        want = (gf * me) @ wf.T if axis == "n" else (gf @ wf.T) * me
        return gr, w.T, "k" if axis == "n" else "n", None, want, m
    if axis == "n":                                      # dw = xᵀ·(g ⊙ m)
        return x.T, gr, "n", None, xf.T @ gf * me, m
    out = torch.empty((K, N), dtype=dt, device=cuda)     # dw.T = gᵀ·x
    return gr.T, x, "n", out.T, gf.T @ xf * me[None, :], m


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["fwd", "dx", "dw"])
@pytest.mark.parametrize("axis", ["n", "k"])
def test_pruned_matmul_tensor_core_layouts(cuda, layout, axis, dt):
    """Each of K3's five operand layouts (and ``out=dw.T``) on the
    tensor-core variant, fp32 (3xTF32) and bf16 (one pass), against the
    plain product and bitwise equal on a repeat."""
    x, w, launch_axis, out, want, m = _pm_layout(cuda, layout, axis, dt)
    assert pm.pm_variant(dt, launch_axis, 128, x.stride(), w.stride()) == "tc"
    tc0 = pm.KERNEL.launches_tc
    got = pm.product(x, w, m, launch_axis, 128, out=out)
    again = pm.product(x, w, m, launch_axis, 128,
                       out=None if out is None else torch.empty_like(out))
    torch.cuda.synchronize()
    assert pm.KERNEL.launches_tc == tc0 + 2
    assert torch.equal(got, again)
    if dt == torch.float32:
        _rel_close(got, want, 2e-4)
    else:          # one bf16 rounding of an fp32 sum of exact products
        torch.testing.assert_close(got.float(), want, atol=1e-2,
                                   rtol=2 ** -7)


@pytest.mark.parametrize("bad", [float("inf"), float("nan"), 3.4e38])
def test_pruned_matmul_tensor_cores_pass_non_finite_as_fp32(cuda, bad):
    """An operand the 3xTF32 split cannot carry (inf, NaN, or so close to
    FLT_MAX that hi rounds to inf) sends its tile to plain fp32 sums: the
    inf / NaN pattern of the output is fp32's, the rest within 2e-4."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn((300, 256), generator=g, device=cuda)
    w = torch.randn((256, 384), generator=g, device=cuda) * 0.06
    x[5, 17] = bad
    m = torch.ones(3, device=cuda)
    tc0 = pm.KERNEL.launches_tc
    got = pm.product(x, w, m, "n", 128)
    torch.cuda.synchronize()
    assert pm.KERNEL.launches_tc == tc0 + 1
    want = x @ w
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("blk,axis", [(64, "n"), (48, "k")])
def test_pruned_matmul_simt_edge_blocks(cuda, blk, axis):
    """Mask blocks the tensor-core tile or chunk does not divide run the
    SIMT kernel, against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(8)
    M, K, N = 77, 192, 192
    x = torch.randn((M, K), generator=g, device=cuda)
    w = torch.randn((K, N), generator=g, device=cuda) * K ** -0.5
    m = (torch.arange((N if axis == "n" else K) // blk, device=cuda) % 2
         ).float()
    assert pm.pm_variant(x.dtype, axis, blk, x.stride(), w.stride()) == "simt"
    n0, tc0 = pm.KERNEL.launches, pm.KERNEL.launches_tc
    got = pm.pruned_matmul(x, w, m, mask_axis=axis, bn=blk, bk=blk)
    assert (pm.KERNEL.launches, pm.KERNEL.launches_tc) == (n0 + 1, tc0)
    torch.testing.assert_close(got, pm_ref.pruned_matmul_ref(
        x, w, m, mask_axis=axis, bn=blk, bk=blk), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_attention_fwd_and_dq_tensor_cores_bitwise(cuda, d, dt):
    """K1 and K2a on the tensor cores at every head dim and dtype: each
    launch counted as a tensor-core launch, a repeat bitwise equal, the
    plain versions' tolerances kept; a ragged length, a fully masked q
    block and a mask with dead blocks."""
    g = torch.Generator(device=cuda).manual_seed(d)
    b, s, hq, hkv, block = 2, 300, 4, 2, 128
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=cuda)
               .mul(0.5).to(dt) for h in (hq, hkv, hkv))
    n = -(-s // block)
    m = (torch.rand((b, hq, n, n), generator=g, device=cuda) < 0.7).int()
    m[:, :, 1, :] = 0
    fp32 = dt == torch.float32
    n0, tc0 = bsa.KERNEL.launches, bsa.KERNEL.launches_tc
    out, lse = bsa.block_sparse_attention_fwd(q, k, v, m, block=block)
    out2, lse2 = bsa.block_sparse_attention_fwd(q, k, v, m, block=block)
    torch.cuda.synchronize()
    assert (bsa.KERNEL.launches, bsa.KERNEL.launches_tc) == (n0 + 2,
                                                             tc0 + 2)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    rout, rlse = bsa_ref.block_sparse_attention_ref(q, k, v, m, block=block)
    tol = 1e-4 if fp32 else 2e-2
    torch.testing.assert_close(out.float(), rout.float(), atol=tol,
                               rtol=tol)
    live = rlse > -1e29
    torch.testing.assert_close(lse[live], rlse[live], atol=tol, rtol=tol)
    assert bool((lse[~live] < -1e29).all())
    assert float(out[:, block:2 * block].abs().max()) == 0.0
    dout = torch.randn(out.shape, generator=g, device=cuda).to(dt)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    n0, tc0 = bsa.KERNEL_DQ.launches, bsa.KERNEL_DQ.launches_tc
    dq = bsa.block_sparse_attention_bwd_dq(q, k, v, m, dout, lse, delta,
                                           block=block)
    dq2 = bsa.block_sparse_attention_bwd_dq(q, k, v, m, dout, lse, delta,
                                            block=block)
    torch.cuda.synchronize()
    assert (bsa.KERNEL_DQ.launches, bsa.KERNEL_DQ.launches_tc) == (
        n0 + 2, tc0 + 2)
    assert torch.equal(dq, dq2) and dq.dtype == dt
    rdq = bsa_ref.block_sparse_attention_bwd_dq_ref(q, k, v, m, dout, lse,
                                                    delta, block=block)
    _rel_close(dq, rdq, 2e-4 if fp32 else 3e-2)
    assert float(dq[:, block:2 * block].abs().max()) == 0.0


def test_attention_kernels_refuse_misaligned_fp32(cuda):
    """The fp32 tile loads are 16-byte cp.async copies: a view whose data
    is not 16-byte aligned is refused, not read."""
    q = torch.zeros(2 * 64 * 4 * 16 + 1, device=cuda)[1:].view(2, 64, 4, 16)
    k = torch.zeros((2, 64, 2, 16), device=cuda)
    m = torch.ones((1, 1, 1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        bsa.block_sparse_attention_fwd(q, k, k, m, block=64)


@pytest.mark.parametrize("case", ["dense", "dead-tiles", "masked-rows",
                                  "bf16"])
def test_attention_dkv_tensor_cores_bitwise(cuda, case):
    """K2b on the tensor cores over its schedule: against the plain
    version, every launch on the tensor-core variant, a repeat bitwise
    equal (fixed-order partial sums, no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    dt = torch.bfloat16 if case == "bf16" else torch.float32
    b, s, hq, hkv, d = 2, 1000 if case == "masked-rows" else 1024, 15, 5, 64
    block = 512 if case == "dead-tiles" else 128
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=cuda)
               .mul(0.5).to(dt) for h in (hq, hkv, hkv))
    n = -(-s // block)
    m = (torch.rand((b, 1, n, n), generator=g, device=cuda)
         < (0.5 if case == "dead-tiles" else 1.0)).int()
    m[..., 0, 0] = 1
    if case == "masked-rows":
        m[:, :, 2, :] = 0
    out, lse = bsa.block_sparse_attention_fwd(q, k, v, m, block=block)
    dout = torch.randn(out.shape, generator=g, device=cuda).to(dt)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    n0, tc0 = bsa.KERNEL_DKV.launches, bsa.KERNEL_DKV.launches_tc
    dk, dv = bsa.block_sparse_attention_bwd_dkv(q, k, v, m, dout, lse, delta,
                                                block=block)
    dk2, dv2 = bsa.block_sparse_attention_bwd_dkv(q, k, v, m, dout, lse,
                                                  delta, block=block)
    torch.cuda.synchronize()
    assert (bsa.KERNEL_DKV.launches, bsa.KERNEL_DKV.launches_tc) == (
        n0 + 2, tc0 + 2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    rdk, rdv = bsa_ref.block_sparse_attention_bwd_dkv_ref(
        q, k, v, m, dout, lse, delta, block=block)
    for got, want in ((dk, rdk), (dv, rdv)):
        assert got.dtype == dt
        _rel_close(got, want, 2e-4 if dt == torch.float32 else 3e-2)


def test_paged_attention_matches_plain(cuda):
    g = torch.Generator(device="cpu").manual_seed(2)
    page, J, pool, n_q, n_kv, hd = 4, 4, 12, 15, 5, 64
    for clen, hole in (([4, 7, 13, 16], False), ([9, 0, 3, 12], True)):
        b = len(clen)
        q = torch.randn((b, 1, n_q, hd), generator=g)
        kp, vp = (torch.randn((pool + 1, page, n_kv, hd), generator=g)
                  .bfloat16() for _ in range(2))
        pt = torch.full((b, J), -1, dtype=torch.int32)
        perm, n = torch.randperm(pool, generator=g), 0
        for i, c in enumerate(clen):
            for j in range(-(-c // page)):
                pt[i, j] = int(perm[n])
                n += 1
        if hole:
            pt[0, 1] = -1
        args = [t.to(cuda) for t in (q, kp, vp, pt,
                                     torch.tensor(clen, dtype=torch.int32))]
        before = pa.KERNEL.launches
        out = pa.paged_attention(*args)
        assert pa.KERNEL.launches == before + 1
        want = pa_ref.paged_attention_fwd_ref(args[0][:, 0], *args[1:])
        torch.testing.assert_close(out[:, 0], want, atol=1e-4, rtol=1e-4)


def _paged_case(cuda, seed, clen, n_q, n_kv, hd, page, J, kv_dt,
                hole=False, q_dt=torch.float32):
    g = torch.Generator(device="cpu").manual_seed(seed)
    pool = sum(-(-c // page) for c in clen) + 2
    q = torch.randn((len(clen), n_q, hd), generator=g).to(q_dt)
    kp, vp = (torch.randn((pool + 1, page, n_kv, hd), generator=g).to(kv_dt)
              for _ in range(2))
    pt = torch.full((len(clen), J), -1, dtype=torch.int32)
    perm, n = torch.randperm(pool, generator=g), 0
    for i, c in enumerate(clen):
        for j in range(-(-c // page)):
            pt[i, j] = int(perm[n])
            n += 1
    if hole:
        pt[0, 1] = -1
    return [t.to(cuda) for t in (q, kp, vp, pt,
                                 torch.tensor(clen, dtype=torch.int32))]


@pytest.mark.parametrize("clen,n_q,n_kv,hd,page,J,kv_dt,hole,q_dt", [
    # the serve's shape with lanes shorter than the split count
    ([1056, 17, 1, 0], 15, 5, 64, 16, 66, torch.bfloat16, False,
     torch.float32),
    ([61, 0, 1, 33], 6, 2, 64, 8, 8, torch.float32, True, torch.float32),
    ([29, 3], 8, 1, 16, 4, 8, torch.bfloat16, True, torch.float32),
    ([300, 129], 8, 1, 128, 64, 8, torch.bfloat16, False, torch.bfloat16),
    ([47, 1, 0], 16, 1, 32, 16, 3, torch.float32, True, torch.float32),
    ([16, 9, 31], 2, 2, 128, 4, 8, torch.float32, False, torch.float32),
])
def test_paged_attention_splits_match_plain(cuda, monkeypatch, clen, n_q,
                                            n_kv, hd, page, J, kv_dt, hole,
                                            q_dt):
    """K6 at split counts from 1 to more than a lane has pages, and at
    pa_splits' choice: within 1e-4 of the split-order plain version at the
    same count and of the unsplit plain version (bf16 out: one bf16
    rounding), bitwise equal on a repeat, empty lanes exactly 0, one launch
    a call, counted as split when it cut the pages."""
    q, kp, vp, pt, cl = _paged_case(cuda, len(clen) + hd, clen, n_q, n_kv,
                                    hd, page, J, kv_dt, hole, q_dt)
    want = pa_ref.paged_attention_fwd_ref(q.float(), kp, vp, pt, cl)
    tol = (dict(atol=1e-4, rtol=1e-4) if q_dt == torch.float32
           else dict(atol=1e-4, rtol=2 ** -8))
    for splits in (1, 2, 3, pa.pa_splits(len(clen), n_kv, J, page), 40):
        monkeypatch.setattr(pa, "pa_splits", lambda *shape: splits)
        n0, s0 = pa.KERNEL.launches, pa.KERNEL.launches_split
        out = pa.paged_attention_fwd(q, kp, vp, pt, cl)
        again = pa.paged_attention_fwd(q, kp, vp, pt, cl)
        torch.cuda.synchronize()
        assert pa.KERNEL.launches == n0 + 2
        assert pa.KERNEL.launches_split == s0 + (2 if splits > 1 else 0)
        assert torch.equal(out, again)
        split = pa_ref.paged_attention_split_ref(q.float(), kp, vp, pt, cl,
                                                 splits)
        torch.testing.assert_close(out.float(), split, **tol)
        torch.testing.assert_close(out.float(), want, **tol)
        for i, c in enumerate(clen):
            if c == 0:
                assert float(out[i].abs().max()) == 0.0


def test_paged_attention_graph_replay_equals_eager(cuda):
    """Captured in a CUDA graph (after one eager call made the split
    counters), K6 replays to the eager result bit for bit, repeatedly: the
    counters are back at 0 after every launch."""
    q, kp, vp, pt, cl = _paged_case(cuda, 4, [1056, 700, 1024, 513], 15, 5,
                                    64, 16, 66, torch.bfloat16)
    eager = pa.paged_attention_fwd(q, kp, vp, pt, cl)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [pa.paged_attention_fwd(q, kp, vp, pt, cl) for _ in range(3)]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, eager) for o in outs)


def test_paged_attention_refuses_misaligned_pool(cuda):
    """K/V rows arrive as 16-byte cp.async copies: a pool view that is not
    16-byte aligned is refused, not read."""
    q, kp, vp, pt, cl = _paged_case(cuda, 6, [20, 7], 4, 2, 16, 4, 8,
                                    torch.bfloat16)
    flat = torch.zeros(kp.numel() + 1, dtype=kp.dtype, device=cuda)
    bad = flat[1:].view(kp.shape)
    with pytest.raises(ValueError, match="aligned"):
        pa.paged_attention_fwd(q, bad, vp, pt, cl)


def test_reduced_serve_on_the_card_matches_the_cpu(cuda):
    """The whole serving path through the kernels on the card emits the
    tokens its plain versions emit on the CPU (same params)."""
    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline import PipelineShapes
    from repro_torch.serve import ElasticServer
    from repro_torch.serve.kv import PagedKVConfig
    from repro_torch.serve.requests import make_trace

    cfg = reduced_config(get_config("smollm-360m"), num_layers=4,
                         d_model=64, num_heads=4, num_kv_heads=2, d_ff=256,
                         vocab_size=256)
    dcfg = DistConfig(num_stages=2, slot_slack=2, param_dtype="float32",
                      kernel_impl="pallas")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, dcfg)
    trace = make_trace(8, prompt_len=24, max_gen=8, vocab_size=256, seed=1,
                       min_prompt=12)
    out = {}
    for dev in ("cpu", "cuda"):
        srv = ElasticServer(cfg, dcfg, DynamicsConfig(kind="pruning"),
                            PipelineShapes(2, 2, 24, cache_len=32),
                            paged=PagedKVConfig(4, 64, prefix_cache=True),
                            device=dev, params=params)
        rep = srv.serve(copy.deepcopy(trace))
        out[dev] = {c["rid"]: c["tokens"] for c in rep["completions"]}
    assert len(out["cuda"]) == 8
    assert out["cuda"] == out["cpu"]


def _counts(g, G, cap, pattern):
    """Per-group live rows: random, plus an empty and a full group."""
    c = torch.randint(0, cap + 1, (G,), generator=g, device=g.device)
    if pattern == "edges":
        c[0], c[1] = 0, cap
    return c.to(torch.int32)


@pytest.mark.parametrize("G,E,cap,K,N,dt,wmap,trans", [
    (16, 8, 320, 512, 640, torch.float32, False, False),
    (16, 8, 200, 384, 300, torch.float32, True, False),    # cap % 128 != 0
    (32, 8, 8, 256, 384, torch.float32, True, False),      # decode: 16-row
    (8, 4, 136, 200, 260, torch.bfloat16, False, False),
    (16, 8, 320, 384, 512, torch.float32, True, True),     # dx: w^T view
    (16, 8, 96, 256, 384, torch.bfloat16, False, True),
    # the tensor-core variant: ragged cap / K / N edges, a placement, both
    # weight layouts (forward: N-contiguous; dx: the K-contiguous w^T view)
    (16, 8, 200, 328, 392, torch.bfloat16, True, False),
    (16, 8, 200, 328, 392, torch.bfloat16, True, True),
    (16, 8, 320, 512, 640, torch.bfloat16, False, False),
    (16, 8, 320, 384, 512, torch.bfloat16, False, True),
])
def test_grouped_matmul_matches_plain(cuda, G, E, cap, K, N, dt, wmap,
                                      trans):
    g = torch.Generator(device=cuda).manual_seed(6)
    counts = _counts(g, G, cap, "edges")
    x = torch.randn((G * cap, K), generator=g, device=cuda).to(dt)
    w = (torch.randn((E, N, K) if trans else (E, K, N), generator=g,
                     device=cuda) * K ** -0.5).to(dt)
    if trans:
        w = w.transpose(1, 2)                 # read in place, no copy
    live = (torch.arange(G * cap, device=cuda) % cap
            < counts.repeat_interleave(cap))
    x[~live] = 1e3                            # garbage in dead rows
    m = (torch.randperm(E, generator=g, device=cuda).to(torch.int32)
         if wmap else None)
    before, tc0 = gm.KERNEL.launches, gm.KERNEL.launches_tc
    out = gm.grouped_product(x, w, counts, cap, m)
    assert gm.KERNEL.launches == before + 1
    tc = gm.gm_variant(dt, cap, K, N, w.stride()) == "tc"
    assert gm.KERNEL.launches_tc == tc0 + tc
    want = gm_ref.grouped_product_ref(x, w, counts, cap, m)
    assert not out[~live].any()               # dead rows are zero
    if dt == torch.float32:
        _rel_close(out, want, 1e-4)
    else:
        torch.testing.assert_close(out.float(), want.float(), atol=1e-2,
                                   rtol=2 ** -7)


@pytest.mark.parametrize("G,E,cap,K,N,dt,out_dt,gmap", [
    (16, 8, 320, 512, 640, torch.float32, torch.float32, False),
    (16, 8, 200, 300, 260, torch.float32, torch.float32, True),
    (32, 8, 8, 256, 384, torch.bfloat16, torch.float32, True),
    (8, 4, 136, 256, 384, torch.bfloat16, torch.bfloat16, False),
    # the tensor-core variant at ragged cap / K / N edges
    (16, 8, 200, 328, 392, torch.bfloat16, torch.float32, True),
    (16, 8, 200, 328, 392, torch.bfloat16, torch.bfloat16, True),
    (16, 8, 320, 512, 640, torch.bfloat16, torch.float32, False),
])
def test_grouped_matmul_dw_matches_plain(cuda, G, E, cap, K, N, dt, out_dt,
                                         gmap):
    g = torch.Generator(device=cuda).manual_seed(7)
    counts = _counts(g, G, cap, "edges")
    x = torch.randn((G * cap, K), generator=g, device=cuda).to(dt)
    gr = torch.randn((G * cap, N), generator=g, device=cuda).to(dt)
    live = (torch.arange(G * cap, device=cuda) % cap
            < counts.repeat_interleave(cap))
    x[~live] = 1e3                            # garbage in dead rows of both
    gr[~live] = -1e3
    m = (torch.randperm(E, generator=g, device=cuda).to(torch.int32)
         if gmap else None)
    before, tc0 = gm.KERNEL_DW.launches, gm.KERNEL_DW.launches_tc
    dw = gm.grouped_product_dw(x, gr, counts, cap, E, m, out_dtype=out_dt)
    assert gm.KERNEL_DW.launches == before + 1 and dw.dtype == out_dt
    tc = gm.gm_variant(dt, cap, K, N) == "tc"
    assert gm.KERNEL_DW.launches_tc == tc0 + tc
    want = gm_ref.grouped_product_dw_ref(x, gr, counts, cap, E, m)
    if out_dt == torch.float32:
        _rel_close(dw, want, 1e-4)
    else:
        torch.testing.assert_close(dw.float(), want, atol=1e-2,
                                   rtol=2 ** -7)
    # the same bits every run: no atomics
    assert torch.equal(gm.grouped_product_dw(x, gr, counts, cap, E, m,
                                             out_dtype=out_dt), dw)


def test_grouped_matmul_grads_match_plain(cuda):
    """The autograd Function's backward (K4 as dx, K5 as dw) against
    autograd of the plain version, with a placement."""
    g = torch.Generator(device=cuda).manual_seed(8)
    G, E, cap, K, N = 16, 8, 100, 256, 384
    counts = _counts(g, G, cap, "edges")
    x = torch.randn((G, cap, K), generator=g, device=cuda)
    w = torch.randn((E, K, N), generator=g, device=cuda) * K ** -0.5
    cot = torch.randn((G, cap, N), generator=g, device=cuda)
    em = torch.randperm(E, generator=g, device=cuda).float()
    grads = []
    for kernel in (True, False):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if kernel:
            n0 = (gm.KERNEL.launches, gm.KERNEL_DW.launches)
            out = gm.grouped_matmul(xx, ww, counts, expert_map=em)
        else:
            inv = torch.argsort(em)
            out = gm_ref.grouped_matmul_ref(xx, ww[inv], counts)
        (out * cot).sum().backward()
        if kernel:
            assert (gm.KERNEL.launches, gm.KERNEL_DW.launches) == (
                n0[0] + 2, n0[1] + 1)
        grads.append((xx.grad, ww.grad))
    for got, want in zip(*grads):
        _rel_close(got, want, 1e-4)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_moe_ffn_placement_is_bit_neutral_on_the_card(cuda, dt):
    """Through the kernels, any expert placement gives the same y, load,
    drop fraction and weight gradients, bit for bit (bf16 experts run the
    tensor-core variant)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.blocks import moe_ffn
    cfg = reduced_config(get_config("mixtral-8x7b"), num_layers=2,
                         d_model=256, d_ff=512)
    g = torch.Generator(device=cuda).manual_seed(9)
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    p = {"router": torch.randn((d, E), generator=g, device=cuda) * 0.4,
         "ewi": torch.randn((E, d, ff), generator=g, device=cuda) * 0.06,
         "ewg": torch.randn((E, d, ff), generator=g, device=cuda) * 0.06,
         "ewo": torch.randn((E, ff, d), generator=g, device=cuda) * 0.04}
    p.update({k: v.to(dt) for k, v in p.items() if k != "router"})
    x = torch.randn((2, 256, d), generator=g, device=cuda).to(dt)
    tc0 = gm.KERNEL.launches_tc

    def run(em):
        pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y, load, aux, drop = moe_ffn(pp, x, cfg, kernel_impl="pallas",
                                     expert_map=em)
        ((y ** 2).sum() + aux).backward()
        return [y.detach(), load, drop] + [pp[k].grad for k in sorted(p)]

    base = run(None)
    assert (gm.KERNEL.launches_tc > tc0) == (dt == torch.bfloat16)
    for perm in ([1, 0, 3, 2], [3, 2, 0, 1]):
        got = run(torch.tensor(perm, dtype=torch.float32, device=cuda))
        for a, b in zip(got, base):
            assert torch.equal(a, b), perm


def test_reduced_moe_train_and_serve_on_the_card_match_the_cpu(cuda):
    """Reduced Mixtral through the port's CLIs from the same params: the
    card (K4, K5) and the CPU (plain versions) give train losses within
    1e-4 — with live re-layouts on the card run — and the same serve
    tokens."""
    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.launch.serve import run as serve_run
    from repro_torch.launch.train import run as train_run
    from repro_torch.models import model as M
    cfg = reduced_config(get_config("mixtral-8x7b"), num_layers=4,
                         d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                         vocab_size=256)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           DistConfig(num_stages=2, slot_slack=2,
                                      param_dtype="float32"))
    common = ["--arch", "mixtral-8x7b", "--layers", "4", "--d-model", "64",
              "--d-ff", "128", "--vocab-size", "256", "--stages", "2",
              "--kernel-impl", "pallas"]
    train = common + ["--seq", "32", "--num-micro", "2", "--mb-global", "2",
                      "--steps", "6", "--dynamism", "moe",
                      "--rebalance-every", "2", "--log-every", "100",
                      "--dynamics.expert_watermark", "1.01",
                      "--dynamics.expert_min_tokens", "1"]
    cpu = train_run(train + ["--device", "cpu"],
                    params=copy.deepcopy(params))
    n0 = (gm.KERNEL.launches, gm.KERNEL_DW.launches)
    card = train_run(train + ["--dynamics.expert_relayout"],
                     params=copy.deepcopy(params))
    assert gm.KERNEL.launches > n0[0] and gm.KERNEL_DW.launches > n0[1]
    assert card["relayouts"] and not cpu["relayouts"]
    torch.testing.assert_close(torch.tensor(card["losses"]),
                               torch.tensor(cpu["losses"]), atol=1e-4,
                               rtol=0)
    serve = common + ["--elastic", "--prompt-len", "16", "--gen", "6",
                      "--requests", "6"]
    toks = {}
    for dev in ("cpu", "cuda"):
        rep = serve_run(serve + ["--device", dev],
                        params=copy.deepcopy(params))
        toks[dev] = {c["rid"]: c["tokens"] for c in rep["completions"]}
    assert len(toks["cuda"]) == 6 and toks["cuda"] == toks["cpu"]


def test_reduced_elastic_train_and_serve_on_the_card_match_the_cpu(cuda):
    """Live resizes through the kernels on the card: the train CLI's
    ``--repack --grow-back`` run (reduced smollm, 4 stage buffers) gives
    the CPU run's losses within 1e-4 and the same resizes, and its shrink
    frees device memory; early exit trains to the CPU's losses; a serve
    resized 4 -> 2 -> 4 emits the CPU's fixed serve's tokens."""
    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.train import run as train_run
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline import PipelineShapes
    from repro_torch.serve import ElasticServer
    from repro_torch.serve.kv import PagedKVConfig
    from repro_torch.serve.requests import make_trace
    cfg = reduced_config(get_config("smollm-360m"), num_layers=8,
                         d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                         vocab_size=512)
    dcfg = DistConfig(num_stages=4, slot_slack=2, param_dtype="float32",
                      kernel_impl="pallas")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, dcfg)
    train = ["--layers", "8", "--d-model", "128", "--d-ff", "256",
             "--vocab-size", "512", "--stages", "4", "--num-micro", "4",
             "--mb-global", "2", "--seq", "32", "--steps", "26",
             "--rebalance-every", "5", "--kernel-impl", "pallas",
             "--log-every", "100"]
    for extra in (["--dynamism", "pruning", "--repack", "--grow-back", "6"],
                  ["--dynamism", "early_exit", "--steps", "8",
                   "--dynamics.ee_threshold", "0.95"]):
        cpu = train_run(train + extra + ["--device", "cpu"],
                        params=copy.deepcopy(params))
        card = train_run(train + extra, params=copy.deepcopy(params))
        torch.testing.assert_close(torch.tensor(card["losses"]),
                                   torch.tensor(cpu["losses"]), atol=1e-4,
                                   rtol=0)
        assert [(r["kind"], r["step"], r["to_stages"])
                for r in card["resizes"]] == [
            (r["kind"], r["step"], r["to_stages"]) for r in cpu["resizes"]]
    shrink, = train_run(train + ["--dynamism", "pruning", "--repack"],
                        params=copy.deepcopy(params))["resize_memory"]
    assert shrink["allocated_after"] < shrink["allocated_before"]
    trace = make_trace(8, prompt_len=24, max_gen=8, vocab_size=512, seed=1,
                       min_prompt=12)
    out = {}
    for dev, resize_at in (("cpu", None), ("cuda", {2: 2, 5: 4})):
        srv = ElasticServer(cfg, dcfg, DynamicsConfig(),
                            PipelineShapes(2, 2, 24, cache_len=32),
                            paged=PagedKVConfig(4, 64), device=dev,
                            params=copy.deepcopy(params))
        rep = srv.serve(copy.deepcopy(trace), resize_at=resize_at)
        out[dev] = {c["rid"]: c["tokens"] for c in rep["completions"]}
        if resize_at:
            assert [r["kind"] for r in rep["resizes"]] == ["shrink", "grow"]
    assert len(out["cuda"]) == 8 and out["cuda"] == out["cpu"]


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_on_the_card_is_bitwise(cuda, tmp_path,
                                                      param_dtype):
    """A CUDA training state (params, Adam moments and count, dyn) saved
    and loaded back onto the card: every leaf bitwise, bf16 through its raw
    16 bits."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.pipeline.pipeline import PipelineShapes
    cfg = reduced_config(get_config("smollm-360m"), num_layers=4, d_model=64,
                         num_heads=4, num_kv_heads=2, d_ff=256,
                         vocab_size=256)
    eng = ElasticEngine(cfg, DistConfig(num_stages=2,
                                        param_dtype=param_dtype),
                        DynamicsConfig(kind="pruning"),
                        PipelineShapes(2, 2, 16))
    st = eng.init_state(1, with_opt=True)
    for v in st.opt_state["m"]["stages"].values():
        v.normal_()
    st.opt_state["count"] += 5
    save_checkpoint(str(tmp_path), 3, st.params, st.opt_state, st.dyn,
                    st.lps)
    p, o, d, _ = load_checkpoint(str(tmp_path), eng.state_templates(2),
                                 device="cuda")
    for got, want in ((p, st.params), (o, st.opt_state), (d, st.dyn)):
        flat_g, flat_w = dict(_leaves(got)), dict(_leaves(want))
        assert sorted(flat_g) == sorted(flat_w)
        for k, w in flat_w.items():
            g = flat_g[k]
            assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
            if w.dtype == torch.bfloat16:
                g, w = g.view(torch.int16), w.view(torch.int16)
            assert torch.equal(g, w), k
    assert p["stages"]["wq"].dtype == (torch.bfloat16 if param_dtype ==
                                       "bfloat16" else torch.float32)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def test_cuda_event_stage_timer_ranks_the_longer_stage(cuda):
    """The in-step timer on the card (CUDA events around each stage's
    forward) reads an 8-layer stage above a 1-layer one, and nothing
    before a full step."""
    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.data.loader import DataConfig, make_loader
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.pipeline.pipeline import PipelineShapes
    cfg = reduced_config(get_config("smollm-360m"), num_layers=9,
                         d_model=256, num_heads=4, num_kv_heads=2, d_ff=1024,
                         vocab_size=512)
    eng = ElasticEngine(cfg, DistConfig(num_stages=2, slot_slack=4,
                                        param_dtype="float32",
                                        kernel_impl="pallas"),
                        DynamicsConfig(), PipelineShapes(4, 2, 256),
                        in_step_timing=True)
    state = eng.init_state(0, with_opt=True, lps=[8, 1])
    batch = next(make_loader(cfg, DataConfig(4, 2, 256)))
    assert eng.in_step_stage_times(state) is None
    for _ in range(3):
        float(eng.step(state, batch, 1e-4)[0])
    t = eng.in_step_stage_times(state)
    probe = eng.measure_stage_times(state, batch)
    assert t.shape == probe.shape == (2,) and (t > 0).all()
    assert t[0] > t[1] and probe[0] > probe[1], (t, probe)
    assert eng.in_step_stage_times(state) is None     # reset on read


def test_async_drain_with_cuda_state_is_the_inline_run(cuda):
    """The decision thread reads host numpy only; with --async-drain a
    run on the card is the inline run bit for bit, through a live shrink
    of the CUDA state."""
    from repro_torch.launch.train import run as train_run
    flags = ["--layers", "8", "--d-model", "128", "--d-ff", "256",
             "--vocab-size", "512", "--stages", "4", "--num-micro", "4",
             "--mb-global", "2", "--seq", "32", "--steps", "20",
             "--rebalance-every", "5", "--dynamism", "pruning", "--repack",
             "--kernel-impl", "pallas", "--log-every", "100"]
    a = train_run(flags)
    b = train_run(flags + ["--async-controller", "--async-drain"])
    assert a["losses"] == b["losses"]
    assert [r["step"] for r in a["resizes"]] == [
        r["step"] for r in b["resizes"]] == [14]
    assert b["controller"]["mode"] == "async"


def test_two_ranks_share_the_card_through_host_copies(cuda):
    """A 2-rank world on the one card: the launcher picks gloo (the ranks
    share the card), the ring and the all-reduce move CUDA tensors through
    pinned host buffers, and an explicit nccl raises before any rank
    starts."""
    from repro_torch.launch.dist import choose_backend, launch
    n = torch.cuda.device_count()
    assert choose_backend(cuda, n + 1) == "gloo"
    with pytest.raises(ValueError, match="refuses two ranks on one device"):
        launch("_dist_targets:ring", n + 1, backend="nccl")
    out = launch("_dist_targets:ring", 2, timeout_s=60,
                 run_timeout_s=180)
    for r in out:
        prv = (r["rank"] - 1) % 2
        assert r["got"] == [(float(prv * 10 + i), float(10 + 2 * i))
                            for i in range(3)]


def test_reduced_train_as_two_ranks_on_the_card_equals_one_process(cuda):
    """Reduced smollm (8 layers, d_model 64) trained 4 steps as 2 ranks on
    the card, a migration after step 1: bitwise the one-process run on the
    card, and every rank's K1-K3 launches summed equal the one process's."""
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.train import run
    argv = ["--layers", "8", "--d-model", "64", "--num-heads", "4",
            "--num-kv-heads", "2", "--d-ff", "256", "--vocab-size", "256",
            "--seq", "64", "--num-micro", "2", "--mb-global", "2",
            "--stages", "2", "--steps", "4", "--rebalance-every", "2",
            "--straggler", "1:4.0", "--dynamism", "pruning",
            "--kernel-impl", "pallas", "--log-every", "100"]
    across = run(argv + ["--procs", "2"], gather=True)
    for k in KERNELS:
        k.reset()
    one = run(argv)
    assert across["losses"] == one["losses"]
    assert [e.moved_layers for e in across["events"]] == \
        [e.moved_layers for e in one["events"]]
    for k, a in across["params"]["stages"].items():
        assert torch.equal(a.to(cuda), one["params"]["stages"][k]), k
    for k in KERNELS:
        total = sum(r["launches"][k.name]["launches"]
                    for r in across["ranks"])
        assert total == k.launches, k.name
