"""Which variant of the pruned matmul (K3) serves a call, and K2b's work
schedule — checked on the CPU.

K3 has two CUDA variants (``repro_torch.kernels.pruned_matmul.ops``): the
tensor-core one (3xTF32 ``mma.sync`` on a ``cp.async`` ring) for a mask
block that the 128-wide tile or the 64-deep chunk divides and operands
with a unit-stride axis, and the SIMT one for the rest.  ``pm_variant``
decides from dtype, mask block and strides alone, so the decision is tested
here.  K2b splits its work by ``dkv_schedule`` from the shapes alone; a
plain emulation that sums per-item partials in the schedule's order is held
to the plain backward and to the JAX package's ``block_sparse_attention_
bwd_p`` (interpret mode) within 2e-4 x max|ref|, the tolerance the card
holds K2b to.  The kernels themselves run in ``test_torch_cuda.py``.
"""
import ast
import math
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.block_sparse_attention.backward import (  # noqa: E402
    block_sparse_attention_bwd_p)
from repro_torch.kernels.block_sparse_attention import ops as bsa  # noqa: E402
from repro_torch.kernels.block_sparse_attention import ref as bsa_ref  # noqa: E402
from repro_torch.kernels.pruned_matmul import ops as pm  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
BF16, F32 = torch.bfloat16, torch.float32


def _products(M, K, N, axis, dtype=F32):
    """(label, mask axis of the launch, x strides, w strides) of K3's five
    products for out = x [M, K] @ w [K, N] under a mask over ``axis``, as
    ``ops.pruned_matmul`` and ``backward.py`` lay them out."""
    x, w, g = (torch.empty(s, dtype=dtype) for s in ((M, K), (K, N), (M, N)))
    other = "k" if axis == "n" else "n"
    out = [("fwd", axis, x.stride(), w.stride())]
    if axis == "n":
        out += [("dx", other, g.stride(), w.T.stride()),
                ("dw", "n", x.T.stride(), g.stride())]
    else:
        out += [("dx", other, g.stride(), w.T.stride()),
                ("dw", "n", g.T.stride(), x.stride())]
    return out


# the SwiGLU projections of smollm-360m (d_model 960, d_ff 2560) at the
# serve's prefill (M 4096) and the train step's microbatch (M 2048)
@pytest.mark.parametrize("M,K,N,axis", [(4096, 960, 2560, "n"),
                                        (4096, 2560, 960, "k"),
                                        (2048, 960, 2560, "n"),
                                        (2048, 2560, 960, "k")])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_main_path_products_take_the_tensor_cores(M, K, N, axis, dtype):
    for label, launch_axis, xs, ws in _products(M, K, N, axis, dtype):
        assert pm.pm_variant(dtype, launch_axis, 128, xs, ws) == "tc", label


@pytest.mark.parametrize("dtype,axis,blk,xs,ws,aligned,want", [
    # the mask-block edge cases of chip_smoke's phase 3: per-element masks
    (F32, "n", 64, (100, 1), (192, 1), True, "simt"),
    (F32, "k", 48, (96, 1), (70, 1), True, "simt"),
    # blocks the tile / chunk divide
    (F32, "n", 256, (960, 1), (2560, 1), True, "tc"),
    (F32, "k", 64, (960, 1), (2560, 1), True, "tc"),
    (F32, "k", 32, (960, 1), (2560, 1), True, "simt"),   # below the chunk
    # a row pitch off 16 bytes (K = 97 fp32, K = 100 bf16)
    (F32, "n", 128, (97, 1), (256, 1), True, "simt"),
    (BF16, "n", 128, (100, 1), (256, 1), True, "simt"),
    (BF16, "n", 128, (104, 1), (256, 1), True, "tc"),
    # no unit-stride axis (every other column), or a pointer off 16 bytes
    (F32, "n", 128, (1920, 2), (256, 1), True, "simt"),
    (F32, "n", 128, (960, 1), (512, 2), True, "simt"),
    (F32, "n", 128, (960, 1), (256, 1), False, "simt"),
    (torch.float16, "n", 128, (960, 1), (256, 1), True, "simt"),
])
def test_variant_edges(dtype, axis, blk, xs, ws, aligned, want):
    assert pm.pm_variant(dtype, axis, blk, xs, ws, aligned) == want


@pytest.mark.parametrize("M,K,N,dtype,want", [
    # dw of the train step's backward (d_model 960, d_ff 2560, 2048 tokens):
    # 160 tiles on 132 SMs, cut along K into 4
    (960, 2048, 2560, F32, 4),
    (2560, 2048, 960, F32, 4),
    # grids that fill their waves stay whole: the forward (640 or 320
    # tiles), dx (128 tiles, one wave)
    (4096, 960, 2560, F32, 1),
    (2048, 960, 2560, F32, 1),
    (2048, 2560, 960, F32, 1),
    # bf16 never splits (its slices would be fp32)
    (960, 2048, 2560, BF16, 1),
    # one chunk cannot be split
    (960, 64, 2560, F32, 1),
])
def test_splits(M, K, N, dtype, want):
    assert pm.pm_splits(M, K, N, dtype) == want


def test_cpu_products_take_the_plain_version_and_count_nothing():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((40, 256), generator=g)
    w = torch.randn((256, 128), generator=g)
    m = torch.tensor([1.0, 0.0])
    n = (pm.KERNEL.launches, pm.KERNEL.launches_tc)
    out = pm.product(x, w, m, "k", 128)
    torch.testing.assert_close(out, (x * m.repeat_interleave(128)) @ w,
                               atol=1e-5, rtol=1e-5)
    assert (pm.KERNEL.launches, pm.KERNEL.launches_tc) == n


def test_tensor_core_sources_are_mma_sync_tf32_on_cp_async():
    kdir = REPO / "src" / "repro_torch" / "kernels"
    hdr = (kdir / "tf32x3.cuh").read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in hdr
    assert "cvt.rna.tf32.f32" in hdr and "cp.async.cg.shared.global" in hdr
    for src in (kdir / "pruned_matmul" / "csrc" / "pruned_matmul.cu",
                kdir / "block_sparse_attention" / "csrc"
                / "block_sparse_attention_bwd.cu"):
        text = src.read_text()
        assert '#include "tf32x3.cuh"' in text
        assert "TF32 would break" not in text
    assert "pm_fwd_tc" in pm.KERNEL.functions
    for ops in (kdir / "pruned_matmul" / "ops.py",
                kdir / "block_sparse_attention" / "ops.py"):
        tree = ast.parse(ops.read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


# ---------------------------------------------------------------------------
# K2b's schedule
# ---------------------------------------------------------------------------
def _expand(sch, b, sq, sk, hq, hkv, causal):
    """Every (batch, kv head, kv tile, q head, q tile) step of the items."""
    T = bsa.DKV_TILE
    rep, n_kt = hq // hkv, -(-sk // T)
    per = bsa.dkv_tile_steps(sq, sk, rep, causal)
    out = []
    for tile, s0, s1, _ in sch.items.tolist():
        kt, hk, bi = tile % n_kt, (tile // n_kt) % hkv, tile // (n_kt * hkv)
        _, qt0, steps = per[kt]
        nq = steps // rep
        for s in range(s0, s1):
            out.append((bi, hk, kt, hk * rep + s // nq, qt0 + s % nq))
    return out


@pytest.mark.parametrize("b,s,hq,hkv,causal", [
    (2, 1024, 15, 5, True), (2, 1000, 15, 5, True), (4, 1024, 15, 5, True),
    (2, 300, 4, 2, True), (2, 77, 4, 1, False), (1, 64, 2, 2, True)])
def test_schedule_covers_each_step_once_in_a_fixed_order(b, s, hq, hkv,
                                                         causal):
    T = bsa.DKV_TILE
    sch = bsa.dkv_schedule(b, s, s, hq, hkv, causal)
    steps = _expand(sch, b, s, s, hq, hkv, causal)
    n = -(-s // T)
    want = {(bi, hk, kt, h, qt)
            for bi in range(b) for hk in range(hkv) for kt in range(n)
            for h in range(hk * (hq // hkv), (hk + 1) * (hq // hkv))
            for qt in range(n)
            if not causal or min(qt * T + T, s) - 1 >= kt * T}
    assert len(steps) == len(set(steps)) == len(want)
    assert set(steps) == want
    # a fixed order: recomputed from scratch it is the same, longest first
    bsa.dkv_schedule.cache_clear()
    again = bsa.dkv_schedule(b, s, s, hq, hkv, causal)
    assert np.array_equal(sch.items, again.items)
    lens = sch.items[:, 2] - sch.items[:, 1]
    assert (np.diff(lens) <= 0).all()
    # each kv tile's slots are contiguous and in step order
    off = sch.offsets
    by_slot = sch.items[np.argsort(sch.items[:, 3])]
    assert (by_slot[:, 3] == np.arange(len(by_slot))).all()
    for tile in range(len(off) - 1):
        rows = by_slot[off[tile]:off[tile + 1]]
        assert (rows[:, 0] == tile).all()
        assert (rows[1:, 1] == rows[:-1, 2]).all()


@pytest.mark.parametrize("b", [1, 2, 4])
def test_schedule_is_balanced_and_fills_the_card(b):
    sch = bsa.dkv_schedule(b, 1024, 1024, 15, 5, True)
    lens = sch.items[:, 2] - sch.items[:, 1]
    assert lens.max() <= 1.25 * lens.mean()
    assert len(lens) >= 4 * bsa.DKV_SMS              # several waves


def _emulate(sch, q, k, v, m, dout, lse, delta, causal, block):
    """dk, dv as the kernel forms them: each item's partial over its steps,
    then every kv tile's partials summed in slot order (fp32)."""
    T = bsa.DKV_TILE
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep, n_kt = hq // hkv, -(-sk // T)
    p, ds, qf, _, of = bsa_ref._recompute(q, k, v, m, dout, lse, delta,
                                          causal, block)
    per = bsa.dkv_tile_steps(sq, sk, rep, causal)
    parts = {}
    for tile, s0, s1, slot in sch.items.tolist():
        kt, hk, bi = tile % n_kt, (tile // n_kt) % hkv, tile // (n_kt * hkv)
        _, qt0, steps = per[kt]
        nq = steps // rep
        c = slice(kt * T, min(kt * T + T, sk))
        pdk = torch.zeros((c.stop - c.start, d))
        pdv = torch.zeros_like(pdk)
        for s in range(s0, s1):
            h, qt = hk * rep + s // nq, qt0 + s % nq
            r = slice(qt * T, min(qt * T + T, sq))
            pdk += ds[bi, h, r, c].T @ qf[bi, h, r]
            pdv += p[bi, h, r, c].T @ of[bi, h, r]
        parts[slot] = (tile, pdk, pdv)
    dk, dv = torch.zeros(b, sk, hkv, d), torch.zeros(b, sk, hkv, d)
    for slot in range(len(parts)):
        tile, pdk, pdv = parts[slot]
        kt, hk, bi = tile % n_kt, (tile // n_kt) % hkv, tile // (n_kt * hkv)
        c = slice(kt * T, min(kt * T + T, sk))
        dk[bi, c, hk] += pdk
        dv[bi, c, hk] += pdv
    return dk, dv


@pytest.mark.parametrize("s,hq,hkv,d,block,dens,causal", [
    (200, 4, 2, 16, 64, 0.6, True),
    (256, 6, 2, 16, 128, 1.0, True),
    (130, 4, 1, 32, 64, 0.5, False),
])
def test_schedule_partial_sums_match_the_references(s, hq, hkv, d, block,
                                                    dens, causal):
    rng = np.random.RandomState(s + hq + d)
    b = 2
    q = (rng.randn(b, s, hq, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, s, hkv, d) * 0.5).astype(np.float32)
    v = (rng.randn(b, s, hkv, d) * 0.5).astype(np.float32)
    dout = rng.randn(b, s, hq, d).astype(np.float32)
    n = -(-s // block)
    mask = (rng.rand(b, hq, n, n) < dens).astype(np.int32)
    mask[:, :, 0, 0] = 1
    tq, tk, tv, tdo, tm = map(torch.from_numpy, (q, k, v, dout, mask))
    out, lse = bsa.block_sparse_attention_fwd(tq, tk, tv, tm, causal=causal,
                                              block=block)
    delta = (tdo * out).sum(-1).transpose(1, 2).contiguous()
    sch = bsa.dkv_schedule(b, s, s, hq, hkv, causal)
    dk, dv = _emulate(sch, tq, tk, tv, tm, tdo, lse, delta, causal, block)
    rdk, rdv = bsa_ref.block_sparse_attention_bwd_dkv_ref(
        tq, tk, tv, tm, tdo, lse, delta, causal=causal, block=block)
    for got, want in ((dk, rdk), (dv, rdv)):
        assert float((got - want).abs().max()) <= 2e-4 * float(
            want.abs().max())
    # the JAX package's kernel on the flat, padded, GQA-repeated layout
    rep, pad = hq // hkv, n * block - s

    def flat(a, r=1):
        a = np.repeat(a, r, axis=2)
        a = np.pad(a, ((0, 0), (0, pad), (0, 0), (0, 0)))
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * hq, n * block,
                                                           d))

    def rows(a):
        return jnp.asarray(np.pad(a.numpy(), ((0, 0), (0, 0), (0, pad)))
                           .reshape(b * hq, n * block))

    _, jdk, jdv = block_sparse_attention_bwd_p(
        flat(q), flat(k, rep), flat(v, rep),
        jnp.asarray(mask.reshape(b * hq, n, n)), flat(dout), rows(lse),
        rows(delta), causal=causal, block_q=block, block_k=block,
        sm_scale=1.0 / math.sqrt(d), kv_len=s, interpret=True)
    for got, j in ((dk, jdk), (dv, jdv)):
        want = (np.asarray(j).reshape(b, hkv, rep, n * block, d).sum(2)
                [:, :, :s].transpose(0, 2, 1, 3))
        assert np.abs(got.numpy() - want).max() <= 2e-4 * np.abs(want).max()
