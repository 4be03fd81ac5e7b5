"""The port's CUDA kernels on the card, each against its plain PyTorch
version, and a reduced serve on the card against the same serve on the CPU.

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
        before = bsa.KERNEL.launches
        out, lse = bsa.block_sparse_attention_fwd(q, k, v, m, causal=causal,
                                                  block=block)
        assert bsa.KERNEL.launches == before + 1
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
    before = gm.KERNEL.launches
    out = gm.grouped_product(x, w, counts, cap, m)
    assert gm.KERNEL.launches == before + 1
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
    before = gm.KERNEL_DW.launches
    dw = gm.grouped_product_dw(x, gr, counts, cap, E, m, out_dtype=out_dt)
    assert gm.KERNEL_DW.launches == before + 1 and dw.dtype == out_dt
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


def test_moe_ffn_placement_is_bit_neutral_on_the_card(cuda):
    """Through the kernels, any expert placement gives the same y, load,
    drop fraction and weight gradients, bit for bit."""
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
    x = torch.randn((2, 256, d), generator=g, device=cuda)

    def run(em):
        pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y, load, aux, drop = moe_ffn(pp, x, cfg, kernel_impl="pallas",
                                     expert_map=em)
        ((y ** 2).sum() + aux).backward()
        return [y.detach(), load, drop] + [pp[k].grad for k in sorted(p)]

    base = run(None)
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
