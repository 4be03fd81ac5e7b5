"""The port's layers, blocks and stage executor against the JAX package.

Identical numpy inputs (and, for the stage executor, the reference's own
params handed over through ``repro_torch.convert``) go through both
packages on the CPU; the JAX side reaches its Pallas kernels in interpret
mode.  Outputs agree at atol/rtol 1e-4 unless a case says otherwise; a bf16
KV cache is compared at one bf16 ulp (at most 2^-7 relative).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import DistConfig as JDist  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import reduced_config as jreduce  # noqa: E402
from repro.dynamics.config import DynamicsConfig as JDyn  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import DistConfig as TDist  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduce  # noqa: E402
from repro_torch.dynamics.config import DynamicsConfig as TDyn  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=1e-4, rtol=2 ** -7)   # one bf16 ulp
SMALL = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=256)


def cfgs():
    return (jreduce(jget("smollm-360m"), **SMALL),
            treduce(tget("smollm-360m"), **SMALL))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32) if np.asarray(a).dtype
                            .name == "bfloat16" else np.array(a))


def close(got, want, **tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rms_norm_and_rope():
    rng = np.random.RandomState(0)
    x = randn(rng, 2, 7, 4, 16)
    scale = randn(rng, 16)
    close(TL.rms_norm(_t(x), _t(scale)),
          JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)), atol=1e-5)
    pos = rng.randint(0, 3000, (2, 7)).astype(np.int32)
    for theta in (1e4, 1e6):
        close(TL.apply_rope(_t(x), _t(pos), theta),
              JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
              atol=1e-4)


@pytest.mark.parametrize("impl", ["reference", "scan", "pallas"])
@pytest.mark.parametrize("s", [5, 1])          # s == 1: decode stays dense
def test_swiglu(impl, s):
    rng = np.random.RandomState(1)
    x = randn(rng, 2, s, 64, scale=0.5)
    wi, wg = randn(rng, 64, 256, scale=0.1), randn(rng, 64, 256, scale=0.1)
    wo = randn(rng, 256, 64, scale=0.1)
    mask = np.array([1.0, 0.0], np.float32)    # block-level, 2 x 128
    got = TL.swiglu(*map(_t, (x, wi, wg, wo, mask)), impl=impl)
    want = JL.swiglu(*map(jnp.asarray, (x, wi, wg, wo, mask)), impl=impl)
    close(got, want)
    if impl != "pallas":                       # expanded [d_ff] mask too
        full = np.repeat(mask, 128)
        close(TL.swiglu(*map(_t, (x, wi, wg, wo, full)), impl=impl), want)


def _mask_cases(rng, b, h, s, block):
    nq = -(-s // block)
    nfloor = max(1, s // block)               # the hash mask's own extent
    return {
        "none": None,
        "h": (rng.rand(h, nq, nq) < 0.6).astype(np.float32),
        "b1": (rng.rand(b, 1, nfloor, nfloor) < 0.6).astype(np.float32),
        "bh": (rng.rand(b, h, nq, nq) < 0.6).astype(np.float32),
    }


@pytest.mark.parametrize("impl", ["reference", "scan", "pallas"])
@pytest.mark.parametrize("layout", ["none", "h", "b1", "bh"])
def test_flash_attention(impl, layout):
    rng = np.random.RandomState(2)
    b, s, h, kv, d, block = 2, 40, 4, 2, 16, 16    # partial trailing block
    q, k, v = (randn(rng, b, s, n, d, scale=0.5) for n in (h, kv, kv))
    bm = _mask_cases(rng, b, h, s, block)[layout]
    kw = dict(causal=True, kv_block=block, impl=impl)
    got = TL.flash_attention(_t(q), _t(k), _t(v),
                             block_mask=None if bm is None else _t(bm), **kw)
    want = JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_mask=None if bm is None
                              else jnp.asarray(bm), **kw)
    close(got, want)


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_flash_attention_sliding_window_falls_back_to_scan(impl):
    rng = np.random.RandomState(3)
    q, k, v = (randn(rng, 1, 24, n, 8) for n in (4, 2, 2))
    kw = dict(causal=True, sliding_window=8, kv_block=8, impl=impl)
    close(TL.flash_attention(_t(q), _t(k), _t(v), **kw),
          JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vector", [False, True])
def test_decode_attention(cache_dtype, vector):
    rng = np.random.RandomState(4)
    b, S, h, kv, d = 3, 12, 4, 2, 16
    q = randn(rng, b, 1, h, d)
    kc, vc = randn(rng, b, S, kv, d), randn(rng, b, S, kv, d)
    cl = np.array([5, 12, 1], np.int32) if vector else np.int32(7)
    jdt = jnp.bfloat16 if cache_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if cache_dtype == "bfloat16" else torch.float32
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc, jdt),
                               jnp.asarray(vc, jdt), jnp.asarray(cl))
    got = TL.decode_attention(_t(q), _t(kc).to(tdt), _t(vc).to(tdt),
                              torch.as_tensor(cl))
    assert got.dtype == tdt
    close(got, want, **(BF16 if cache_dtype == "bfloat16" else TOL))


def test_hash_block_mask_with_reference_projection():
    rng = np.random.RandomState(5)
    x = randn(rng, 2, 70, 64)
    for nbuckets, block, causal in ((8, 16, True), (4, 8, False)):
        nbits = TB.hash_bits(nbuckets)
        proj = jax.random.normal(jax.random.PRNGKey(17), (64, nbits),
                                 jnp.float32)
        jm, jd = JB.hash_block_mask(jnp.asarray(x), nbuckets=nbuckets,
                                    block=block, causal=causal)
        tm, td = TB.hash_block_mask(_t(x), _t(proj), nbuckets=nbuckets,
                                    block=block, causal=causal)
        assert np.array_equal(tm.numpy(), np.asarray(jm))
        close(td, jd, atol=1e-6)


# ---------------------------------------------------------------------------
# attention block, dense block
# ---------------------------------------------------------------------------
def _attn_weights(rng, d=64, nq=4, nkv=2, hd=16):
    return [randn(rng, d, nq * hd, scale=0.15), randn(rng, d, nkv * hd,
                                                      scale=0.15),
            randn(rng, d, nkv * hd, scale=0.15),
            randn(rng, nq * hd, d, scale=0.15)]


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("sparse", [False, True])
def test_attn_fwd_prefill_fills_cache(impl, sparse):
    jcfg, tcfg = cfgs()
    rng = np.random.RandomState(6)
    b, s, cap = 2, 24, 32
    x = randn(rng, b, s, 64, scale=0.5)
    w = _attn_weights(rng)
    kind = "sparse_attention" if sparse else "none"
    jdc, tdc = JDyn(kind=kind, sparse_block=8), TDyn(kind=kind,
                                                     sparse_block=8)
    jcache = {k: jnp.zeros((b, cap, 2, 16), jnp.bfloat16) for k in "kv"}
    tcache = {k: torch.zeros((b, cap, 2, 16), dtype=torch.bfloat16)
              for k in "kv"}
    proj = jax.random.normal(jax.random.PRNGKey(17), (64, 3), jnp.float32)
    jo, jc, jd = JB._attn_fwd(jnp.asarray(x), *map(jnp.asarray, w),
                              cfg=jcfg, mode="prefill", cache=jcache,
                              pos=jnp.arange(s), dyncfg=jdc,
                              kernel_impl=impl)
    to, tc, td = TB._attn_fwd(_t(x), *map(_t, w), cfg=tcfg, mode="prefill",
                              cache=tcache, pos=torch.arange(s), dyncfg=tdc,
                              kernel_impl=impl, hash_proj=_t(proj))
    close(to, jo)
    close(td, jd, atol=1e-6)
    for k in "kv":
        close(tc[k], jc[k], **BF16)


def _decode_case(rng, paged):
    b, page, J = 3, 4, 4
    pos = np.array([5, 9, 0], np.int32)
    if not paged:
        return b, pos, {k: randn(rng, b, J * page, 2, 16) for k in "kv"}
    pool = 10
    pt = np.full((b, J), -1, np.int32)
    perm = rng.permutation(pool)
    n = 0
    for i in range(b):
        for j in range(int(pos[i]) // page + 1):
            pt[i, j] = perm[n]
            n += 1
    return b, pos, {"kp": randn(rng, pool + 1, page, 2, 16),
                    "vp": randn(rng, pool + 1, page, 2, 16), "pt": pt}


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("paged", [False, True])
def test_attn_fwd_decode(impl, paged):
    jcfg, tcfg = cfgs()
    rng = np.random.RandomState(7)
    b, pos, raw = _decode_case(rng, paged)
    x = randn(rng, b, 1, 64, scale=0.5)
    w = _attn_weights(rng)
    jcache = {k: (jnp.asarray(v) if k == "pt" else jnp.asarray(v,
                                                               jnp.bfloat16))
              for k, v in raw.items()}
    tcache = {k: (_t(v) if k == "pt" else _t(v).bfloat16())
              for k, v in raw.items()}
    if paged:
        jcache["wok"] = jnp.int32(1)
        tcache["wok"] = 1
    jo, jc, _ = JB._attn_fwd(jnp.asarray(x), *map(jnp.asarray, w), cfg=jcfg,
                             mode="decode", cache=jcache,
                             pos=jnp.asarray(pos), kernel_impl=impl)
    to, tc, _ = TB._attn_fwd(_t(x), *map(_t, w), cfg=tcfg, mode="decode",
                             cache=tcache, pos=_t(pos), kernel_impl=impl)
    close(to, jo)
    for k in ("kp", "vp") if paged else ("k", "v"):
        close(tc[k], jc[k], **BF16)


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_dense_block_prefill(impl):
    jcfg, tcfg = cfgs()
    rng = np.random.RandomState(8)
    spec = JB.slot_param_spec(jcfg, jnp.float32)
    p = {k: randn(rng, *v.shape, scale=0.1) for k, v in spec.items()}
    p["attn_norm"] = p["attn_norm"] + 1.0
    p["ffn_norm"] = p["ffn_norm"] + 1.0
    x = randn(rng, 2, 12, 64, scale=0.5)
    ff = np.array([0.0, 1.0], np.float32)
    jy, _, jst, _ = JB._dense_block(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg=jcfg,
        mode="train", cache=None, pos=jnp.arange(12),
        dyn={"ff_mask": jnp.asarray(ff)}, dyncfg=JDyn(kind="pruning"),
        kernel_impl=impl)
    ty, _, tst, _ = TB._dense_block(
        {k: _t(v) for k, v in p.items()}, _t(x), cfg=tcfg, mode="train",
        cache=None, pos=torch.arange(12), dyn={"ff_mask": _t(ff)},
        dyncfg=TDyn(kind="pruning"), kernel_impl=impl)
    close(ty, jy)
    close(tst["ff_active"], jst["ff_active"])


# ---------------------------------------------------------------------------
# stage executor with the reference's params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["pallas"])
def test_stage_forward_prefill_and_decode(impl):
    jcfg, tcfg = cfgs()
    jd = JDist(num_stages=2, slot_slack=2, remat="none",
               param_dtype="float32", kernel_impl=impl)
    td = TDist(num_stages=2, slot_slack=2, remat="none",
               param_dtype="float32", kernel_impl=impl)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg, jd)
    tparams = convert.to_torch(jax.tree.map(np.asarray, params), "cpu")
    jas, tas = JM.make_assignment(jcfg, jd), TM.make_assignment(tcfg, td)
    assert np.array_equal(np.asarray(jas["tags"]), tas["tags"].numpy())
    jdyn = JM.init_dyn(jcfg, jd, JDyn(kind="pruning"))
    jdyn = {**jdyn, "ff_mask": jdyn["ff_mask"].at[0, 1, 0].set(0.0)}
    tdyn = convert.to_torch(jax.tree.map(np.asarray, jdyn), "cpu")
    rng = np.random.RandomState(9)
    b, s, cap = 2, 10, 16
    tokens = rng.randint(0, 256, (b, s)).astype(np.int32)
    jx = JM.embed(params, jcfg, jnp.asarray(tokens))
    tx = TM.embed(tparams, tcfg, _t(tokens))
    close(tx["x"], jx["x"], atol=0)
    jcache = JM.init_cache(jcfg, jd, 1, b, cap)
    tcache = TM.init_cache(tcfg, td, 1, b, cap)
    for stage in range(2):
        sp_j = jax.tree.map(lambda a: a[stage], params["stages"])
        sp_t = {k: v[stage] for k, v in tparams["stages"].items()}
        dj = jax.tree.map(lambda a: a[stage], jdyn)
        dt = {k: v[stage] for k, v in tdyn.items()}
        cj = jax.tree.map(lambda a: a[stage][:, 0], jcache)
        ct = {k: v[stage][:, 0] for k, v in tcache.items()}
        jx, cj, jst, _ = JM.stage_forward(
            jcfg, jd, JDyn(kind="pruning"), "prefill", sp_j, {},
            jas["tags"][stage], dj, jx, cj, jnp.arange(s), 0)
        tx, ct, tst, _ = TM.stage_forward(
            tcfg, td, TDyn(kind="pruning"), "prefill", sp_t, {},
            tas["tags"][stage], dt, tx, ct, torch.arange(s), 0)
        close(tx["x"], jx["x"])
        close(tst["ff_active"], jst["ff_active"])
        for k in "kv":
            close(ct[k], cj[k], **BF16)
        # one decode step per lane at its own position, on the cache the
        # prefill just filled
        pos = np.array([s, s - 3], np.int32)
        xd = randn(rng, b, 1, 64, scale=0.5)
        jy, cj2, _, _ = JM.stage_forward(
            jcfg, jd, JDyn(kind="pruning"), "decode", sp_j, {},
            jas["tags"][stage], dj, {"x": jnp.asarray(xd)}, cj,
            jnp.asarray(pos), 0)
        ty, ct2, _, _ = TM.stage_forward(
            tcfg, td, TDyn(kind="pruning"), "decode", sp_t, {},
            tas["tags"][stage], dt, {"x": _t(xd)}, ct, _t(pos), 0)
        close(ty["x"], jy["x"])
        for k in "kv":
            close(ct2[k], cj2[k], **BF16)
