"""The port's serving path against the JAX package's.

* ``build_prefill_fn`` / ``build_decode_fn`` (dense and paged, per-lane
  positions, a live-micro variant) against the reference's with S = 1 in
  this process: ids equal, logprobs within 1e-4, caches within one bf16
  ulp.
* ``ElasticServer`` on the fixed bursty trace of ``test_paged.py`` (reduced
  smollm, m 2, B 2, seq 8, cache 16, page 4, pool 16, prefix cache,
  ``defrag_every=2``): completions token-identical to the reference's, and
  paged == dense inside the port.  S = 1 runs the reference in this process;
  S = 2 runs it in a 2-device subprocess that saves its params, dyn and
  assignment, which the port's 2-buffer run loads through ``convert``.
  Both sides use ``kernel_impl="pallas"`` (the reference's Pallas kernels in
  interpret mode, the port's kernels' plain versions on the CPU).
"""
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import run_in_subprocess  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import DistConfig as TDist  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduce  # noqa: E402
from repro_torch.dynamics.config import DynamicsConfig as TDyn  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.pipeline import pipeline as TP  # noqa: E402
from repro_torch.serve import ElasticServer as TServer  # noqa: E402
from repro_torch.serve.kv import PagedKVConfig as TPaged  # noqa: E402
from repro_torch.serve.requests import Request as TRequest  # noqa: E402

torch.set_num_threads(1)
SMALL = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=256)
BF16 = dict(atol=1e-4, rtol=2 ** -7)   # one bf16 ulp


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float().numpy()),
                               np.asarray(want, np.float32),
                               **(tol or dict(atol=1e-4, rtol=1e-4)))


def _jax_world(stages=1, impl="pallas"):
    from repro.configs import DistConfig, get_config, reduced_config
    cfg = reduced_config(get_config("smollm-360m"), **SMALL)
    dcfg = DistConfig(num_stages=stages, slot_slack=2, remat="none",
                      param_dtype="float32", kernel_impl=impl)
    return cfg, dcfg


def _torch_world(stages=1, impl="pallas"):
    return (treduce(tget("smollm-360m"), **SMALL),
            TDist(num_stages=stages, slot_slack=2, remat="none",
                  param_dtype="float32", kernel_impl=impl))


def test_prefill_and_decode_fns_match_reference():
    from repro.dynamics.config import DynamicsConfig
    from repro.launch.engine import _pack_pages
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as JM
    from repro.pipeline.pipeline import (PipelineShapes, build_decode_fn,
                                         build_prefill_fn)
    jcfg, jd = _jax_world()
    tcfg, td = _torch_world()
    m, B, seq, cap, page = 2, 2, 8, 16, 4
    jshapes = PipelineShapes(m, B, seq, cache_len=cap)
    tshapes = TP.PipelineShapes(m, B, seq, cache_len=cap)
    mesh = make_host_mesh(data=1, model=1)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg, jd)
    assign = JM.make_assignment(jcfg, jd)
    dyn = JM.init_dyn(jcfg, jd, DynamicsConfig(kind="pruning"))
    dyn = {**dyn, "ff_mask": dyn["ff_mask"].at[0, 2, 1].set(0.0)}
    tparams = convert.to_torch(jax.tree.map(np.asarray, params), "cpu")
    tdyn = convert.to_torch(jax.tree.map(np.asarray, dyn), "cpu")
    tas = TM.make_assignment(tcfg, td)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 256, (m, B, seq)).astype(np.int32)

    with mesh:
        jids, jcache, _ = jax.jit(build_prefill_fn(
            jcfg, jd, DynamicsConfig(kind="pruning"), mesh, jshapes))(
            params, assign, dyn, JM.init_cache(jcfg, jd, m, B, cap),
            {"tokens": jnp.asarray(tokens)})
    tids, tcache = TP.build_prefill_fn(tcfg, td, TDyn(kind="pruning"),
                                       tshapes)(
        tparams, tas, tdyn, TM.init_cache(tcfg, td, m, B, cap),
        {"tokens": torch.from_numpy(tokens)})
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    for k in "kv":
        close(tcache[k], jcache[k], **BF16)

    # per-lane decode, dense and paged (pool packed from the prefill cache)
    pos = np.array([[seq, seq - 3], [seq - 1, 2]], np.int32)
    nxt = np.array(jids)
    J = cap // page
    table = np.arange(m * B * J, dtype=np.int32).reshape(m, B, J)
    table[1, 1, 2:] = -1                      # unmapped tail pages
    pmask = np.ones((m, B, J), bool)
    jpool = JM.init_paged_cache(jcfg, jd, m * B * J, page)
    jpool = _pack_pages(jpool, jcache["k"], jcache["v"], jnp.asarray(table),
                        jnp.asarray(pmask))
    tpool = TM.init_paged_cache(tcfg, td, m * B * J, page)
    TE._pack_pages(tpool, tcache["k"], tcache["v"], torch.from_numpy(table),
                   torch.from_numpy(pmask))
    for key in ("kp", "vp"):
        close(tpool[key][:, :, :-1], np.asarray(jpool[key])[:, :, :-1],
              **BF16)
    for paged, live in ((False, None), (True, None), (True, 1)):
        with mesh:
            dec = jax.jit(build_decode_fn(
                jcfg, jd, DynamicsConfig(kind="pruning"), mesh, jshapes,
                paged=paged, num_micro=live))
            args = [params, assign, dyn, jpool if paged else jcache,
                    jnp.asarray(nxt), jnp.asarray(pos)]
            if paged:
                args.append(jnp.asarray(table))
            j_ids, j_lp, j_c, _ = dec(*args)
        t_dec = TP.build_decode_fn(tcfg, td, TDyn(kind="pruning"), tshapes,
                                   paged=paged, num_micro=live)
        t_cache = {k: v.clone() for k, v in (tpool if paged
                                             else tcache).items()}
        t_ids, t_lp, t_c = t_dec(tparams, tas, tdyn, t_cache,
                                 torch.from_numpy(nxt), torch.from_numpy(pos),
                                 torch.from_numpy(table) if paged else None)
        rows = slice(None) if live is None else slice(0, live)
        assert np.array_equal(t_ids.numpy()[rows], np.asarray(j_ids)[rows])
        close(t_lp[rows], np.asarray(j_lp)[rows])
        for key in t_c:
            got, want = t_c[key], np.asarray(j_c[key])
            if paged:                  # the trash block's bytes are free
                got, want = got[:, :, :-1], want[:, :, :-1]
            close(got, want, **BF16)


# ---------------------------------------------------------------------------
# ElasticServer on the bursty paged + prefix-cache trace
# ---------------------------------------------------------------------------
TRACE = """
import numpy as np
rng = np.random.RandomState(5)
shared = rng.randint(0, 256, 8).astype(np.int32)   # two full prompt pages
plens  = [8, 8, 5, 8, 3, 6, 8, 7]
gens   = [4, 6, 5, 2, 6, 3, 5, 4]
arrive = [0, 0, 1, 2, 3, 5, 6, 8]
TRACE = []
for i in range(8):
    p = (shared.copy() if plens[i] == 8
         else rng.randint(0, 256, plens[i]).astype(np.int32))
    TRACE.append((i, arrive[i], p, gens[i]))
"""


def _trace(request_cls):
    env = {}
    exec(TRACE, env)
    return [request_cls(rid=i, arrival=a, prompt=p, gen=g)
            for i, a, p, g in env["TRACE"]]


def _serve_torch(stages, params, paged=True):
    cfg, dcfg = _torch_world(stages)
    shapes = TP.PipelineShapes(num_micro=2, mb_global=2, seq=8,
                               cache_len=16)
    srv = TServer(cfg, dcfg, TDyn(), shapes, seed=0, defrag_every=2,
                  paged=(TPaged(page_size=4, pool_pages=16,
                                prefix_cache=True) if paged else None),
                  device="cpu", params=params)
    rep = srv.serve(_trace(TRequest))
    return {c["rid"]: c["tokens"] for c in rep["completions"]}, rep


def test_server_matches_reference_one_stage():
    from repro.dynamics.config import DynamicsConfig
    from repro.pipeline.pipeline import PipelineShapes
    from repro.serve import ElasticServer
    from repro.serve.kv import PagedKVConfig
    from repro.serve.requests import Request
    cfg, dcfg = _jax_world(1)
    srv = ElasticServer(cfg, dcfg, DynamicsConfig(),
                        PipelineShapes(num_micro=2, mb_global=2, seq=8,
                                       cache_len=16),
                        seed=0, defrag_every=2,
                        paged=PagedKVConfig(page_size=4, pool_pages=16,
                                            prefix_cache=True))
    rep = srv.serve(_trace(Request))
    want = {c["rid"]: c["tokens"] for c in rep["completions"]}
    params = convert.to_torch(jax.tree.map(np.asarray, srv.state.params),
                              "cpu")
    srv.close()
    got, trep = _serve_torch(1, params)
    assert got == want
    assert len(got) == 8 and trep["prefix_hits"] == rep["prefix_hits"] > 0
    assert trep["cow_forks"] == rep["cow_forks"]
    assert (trep["page_tile_live"], trep["page_tile_total"]) == (
        rep["page_tile_live"], rep["page_tile_total"])
    assert set(trep) == set(rep)
    dense, _ = _serve_torch(1, params, paged=False)
    assert dense == got


def test_server_matches_reference_two_stages(tmp_path):
    npz = os.path.join(str(tmp_path), "state.npz")
    out = run_in_subprocess(TRACE + f"""
import json
import jax
from repro.configs import DistConfig, get_config, reduced_config
from repro.dynamics.config import DynamicsConfig
from repro.pipeline.pipeline import PipelineShapes
from repro.serve import ElasticServer
from repro.serve.kv import PagedKVConfig
from repro.serve.requests import Request

cfg = reduced_config(get_config("smollm-360m"), **{SMALL!r})
dcfg = DistConfig(num_stages=2, slot_slack=2, remat="none",
                  param_dtype="float32", kernel_impl="pallas")
srv = ElasticServer(cfg, dcfg, DynamicsConfig(),
                    PipelineShapes(num_micro=2, mb_global=2, seq=8,
                                   cache_len=16),
                    seed=0, defrag_every=2,
                    paged=PagedKVConfig(page_size=4, pool_pages=16,
                                        prefix_cache=True))
rep = srv.serve([Request(rid=i, arrival=a, prompt=p, gen=g)
                 for i, a, p, g in TRACE])
flat = {{}}

def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        flat[prefix] = np.asarray(jax.device_get(tree))

for name in ("params", "dyn", "assignment"):
    put(name, getattr(srv.state, name))
np.savez({npz!r}, **flat)
print("COMPLETIONS " + json.dumps(
    {{c["rid"]: c["tokens"] for c in rep["completions"]}}))
""", devices=2)
    line = [ln for ln in out.splitlines() if ln.startswith("COMPLETIONS ")]
    want = {int(k): v for k, v in json.loads(line[-1][12:]).items()}
    tree = {"params": {"shared": {}}}
    with np.load(npz) as z:
        for key in z.files:
            node = tree
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    cfg, dcfg = _torch_world(2)
    tas = TM.make_assignment(cfg, dcfg)
    for k, v in tree["assignment"].items():
        assert np.array_equal(tas[k].numpy(), v), k
    tdyn = TM.init_dyn(cfg, dcfg, TDyn())
    for k, v in tree["dyn"].items():
        assert np.array_equal(tdyn[k].numpy(), v), k
    got, _ = _serve_torch(2, convert.to_torch(tree["params"], "cpu"))
    assert len(want) == 8
    assert got == want
