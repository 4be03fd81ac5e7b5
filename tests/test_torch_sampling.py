"""Sampling at temperature > 0: the port's counter-based sampler against
``jax.random.categorical``, and the sampling serve against the reference's.

The two packages draw from different random streams (Philox here, threefry
in jax), so they are held to each other by distribution, not by bits:

* for fixed logits over a vocabulary of 64 at T in {0.5, 1, 5}, 2^15 fixed
  lane seeds through the port's sampler and through
  ``jax.random.categorical(PRNGKey(seed), logits / T)`` (the reference's
  decode head) both pass a chi-squared test against ``softmax(logits / T)``
  at p >= 1e-3 (bins of expected count below 5 merged into one);
* the logprob the sampler returns is the reference's untempered
  ``log_softmax(logits)`` at the drawn id within 1e-5;
* at T = 1e-4 the draw is the argmax wherever the top-2 logit gap exceeds
  1e-3 (the Gumbel noise would have to exceed 10 there);
* Philox4x32-10 reproduces Random123's known-answer vectors;
* the reference's ``test_paged.py`` sampling scenario on both packages
  from the same params: two hot runs (T 5) are token-identical, they
  diverge from the argmax run, the same requests complete with the same
  lengths as the reference's, and the first token of each request whose
  prompt fills the prefill window is the argmax in both packages (the
  prefill emits it; a shorter prompt's first token comes from a decode and
  is sampled).
"""
import copy
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from scipy import stats  # noqa: E402

from conftest import run_in_subprocess  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.pipeline import sampling  # noqa: E402

torch.set_num_threads(1)
V, N = 64, 2 ** 15


def _logits(seed=0):
    return np.random.RandomState(seed).normal(0.0, 1.5, V).astype(np.float32)


def _chi2_p(ids: np.ndarray, probs: np.ndarray) -> float:
    """Chi-squared p-value of the draws against ``probs``, bins with an
    expected count below 5 merged into one."""
    counts = np.bincount(ids, minlength=len(probs)).astype(np.float64)
    expected = probs.astype(np.float64) * len(ids)
    small = expected < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(expected[~small], expected[small].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    return float(stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue)


@pytest.mark.parametrize("temperature", [0.5, 1.0, 5.0])
def test_sampler_and_jax_categorical_match_softmax(temperature):
    logits = _logits()
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits) / temperature),
                       np.float64)
    seeds = np.arange(N, dtype=np.int32)
    lt = torch.from_numpy(np.broadcast_to(logits, (N, V)).copy())
    ids, lp = sampling.sample(lt, torch.from_numpy(seeds), temperature)
    ids = ids.numpy()
    ref = np.asarray(jax.vmap(lambda s: jax.random.categorical(
        jax.random.PRNGKey(s), jnp.asarray(logits) / temperature))(
            jnp.asarray(seeds)))
    p_port, p_ref = _chi2_p(ids, probs), _chi2_p(ref, probs)
    assert p_port >= 1e-3, p_port
    assert p_ref >= 1e-3, p_ref
    # the logprob: the reference's untempered log_softmax at the drawn id
    want = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))[ids]
    np.testing.assert_allclose(lp.numpy(), want, rtol=0, atol=1e-5)
    assert ids.dtype == np.int32 and lp.dtype == torch.float32


def test_cold_temperature_is_the_argmax_where_the_gap_is_clear():
    rng = np.random.RandomState(3)
    logits = rng.normal(0.0, 1.0, (2048, V)).astype(np.float32)
    ids, _ = sampling.sample(torch.from_numpy(logits),
                             torch.arange(2048, dtype=torch.int32), 1e-4)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-3
    assert clear.sum() > 1900
    np.testing.assert_array_equal(ids.numpy()[clear],
                                  logits.argmax(-1)[clear])


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    t = [torch.tensor(c, dtype=torch.int64) for c in counter]
    k = [torch.tensor(c, dtype=torch.int64) for c in key]
    assert tuple(int(w) for w in sampling.philox4x32(t, k)) == want


def test_uniforms_are_in_range_and_lane_independent():
    seeds = torch.tensor([0, 1, 2 ** 31 - 1, 7], dtype=torch.int32)
    u = sampling.uniforms(seeds, 4096)
    assert u.dtype == torch.float32 and u.shape == (4, 4096)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    # a lane's draw depends on its own seed only
    again = sampling.uniforms(seeds[[3, 0]], 4096)
    assert torch.equal(again, u[[3, 0]])
    assert not torch.equal(u[0], u[1])


SCENARIO = """
import copy, json
import jax
import numpy as np
from repro.configs import DistConfig, get_config, reduced_config
from repro.dynamics.config import DynamicsConfig
from repro.pipeline.pipeline import PipelineShapes
from repro.serve import ElasticServer
from repro.serve.requests import Request

cfg = reduced_config(get_config("smollm-360m"), num_layers=4, d_model=64,
                     num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256)
dcfg = DistConfig(num_stages=2, slot_slack=2, remat="none",
                  param_dtype="float32")
rng = np.random.RandomState(2)
base = [Request(rid=i, arrival=0,
                prompt=rng.randint(0, 256, [8, 5, 7, 8][i])
                .astype(np.int32),
                gen=[6, 5, 6, 4][i]) for i in range(4)]

def serve(temperature):
    shapes = PipelineShapes(num_micro=2, mb_global=2, seq=8, cache_len=16)
    srv = ElasticServer(cfg, dcfg, DynamicsConfig(), shapes, seed=0,
                        temperature=temperature)
    rep = srv.serve(copy.deepcopy(base))
    params = srv.state.params
    srv.close()
    return {c["rid"]: c["tokens"] for c in rep["completions"]}, params

argmax, params = serve(0.0)
hot1, _ = serve(5.0)
hot2, _ = serve(5.0)
assert hot1 == hot2 and hot1 != argmax
flat = {}

def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        flat[prefix] = np.asarray(jax.device_get(tree))

put("params", params)
np.savez(NPZ, **flat)
print("REPORT " + json.dumps({"argmax": argmax, "hot": hot1}))
"""


def _serve_port(params, temperature):
    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.pipeline.pipeline import PipelineShapes
    from repro_torch.serve import ElasticServer
    from repro_torch.serve.requests import Request
    cfg = reduced_config(get_config("smollm-360m"), num_layers=4,
                         d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                         vocab_size=256)
    dcfg = DistConfig(num_stages=2, slot_slack=2, remat="none",
                      param_dtype="float32")
    rng = np.random.RandomState(2)
    base = [Request(rid=i, arrival=0,
                    prompt=rng.randint(0, 256, [8, 5, 7, 8][i])
                    .astype(np.int32),
                    gen=[6, 5, 6, 4][i]) for i in range(4)]
    srv = ElasticServer(cfg, dcfg, DynamicsConfig(),
                        PipelineShapes(num_micro=2, mb_global=2, seq=8,
                                       cache_len=16),
                        seed=0, temperature=temperature, device="cpu",
                        params=params)
    rep = srv.serve(copy.deepcopy(base))
    srv.close()
    return {str(c["rid"]): c["tokens"] for c in rep["completions"]}


def test_sampling_serve_matches_reference_scenario(tmp_path):
    npz = os.path.join(str(tmp_path), "params.npz")
    out = run_in_subprocess(f"NPZ = {npz!r}\n" + SCENARIO, devices=2)
    want = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("REPORT ")][-1][7:])
    tree = {"params": {"shared": {}}}
    with np.load(npz) as z:
        for key in z.files:
            node = tree
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    params = convert.to_torch(tree["params"], "cpu")
    argmax = _serve_port(params, 0.0)
    hot1 = _serve_port(params, 5.0)
    hot2 = _serve_port(params, 5.0)
    assert argmax == want["argmax"]          # temperature 0: token identity
    assert hot1 == hot2                      # deterministic per seed
    assert hot1 != argmax                    # a hot temperature diverges
    assert sorted(hot1) == sorted(want["hot"])
    assert {r: len(t) for r, t in hot1.items()} == {
        r: len(t) for r, t in want["hot"].items()}
    for rid in ("0", "3"):                   # prompts of 8: prefill argmax
        assert hot1[rid][0] == argmax[rid][0] == want["hot"][rid][0]
    assert any(hot1[r][0] != argmax[r][0] for r in ("1", "2"))


def test_sampling_decode_needs_seeds():
    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.pipeline.pipeline import PipelineShapes
    cfg = reduced_config(get_config("smollm-360m"), num_layers=2,
                         d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                         vocab_size=256)
    eng = ElasticEngine(cfg, DistConfig(num_stages=1), DynamicsConfig(),
                        PipelineShapes(1, 2, 4, cache_len=8),
                        temperature=0.7, device="cpu")
    st = eng.init_state(0, with_cache=True)
    tok = torch.zeros((1, 2), dtype=torch.int32)
    pos = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="seeds"):
        eng.decode(st, tok, pos)
    seeds = torch.tensor([[5, 9]], dtype=torch.int32)
    a = eng.decode(copy.deepcopy(st), tok, pos, seeds=seeds)
    b = eng.decode(copy.deepcopy(st), tok, pos, seeds=seeds)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
