"""Early exit and Mixture-of-Depths in the port, against the JAX package.

* ``_ee_update`` and ``_mod_wrap`` against the reference's on seeded numpy
  inputs (early exit below and above its minimum depth, with tokens near
  the cosine threshold and tokens already exited; MoD switched on with a
  random router and switched off): within 1e-6, exited tokens bitwise
  frozen, MoD's selection exact.
* ``reference_loss`` with early exit (the default threshold and 0.85, at
  which tokens exit) and with MoD switched on: within 1e-5 of the
  reference's, and the pipelined loss with its gradients within 1e-5 of the
  port's ``reference_loss`` (its autograd).
* ``slot_exec="bounded_loop"`` is bitwise the ``masked_scan`` loss and
  gradients.
* The train CLI on ``configs/scenarios/early_exit.json`` and ``mod.json``
  (their flags, 4 stages, 15 steps; the reference's CLI in a 4-device
  subprocess, its params handed over through ``convert``): losses within
  1e-4, the same rebalance events and final split; the ``mod`` run is
  bitwise the ``none`` run (``mod_on`` is zero, as in the reference).
* The serve CLI with ``--dynamism early_exit --early-exit-frac 0.5`` on the
  reduced two-stage paged serve (the reference's in a 2-device
  subprocess): completions token-identical at temperature 0.
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
from repro_torch.launch.serve import run as serve_run  # noqa: E402
from repro_torch.launch.train import run as train_run  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.pipeline import pipeline as TP  # noqa: E402
from test_torch_train import _assert_grads, _leaves, _np  # noqa: E402
from test_torch_train_cli import reference_run  # noqa: E402

torch.set_num_threads(1)
SMALL = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=256)


def _ee_inputs(seed=0, b=2, s=16, d=32):
    """x_in, x_out with a third of the tokens barely changed (cosine above
    0.98), a third near the threshold, the rest changed; a few tokens
    already exited."""
    r = np.random.RandomState(seed)
    x_in = r.randn(b, s, d).astype(np.float32)
    noise = r.randn(b, s, d).astype(np.float32)
    scale = np.array([0.05, 0.2, 1.5])[np.arange(s) % 3]
    x_out = (x_in + noise * scale[None, :, None]).astype(np.float32)
    exited = (r.rand(b, s) < 0.25).astype(np.float32)
    return x_in, x_out, exited


@pytest.mark.parametrize("depth_frac", [0.125, 0.5])
def test_ee_update_matches_reference(depth_frac):
    from repro.dynamics.config import DynamicsConfig
    from repro.models.model import _ee_update
    x_in, x_out, exited = _ee_inputs()
    jc, jf = _ee_update(None, DynamicsConfig(kind="early_exit"),
                        {"x": jnp.asarray(x_in),
                         "exited": jnp.asarray(exited)},
                        {"x": jnp.asarray(x_out)}, jnp.float32(depth_frac))
    tc, tf = TM._ee_update(None, TDyn(kind="early_exit"),
                           {"x": torch.from_numpy(x_in),
                            "exited": torch.from_numpy(exited)},
                           {"x": torch.from_numpy(x_out)}, depth_frac)
    np.testing.assert_array_equal(tc["exited"].numpy(),
                                  np.asarray(jc["exited"]))
    np.testing.assert_allclose(tc["x"].numpy(), np.asarray(jc["x"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tf), float(jf), rtol=0, atol=1e-6)
    # exited tokens keep their input bit for bit; the rest take the output
    was = exited > 0
    np.testing.assert_array_equal(tc["x"].numpy()[was], x_in[was])
    np.testing.assert_array_equal(tc["x"].numpy()[~was], x_out[~was])
    newly = tc["exited"].numpy() - exited
    assert (newly.sum() > 0) == (depth_frac >= 0.25)
    # decode carries no marks: the output passes unchanged
    out, frac = TM._ee_update(None, TDyn(kind="early_exit"),
                              {"x": torch.from_numpy(x_in)},
                              {"x": torch.from_numpy(x_out)}, depth_frac)
    assert torch.equal(out["x"], torch.from_numpy(x_out))
    assert frac == 1.0


@pytest.mark.parametrize("on", [0.0, 1.0])
def test_mod_wrap_matches_reference(on):
    from repro.dynamics.config import DynamicsConfig
    from repro.models.model import _mod_wrap
    r = np.random.RandomState(1)
    x_in = r.randn(2, 16, 32).astype(np.float32)
    x_out = r.randn(2, 16, 32).astype(np.float32)
    router = r.randn(32).astype(np.float32)
    jdyn = {"mod_router": jnp.asarray(router), "mod_on": jnp.float32(on)}
    tdyn = {"mod_router": torch.from_numpy(router),
            "mod_on": torch.tensor(on)}
    jc, jf = _mod_wrap(None, DynamicsConfig(kind="mod"), jdyn,
                       {"x": jnp.asarray(x_in)}, {"x": jnp.asarray(x_out)})
    tc, tf = TM._mod_wrap(None, TDyn(kind="mod"), tdyn,
                          {"x": torch.from_numpy(x_in)},
                          {"x": torch.from_numpy(x_out)})
    np.testing.assert_allclose(tc["x"].numpy(), np.asarray(jc["x"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tf), float(jf), rtol=0, atol=1e-6)
    got = tc["x"].numpy()
    took_out = np.all(got == x_out, axis=-1)
    if on:
        # exactly the top half of each row's router scores took the block
        scores = x_in @ router
        top = scores >= np.sort(scores, axis=-1)[:, -8:-7]
        np.testing.assert_array_equal(took_out, top)
        np.testing.assert_array_equal(got[~top], x_in[~top])
    else:
        assert took_out.all()


def _loss_worlds(kind, **dkw):
    from repro.configs import DistConfig, get_config, reduced_config
    from repro.dynamics.config import DynamicsConfig
    kw = dict(num_stages=2, slot_slack=2, remat="none",
              param_dtype="float32", kernel_impl="pallas")
    return ((reduced_config(get_config("smollm-360m"), **SMALL),
             DistConfig(**kw), DynamicsConfig(kind=kind, **dkw)),
            (treduce(tget("smollm-360m"), **SMALL), TDist(**kw),
             TDyn(kind=kind, **dkw)))


def _loss_inputs(jcfg, jd, jdyn, tcfg, td, tdyn):
    from repro.models import model as JM
    params = JM.init_params(jax.random.PRNGKey(0), jcfg, jd)
    dyn = _np(JM.init_dyn(jcfg, jd, jdyn))
    if "mod_on" in dyn:
        # switch MoD on in every slot with a random router (the reference
        # never sets it; the wrapper's math must hold anyway)
        r = np.random.RandomState(3)
        dyn["mod_on"] = np.ones_like(dyn["mod_on"])
        dyn["mod_router"] = r.randn(*dyn["mod_router"].shape).astype(
            np.float32)
    r = np.random.RandomState(2)
    tokens = r.randint(0, jcfg.vocab_size, (4, 64)).astype(np.int32)
    labels = r.randint(0, jcfg.vocab_size, (4, 64)).astype(np.int32)
    tparams = convert.to_torch(_np(params), "cpu")
    tassign = TM.make_assignment(tcfg, td)
    tdynt = {k: torch.from_numpy(np.asarray(v)) for k, v in dyn.items()}
    return params, dyn, tokens, labels, tparams, tassign, tdynt


@pytest.mark.parametrize("kind,dkw", [
    ("early_exit", {}), ("early_exit", {"ee_threshold": 0.85}),
    ("mod", {})])
def test_reference_loss_and_pipeline(kind, dkw):
    from repro.models import model as JM
    (jcfg, jd, jdyn), (tcfg, td, tdyn) = _loss_worlds(kind, **dkw)
    params, dyn, tokens, labels, tp, ta, tdy = _loss_inputs(
        jcfg, jd, jdyn, tcfg, td, tdyn)
    ja = JM.make_assignment(jcfg, jd)
    want = float(JM.reference_loss(jcfg, jd, jdyn, params, ja,
                                   jax.tree.map(jnp.asarray, dyn),
                                   jnp.asarray(tokens),
                                   jnp.asarray(labels)))
    got = TM.reference_loss(tcfg, td, tdyn, tp, ta, tdy,
                            torch.from_numpy(tokens),
                            torch.from_numpy(labels))
    assert float(got) == pytest.approx(want, rel=1e-5)
    # the pipelined loss (2 stage buffers, 2 microbatches) and its
    # gradients against autograd of the port's reference_loss
    shapes = TP.PipelineShapes(2, 2, 64)
    batch = {"tokens": torch.from_numpy(tokens.reshape(2, 2, 64)),
             "labels": torch.from_numpy(labels.reshape(2, 2, 64)),
             "label_mask": torch.ones(2, 2, 64)}
    loss, stats, grads = TP.value_and_grad(
        TP.build_loss_fn(tcfg, td, tdyn, shapes), tp, ta, tdy, batch)
    leaves = dict(_leaves(tp))
    ref = {k: v.detach().clone().requires_grad_(True)
           for k, v in leaves.items()}

    def tree(flat):
        out = {"shared": {}}
        for k, v in flat.items():
            node = out
            *path, leaf = k.strip("/").split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        return out

    rl = TM.reference_loss(tcfg, td, tdyn, tree(ref), ta, tdy,
                           torch.from_numpy(tokens),
                           torch.from_numpy(labels))
    rg = torch.autograd.grad(rl, list(ref.values()), allow_unused=True)
    assert float(loss) == pytest.approx(float(rl), rel=1e-5)
    _assert_grads(grads, tree({k: (torch.zeros_like(v) if g is None else g)
                               for (k, v), g in zip(ref.items(), rg)}))
    if kind == "early_exit":
        frac = float(stats["exited_frac"])
        assert (frac > 0) == ("ee_threshold" in dkw), frac
    else:
        assert "exited_frac" not in stats


@pytest.mark.parametrize("kind", ["early_exit", "pruning"])
def test_bounded_loop_is_bitwise_masked_scan(kind):
    (_, _, _), (tcfg, td, tdyn) = _loss_worlds(kind, ee_threshold=0.85)
    import dataclasses
    r = np.random.RandomState(4)
    batch = {"tokens": torch.from_numpy(r.randint(0, 256, (2, 2, 64))),
             "labels": torch.from_numpy(r.randint(0, 256, (2, 2, 64))),
             "label_mask": torch.ones(2, 2, 64)}
    gen = torch.Generator().manual_seed(0)
    params = TM.init_params(gen, tcfg, td)
    assign = TM.make_assignment(tcfg, td, [3, 1])    # uneven: a PAD run
    dyn = TM.init_dyn(tcfg, td, tdyn)
    out = []
    for exe in ("masked_scan", "bounded_loop"):
        d = dataclasses.replace(td, slot_exec=exe)
        loss_fn = TP.build_loss_fn(tcfg, d, tdyn, TP.PipelineShapes(2, 2,
                                                                    64))
        out.append(TP.value_and_grad(loss_fn, params, assign, dyn, batch))
    (l0, _, g0), (l1, _, g1) = out
    assert torch.equal(l0, l1)
    for (k, a), (_, b) in zip(_leaves(g0), _leaves(g1)):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# the train CLI on the scenario configs
# ---------------------------------------------------------------------------
SCENARIOS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "scenarios")


def _scenario_flags(name):
    """The port's flags for ``configs/scenarios/<name>.json``."""
    with open(os.path.join(SCENARIOS, f"{name}.json")) as f:
        spec = json.load(f)
    m, p = spec["model"], spec["parallel"]
    return ["--layers", str(m["layers"]), "--d-model", str(m["d_model"]),
            "--num-heads", str(m["num_heads"]),
            "--num-kv-heads", str(m["num_kv_heads"]),
            "--vocab-size", str(m["vocab_size"]),
            "--stages", str(p["stages"]),
            "--num-micro", str(p["num_micro"]),
            "--mb-global", str(p["mb_global"]), "--seq", str(p["seq"]),
            "--slot-slack", str(p["slot_slack"]), "--remat", p["remat"],
            "--param-dtype", p["param_dtype"],
            "--kernel-impl", p["kernel_impl"],
            "--dynamism", spec["dynamics"]["kind"],
            "--balancer", spec["controller"]["balancer"],
            "--rebalance-every",
            str(spec["controller"]["rebalance_every"]),
            "--seed", str(spec["seed"]), "--log-every", "100"]


@pytest.mark.parametrize("name,extra", [
    ("early_exit", []), ("early_exit", ["--dynamics.ee_threshold", "0.95"]),
    ("mod", [])])
def test_scenario_cli_matches_reference(tmp_path, name, extra):
    steps = ["--steps", "15"]
    want, params = reference_run(
        ["--config", os.path.join(SCENARIOS, f"{name}.json"),
         "--log-every", "100"]
        + steps + extra, tmp_path, devices=4)
    rep = train_run(_scenario_flags(name) + steps + extra
                    + ["--device", "cpu"],
                    params=convert.to_torch(params, "cpu"))
    np.testing.assert_allclose(rep["losses"], want["losses"], rtol=0,
                               atol=1e-4)
    assert [[e.iteration, e.moved_layers] for e in rep["events"]] \
        == want["events"]
    assert rep["final_lps"] == want["final_lps"]
    if name == "mod":
        # mod_on is zero, so MoD's mix is off: bitwise the "none" run
        none = train_run([a if a != "mod" else "none"
                          for a in _scenario_flags(name)] + steps
                         + ["--device", "cpu"],
                         params=convert.to_torch(params, "cpu"))
        assert rep["losses"] == none["losses"]
        for (k, a), (_, b) in zip(_leaves(rep["params"]),
                                  _leaves(none["params"])):
            assert torch.equal(a, b), k
    elif extra:
        assert max(rep["exited_frac"].values()) > 0


# ---------------------------------------------------------------------------
# the serve CLI with early exit
# ---------------------------------------------------------------------------
SERVE = ["--elastic", "--stages", "2", "--layers", "4", "--d-model", "64",
         "--micro", "2", "--mb-global", "2", "--prompt-len", "8", "--gen",
         "8", "--requests", "8", "--kv-page-size", "4", "--prefix-cache",
         "--defrag-every", "2", "--kernel-impl", "pallas", "--seed", "0",
         "--dynamism", "early_exit", "--early-exit-frac", "0.5"]


@pytest.mark.parametrize("extra", [[], ["--dynamics.ee_threshold", "0.9"]])
def test_ee_serve_matches_reference(tmp_path, extra):
    npz = os.path.join(str(tmp_path), "params.npz")
    ref = SERVE + ["--model.num_heads", "4", "--model.num_kv_heads", "2",
                   "--model.d_ff", "256", "--model.vocab_size", "256"]
    out = run_in_subprocess(f"""
import argparse, json
import numpy as np
import jax
from repro.api.cli import (SERVE_ALIASES, SERVE_CLI_DEFAULTS,
                           add_alias_flags, add_config_args, add_spec_flags,
                           build_spec)
from repro.api.session import Session
from repro.models import model as JM

ap = argparse.ArgumentParser()
add_config_args(ap)
add_alias_flags(ap, SERVE_ALIASES)
add_spec_flags(ap)
ap.add_argument("--elastic", action="store_true")
spec = build_spec(ap.parse_args({ref + extra!r}), SERVE_ALIASES,
                  cli_defaults=SERVE_CLI_DEFAULTS)
with Session(spec) as s:
    params = JM.init_params(jax.random.PRNGKey(spec.seed),
                            s._model_config(), s._dist_config())
    rep = s.serve()
flat = {{}}

def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        flat[prefix] = np.asarray(jax.device_get(tree))

put("params", params)
np.savez({npz!r}, **flat)
print("COMPLETIONS " + json.dumps(
    {{c["rid"]: [c["kind"], c["tokens"]] for c in rep["completions"]}}))
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
    rep = serve_run(SERVE + ["--d-ff", "256", "--vocab-size", "256",
                             "--device", "cpu"] + extra,
                    params=convert.to_torch(tree["params"], "cpu"))
    got = {c["rid"]: [c["kind"], c["tokens"]] for c in rep["completions"]}
    assert len(got) == 8
    assert {k for k, _ in got.values()} == {"none", "early_exit"}
    assert got == want
