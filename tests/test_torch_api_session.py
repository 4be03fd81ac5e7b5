"""The port's ``Session`` against the reference's, on the CPU.

One reference subprocess (4 host devices) runs, from the scenario configs
at CPU scale (8 layers, d_model 64, 4 stages):
* ``Session.train`` of ``pruning`` (12 steps: the prune at step 10),
  ``freezing`` (16 steps: the freeze at 10 and a rebalance at 15) and
  ``early_exit`` (8 steps);
* ``Session.serve`` of the ``early_exit`` scenario's serve spec (6
  requests, half of them tagged early_exit);
* the legacy one-shot ``run_serving`` with and without a rebalance
  between decode rounds;
and exports the reference's initial params, which the port's runs take
through ``params=`` (random streams do not cross frameworks).

The port's ``Session`` must give the same losses (within 1e-4), the same
rebalance events and resizes and the same ``SessionEvent`` kinds in
order; the same served tokens; the same one-shot tokens.  The port's
``run_serving`` also equals its own continuous server on a full batch
arriving at once (the reference's oracle, ``tests/test_serve.py``).
"""
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from conftest import REPO, run_in_subprocess  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import RunSpec, Session, scenario  # noqa: E402

torch.set_num_threads(1)
TRAIN = {"pruning": 12, "freezing": 16, "early_exit": 8}
SERVE = {"serve.requests": 6, "serve.prompt_len": 8, "serve.gen": 4,
         "serve.early_exit_frac": 0.5}
ONE_SHOT = dict(stages=4, micro=2, mb_global=2, prompt_len=8, gen=5,
                layers=8, d_model=64, seed=0)

REF = """
import json
import numpy as np
import jax
from repro.api import Session, scenario
from repro.launch.serve import run_serving
from repro.models import model as JM

out, flat = {}, {}

def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        flat[prefix] = np.asarray(jax.device_get(tree))

for name, steps in TRAIN.items():
    spec = scenario(name).override({"steps": steps})
    with Session(spec) as s:
        if name == "pruning":
            put("train", JM.init_params(jax.random.PRNGKey(spec.seed),
                                        s._model_config(),
                                        s._dist_config()))
        rep = s.train()
    out[name] = {
        "losses": rep["losses"],
        "events": [[e.iteration, e.moved_layers] for e in rep["events"]],
        "resizes": [[r["kind"], r["step"], r["from_stages"],
                     r["to_stages"], r["workers"]] for r in rep["resizes"]],
        "kinds": [ev.kind for ev in s.events],
        "final_lps": rep["final_lps"], "spec": rep["spec"]}
spec = scenario("early_exit").override(SERVE)
with Session(spec) as s:
    rep = s.serve()
    put("serve", s._server.state.params)
out["serve"] = {"tokens": [[c["rid"], c["tokens"]]
                           for c in rep["completions"]],
                "kinds": [ev.kind for ev in s.events]}
for every in (0, 2):
    r = run_serving("smollm-360m", rebalance_every=every, **ONE_SHOT)
    out[f"one_shot_{every}"] = {"tokens": r["tokens"].tolist(),
                                "final_lps": list(r["final_lps"])}
np.savez(NPZ, **flat)
print("REPORT " + json.dumps(out))
"""


def _tree(z, prefix):
    """The numpy tree under ``prefix`` (each run converts its own copy: the
    engine trains the tensors it is given in place)."""
    tree = {"shared": {}}
    for key in z.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *path, leaf = key.split("/")[1:]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = z[key]
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    npz = str(tmp_path_factory.mktemp("ref") / "params.npz")
    code = (f"NPZ = {npz!r}\nTRAIN = {TRAIN!r}\nSERVE = {SERVE!r}\n"
            f"ONE_SHOT = {ONE_SHOT!r}\n" + REF)
    out = run_in_subprocess(code, devices=4)
    want = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("REPORT ")][-1][7:])
    with np.load(npz) as z:
        params = {"train": _tree(z, "train"), "serve": _tree(z, "serve")}
    return want, params


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_session_train_matches_reference(reference, name):
    want, params = reference
    spec = scenario(name).override({"steps": TRAIN[name]})
    with Session(spec, device="cpu",
                 params=convert.to_torch(params["train"], "cpu")) as s:
        rep = s.train()
    w = want[name]
    np.testing.assert_allclose(rep["losses"], w["losses"], rtol=0,
                               atol=1e-4)
    assert [[e.iteration, e.moved_layers] for e in rep["events"]] \
        == w["events"]
    assert [[r["kind"], r["step"], r["from_stages"], r["to_stages"],
             r["workers"]] for r in rep["resizes"]] == w["resizes"]
    assert [ev.kind for ev in s.events] == w["kinds"]
    assert rep["final_lps"] == w["final_lps"]
    assert rep["spec"] == w["spec"] == spec.to_dict()
    assert s.events[-1].kind == "train_summary"
    if name == "freezing":
        assert w["events"], "the freezing run rebalances at iteration 15"
    snap = s.metrics.snapshot()
    steps = [c for c in snap["counters"]
             if c["name"] == "dynmo_train_steps_total"]
    assert steps and steps[0]["value"] == TRAIN[name]


def test_session_serve_matches_reference(reference):
    want, params = reference
    spec = scenario("early_exit").override(SERVE)
    with Session(spec, device="cpu",
                 params=convert.to_torch(params["serve"], "cpu")) as s:
        rep = s.serve()
    assert [[c["rid"], c["tokens"]] for c in rep["completions"]] \
        == want["serve"]["tokens"]
    assert [ev.kind for ev in s.events] == want["serve"]["kinds"]
    assert rep["spec"] == spec.to_dict()
    assert {c["kind"] for c in rep["completions"]} == {"early_exit", "none"}


@pytest.mark.parametrize("every", [0, 2])
def test_run_serving_matches_reference(reference, every):
    from repro_torch.launch.serve import run_serving
    want, params = reference
    got = run_serving("smollm-360m", rebalance_every=every, device="cpu",
                      params=convert.to_torch(params["train"], "cpu"),
                      **ONE_SHOT)
    assert got["tokens"].tolist() == want[f"one_shot_{every}"]["tokens"]
    assert list(got["final_lps"]) == want[f"one_shot_{every}"]["final_lps"]
    assert got["tokens"].shape == (2, 2, 5)


def test_run_serving_equals_the_continuous_server_on_a_full_batch():
    """A full batch arriving at once through the port's continuous
    scheduler reproduces the port's one-shot tokens exactly (same seed,
    same prompts)."""
    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.serve import run_serving
    from repro_torch.pipeline.pipeline import PipelineShapes
    from repro_torch.serve import ElasticServer
    from repro_torch.serve.requests import Request
    micro, mbg, plen, gen = 2, 2, 8, 5
    ref = run_serving("smollm-360m", stages=4, micro=micro, mb_global=mbg,
                      prompt_len=plen, gen=gen, layers=8, d_model=64,
                      seed=0, device="cpu")["tokens"]
    cfg = reduced_config(get_config("smollm-360m"), num_layers=8,
                         d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                         vocab_size=512)
    dcfg = DistConfig(num_stages=4, slot_slack=2, remat="none",
                      param_dtype="float32")
    shapes = PipelineShapes(num_micro=micro, mb_global=mbg, seq=plen,
                            cache_len=plen + gen)
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab_size, (micro, mbg, plen))
    reqs = [Request(rid=i, arrival=0,
                    prompt=prompts[i // mbg, i % mbg].astype(np.int32),
                    gen=gen) for i in range(micro * mbg)]
    srv = ElasticServer(cfg, dcfg, DynamicsConfig(), shapes, seed=0,
                        device="cpu")
    rep = srv.serve(reqs)
    srv.close()
    for i, c in enumerate(rep["completions"]):
        assert ref[i // mbg, i % mbg].tolist() == c["tokens"], i


def test_config_cli_runs_a_scenario_and_resumes_its_spec(tmp_path):
    """``--config`` + ``--set`` through the port's train CLI, with safe
    points: the resumed Session's RunSpec equals the one that wrote them,
    and its tail equals the uninterrupted run's."""
    from repro_torch.launch.train import run
    ck = str(tmp_path / "ck")
    path = os.path.join(REPO, "configs", "scenarios", "early_exit.json")
    full = run(["--config", path, "--set", "steps=6", "--set",
                f"ckpt_dir={ck}", "--set", "ckpt_every=3", "--device",
                "cpu"])
    spec = RunSpec.load(path).override({"steps": 6, "ckpt_dir": ck,
                                        "ckpt_every": 3})
    assert full["spec"] == spec.to_dict()
    resumed = Session.resume(ck, step=2, device="cpu")
    assert resumed.spec == spec
    with resumed as s:
        tail = s.train()
    assert tail["losses"] == full["losses"][3:]
    assert [e["kind"] for e in full["session_events"]].count(
        "safepoint") == 2


def test_session_serve_probes_stage_times_and_saves_metrics(tmp_path):
    """``controller.measure_stage_times`` probes each stage once the trace
    drains (the reference's serve report key), and ``obs.metrics_out``
    saves the session's registry on close; with ``obs.trace`` and
    ``obs.metrics_port`` the same serve is traced and serves its registry
    at ``GET /metrics`` until the session closes."""
    out = str(tmp_path / "metrics.json")
    spec = scenario("early_exit").override(
        {**SERVE, "controller.measure_stage_times": True,
         "obs.metrics_out": out})
    with Session(spec, device="cpu") as s:
        rep = s.serve()
    mt = rep["measured_stage_times"]
    assert rep["stage_time_source"] == "probe"
    assert len(mt) == spec.parallel.stages and all(t > 0 for t in mt)
    with open(out) as f:
        gauges = {g["name"]: g["value"] for g in json.load(f)["gauges"]}
    assert gauges["dynmo_tokens_per_s"] == rep["tokens_per_s"]
    import socket
    import urllib.request
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    with Session(spec.override({"obs.trace": True,
                                "obs.metrics_port": port}),
                 device="cpu") as s:
        traced = s.serve()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r:
            page = r.read().decode()
        names = {e[0] for e in s.tracer.event_sequence()}
    assert {"serve", "serve.tick", "serve.admit"} <= names
    assert f"dynmo_serve_ticks_total {traced['ticks']}" in page
    assert traced["completions"] == rep["completions"]
