"""The port's autoscaled training and serving against the reference's.

* The train CLI with the flags of the reference's end-to-end autoscale
  demo (``test_cluster.py``: reduced smollm, 8 layers, d_model 128, 4
  stages, 4 microbatches of 2 x 32 tokens, 30 steps, ``--dynamism pruning
  --repack --async-controller --autoscale --simulate-recover 18
  --job-manager file``; ``--async-drain`` on both sides so the decision
  lands on a fixed step) against the reference's Session from the same
  params: the controller's shrink 4 -> 2 releases workers 2 and 3 across
  the file RPC boundary, the heartbeat recovery grows them back, with the
  reference's resizes, client-side pool log and autoscale decisions, and
  losses within 1e-4.
* The same run through safe points (``--ckpt-every 8``) resumed from the
  2-buffer safe point after the shrink: the autoscaler's state rides the
  safe point and the pool seeds the new manager's journal, so the resumed
  tail grows back at the same step with the same decisions and bitwise
  the same losses as the uninterrupted run.
* The reference's serving autoscale cycle (``test_serve.py``: reduced
  smollm, 8 layers, 4 stages, a bursty 14-request trace, min 2 stages,
  queue watermark 2, occupancy 0.6, patience 2, cooldown 3) on both
  packages from the same params: the same decisions and resizes, pool log
  releases and grants, tokens identical to each other and to the fixed
  run.
"""
import copy
import json
import os
import re

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from conftest import run_in_subprocess  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from test_torch_train_cli import reference_run  # noqa: E402

torch.set_num_threads(1)
FLAGS = ["--layers", "8", "--d-model", "128", "--stages", "4",
         "--num-micro", "4", "--mb-global", "2", "--seq", "32", "--steps",
         "30", "--dynamism", "pruning", "--repack", "--rebalance-every", "5",
         "--log-every", "1000", "--async-controller", "--async-drain",
         "--autoscale", "--simulate-recover", "18", "--job-manager", "file",
         "--seed", "0"]
REF_WIDTHS = ["--model.num_heads", "4", "--model.num_kv_heads", "2",
              "--model.d_ff", "256", "--model.vocab_size", "512"]
PORT_WIDTHS = ["--num-heads", "4", "--num-kv-heads", "2", "--d-ff", "256",
               "--vocab-size", "512"]
KEYS = ("resizes", "pool_log", "autoscale_decisions", "final_stages",
        "stages_history", "degraded_events")


def _resizes(rz):
    return [(r["kind"], r["step"], r["from_stages"], r["to_stages"],
             r["workers"]) for r in rz]


@pytest.fixture(scope="module")
def port_params(tmp_path_factory):
    """The reference's run and its initial params, shared by the tests."""
    want, params = reference_run(FLAGS + REF_WIDTHS,
                                 tmp_path_factory.mktemp("ref"), keys=KEYS,
                                 devices=4)
    return want, convert.to_torch(params, "cpu")


def test_autoscaled_train_over_file_manager_matches_reference(port_params,
                                                               tmp_path):
    want, params = port_params
    rep = run(FLAGS + PORT_WIDTHS + ["--device", "cpu", "--job-manager-dir",
                                     str(tmp_path)], params=params)
    assert _resizes(rep["resizes"]) == _resizes(want["resizes"])
    assert _resizes(rep["resizes"]) == [("shrink", 14, 4, 2, [2, 3]),
                                        ("grow", 18, 2, 4, [2, 3])]
    assert rep["pool_log"] == want["pool_log"] == [
        "release:2", "release:3", "grant:2", "grant:3"]
    assert rep["autoscale_decisions"] == want["autoscale_decisions"]
    assert any(d["action"] == "grow" and set(d["ids"]) == {2, 3}
               for d in rep["autoscale_decisions"])
    assert rep["stages_history"] == want["stages_history"]
    assert rep["final_stages"] == want["final_stages"] == 4
    assert rep["degraded_events"] == want["degraded_events"] == []
    np.testing.assert_allclose(rep["losses"], want["losses"], rtol=0,
                               atol=1e-4)
    assert rep["rpc"]["stats"]["timeouts"] == 0
    kinds = [e["kind"] for e in rep["session_events"]]
    assert kinds.count("resize") == 2 and "autoscale" in kinds
    # the manager's process is gone and its directory holds its journal
    (run_dir,) = os.listdir(tmp_path)
    with open(tmp_path / run_dir / "state.json") as f:
        assert json.load(f)["pool"]["active"] == [0, 1, 2, 3]


def test_autoscaled_train_resumes_from_the_shrunk_safe_point(port_params,
                                                              tmp_path):
    _, params = port_params
    ck = str(tmp_path / "ck")
    flags = FLAGS + PORT_WIDTHS + ["--device", "cpu", "--ckpt-dir", ck,
                                   "--ckpt-every", "8"]
    full = run(flags, params=params)
    tail = run(["--device", "cpu"], resume=ck, resume_step=15)
    assert tail["start_step"] == 16 and tail["resumed_from"] == 15
    assert tail["losses"] == full["losses"][16:]
    assert _resizes(tail["resizes"]) == [("grow", 18, 2, 4, [2, 3])]
    assert tail["autoscale_decisions"] == [
        d for d in full["autoscale_decisions"] if d["step"] > 15]
    assert tail["pool_log"] == ["grant:2", "grant:3"]
    assert tail["stages_history"] == full["stages_history"][16:]
    for k in full["params"]["stages"]:
        assert torch.equal(tail["params"]["stages"][k],
                           full["params"]["stages"][k]), k


SERVE_REF = """
import copy, json
import jax
import numpy as np
from repro.cluster.autoscaler import Autoscaler, AutoscalerConfig
from repro.configs import DistConfig, get_config, reduced_config
from repro.dynamics.config import DynamicsConfig
from repro.pipeline.pipeline import PipelineShapes
from repro.serve import ElasticServer
from repro.serve.requests import Request

cfg = reduced_config(get_config("smollm-360m"), **SMALL)
dcfg = DistConfig(num_stages=4, slot_slack=2, remat="none",
                  param_dtype="float32")
shapes = PipelineShapes(num_micro=2, mb_global=2, seq=8, cache_len=24)
exec(TRACE)

def serve(autoscale):
    scaler = Autoscaler(AutoscalerConfig(
        min_stages=2, max_stages=4, patience=2, cooldown=3, queue_high=2,
        occupancy_low=0.6)) if autoscale else None
    srv = ElasticServer(cfg, dcfg, DynamicsConfig(), shapes, scaler=scaler,
                        min_stages=2, seed=0)
    rep = srv.serve(copy.deepcopy(trace), autoscale=autoscale)
    params = srv.state.params
    srv.close()
    return rep, params

el, _ = serve(True)
fx, params = serve(False)        # the 4-stage params both runs start from
flat = {}

def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        flat[prefix] = np.asarray(jax.device_get(tree))

put("params", params)
np.savez(NPZ, **flat)
print("REPORT " + json.dumps({
    "tokens": {c["rid"]: c["tokens"] for c in el["completions"]},
    "fixed": {c["rid"]: c["tokens"] for c in fx["completions"]},
    "resizes": [[r["kind"], r["step"], r["from_stages"], r["to_stages"],
                 r["workers"]] for r in el["resizes"]],
    "decisions": el["autoscale_decisions"], "pool_log": el["pool_log"],
    "stages": el["stages_history"]}))
"""
TRACE = """
rng = np.random.RandomState(0)
prompt = lambda n: rng.randint(0, 256, n).astype(np.int32)
trace = [Request(rid=i, arrival=0, prompt=prompt(8), gen=2 + i % 3,
                 kind="early_exit") for i in range(6)]
trace += [Request(rid=6 + i, arrival=0, prompt=prompt(6), gen=16)
          for i in range(2)]
trace += [Request(rid=8 + i, arrival=30, prompt=prompt(8), gen=3)
          for i in range(6)]
"""
SMALL = dict(num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=256)


def _serve_port(params, autoscale):
    from repro_torch.cluster.autoscaler import Autoscaler, AutoscalerConfig
    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.pipeline.pipeline import PipelineShapes
    from repro_torch.serve import ElasticServer
    from repro_torch.serve.requests import Request
    env = {"np": np, "Request": Request}
    exec(TRACE, env)
    scaler = Autoscaler(AutoscalerConfig(
        min_stages=2, max_stages=4, patience=2, cooldown=3, queue_high=2,
        occupancy_low=0.6)) if autoscale else None
    srv = ElasticServer(reduced_config(get_config("smollm-360m"), **SMALL),
                        DistConfig(num_stages=4, slot_slack=2, remat="none",
                                   param_dtype="float32"),
                        DynamicsConfig(),
                        PipelineShapes(num_micro=2, mb_global=2, seq=8,
                                       cache_len=24),
                        scaler=scaler, min_stages=2, seed=0, device="cpu",
                        params=params)
    rep = srv.serve(copy.deepcopy(env["trace"]), autoscale=autoscale)
    return srv, rep


def _logical(decisions):
    """Decisions with the wall-clock latency in their reason masked (it is
    printed, not decided on: the latency SLO is off)."""
    return [{**d, "reason": re.sub(r"latency=\d+ms", "latency=*",
                                   d["reason"])} for d in decisions]


def test_autoscaled_serve_matches_reference(tmp_path):
    npz = os.path.join(str(tmp_path), "params.npz")
    code = (f"NPZ = {npz!r}\nSMALL = {SMALL!r}\nTRACE = {TRACE!r}\n"
            + SERVE_REF)
    out = run_in_subprocess(code, devices=4)
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
    srv, rep = _serve_port(params, True)
    _, fixed = _serve_port(params, False)
    tokens = {str(c["rid"]): c["tokens"] for c in rep["completions"]}
    assert tokens == want["tokens"] == want["fixed"]
    assert {str(c["rid"]): c["tokens"]
            for c in fixed["completions"]} == tokens
    assert [[r["kind"], r["step"], r["from_stages"], r["to_stages"],
             r["workers"]] for r in rep["resizes"]] == want["resizes"]
    kinds = [r[0] for r in want["resizes"]]
    assert "shrink" in kinds and "grow" in kinds, kinds
    assert _logical(rep["autoscale_decisions"]) == _logical(
        want["decisions"])
    assert rep["pool_log"] == want["pool_log"]
    assert rep["stages_history"] == want["stages"]
    # the live cache round-trips a shrink to 2 and back bit-exactly
    lps0 = list(srv.state.lps)
    before = {k: v.clone() for k, v in srv.state.cache.items()}
    s2 = srv.engine.resize(srv.state, 2)
    s4 = srv.engine.resize(s2, len(lps0), lps0)
    for k, v in before.items():
        assert torch.equal(s4.cache[k], v), k
    srv.close()
