"""The port's ``Session``-driven examples and its two CLIs' front door, on
the CPU.

* ``examples/torch_{quickstart,train_dynamic_pruning,serve_elastic,
  autoscale_cluster,elastic_restart,serve_early_exit}.py`` each run with
  ``--device cpu`` at a small setting (each well under 30 s here) and show
  what they claim: the pruning run repacks 4 -> 2 stage buffers and writes
  safe points, the elastic serve resizes and streams the fixed run's
  tokens, the cluster demo shrinks and grows back across a file job
  manager, the elastic restart shrinks 4 -> 2 and grows back live and
  restores a safe point bit for bit onto 2 stages (both modes train the
  same losses), the early-exit serve exits tokens and rebalances between
  decode rounds without changing a token.
* ``python -m repro_torch.launch.train --config
  configs/scenarios/early_exit.json --set steps=3 --device cpu`` runs as a
  process and writes its event stream (``--events-out``).
* The serve CLI without ``--elastic`` runs the one-shot generator, and
  ``--dump-config`` prints the spec and runs nothing.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_quickstart(out):
    assert len(out["losses"]) == 6 and out["final_stages"] == 4


def _check_pruning(out):
    assert [(r["kind"], r["from_stages"], r["to_stages"])
            for r in out["resizes"]] == [("shrink", 4, 2)]
    assert len(out["safepoints"]) == 2


def _check_serve(out):
    el, fx = out
    kinds = [r["kind"] for r in el["resizes"]]
    assert "shrink" in kinds and "grow" in kinds, kinds
    assert [c["tokens"] for c in el["completions"]] == [
        c["tokens"] for c in fx["completions"]]


def _check_autoscale(out):
    assert out["pool_log"] == ["release:2", "release:3", "grant:2",
                               "grant:3"]
    assert out["rpc"] is not None


def _check_restart_live(out):
    assert [r[:3] for r in out["resizes"]] == [("shrink", 4, 2),
                                               ("grow", 2, 4)]
    assert out["pool_log"] == ["release:2", "release:3", "grant:2",
                               "grant:3"]
    assert out["final_stages"] == 4
    l1, l2, l3 = out["losses"]
    assert len(l1) == len(l2) == len(l3) == 6 and l3[-1] < l1[0]


def _check_restart(out, live):
    assert out["restored"] == out["saved"]
    assert out["lps"] == [[2, 2, 2, 2], [4, 4], [2, 2, 2, 2]]
    assert out["granted"] == [4, 5]          # fresh machines: 2, 3 died
    assert out["pool_log"] == ["fail:2", "fail:3", "grant:4", "grant:5"]
    # the restore-and-continue path trains what the live path trains
    assert out["losses"] == live["losses"]


def _check_early_exit(out):
    assert 0.0 < out["exited_frac"] < 1.0
    assert len(out["rebalances"]) == 1 and out["lps"] != [2, 2, 2, 2]
    assert (out["tokens"] == out["plain_tokens"]).all()
    assert out["tokens"].shape == (2, 4, 12)


EXAMPLES = [
    ("torch_quickstart", ["--steps", "6"], _check_quickstart),
    ("torch_train_dynamic_pruning", ["--steps", "12", "--seq", "32"],
     _check_pruning),
    ("torch_serve_elastic", [], _check_serve),
    ("torch_autoscale_cluster", [], _check_autoscale),
    ("torch_elastic_restart", ["--mode", "live"], _check_restart_live),
    ("torch_elastic_restart", ["--mode", "restart"], _check_restart),
    ("torch_serve_early_exit", [], _check_early_exit),
]


@pytest.mark.parametrize("name,argv,check", EXAMPLES,
                         ids=[e[0] + ("_" + e[1][1] if e[1][:1] == ["--mode"]
                                      else "") for e in EXAMPLES])
def test_example_runs_on_the_cpu(name, argv, check, tmp_path, monkeypatch,
                                request):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    if name == "torch_elastic_restart":
        # both modes are held to one live run, made once for the module
        live = request.getfixturevalue("restart_live")
        if argv == ["--mode", "live"]:
            return check(live)
        return check(_example(name).main(argv + ["--device", "cpu"]), live)
    extra = (["--ckpt-dir", str(tmp_path / "ck")]
             if name == "torch_train_dynamic_pruning" else [])
    check(_example(name).main(argv + extra + ["--device", "cpu"]))


@pytest.fixture(scope="module")
def restart_live():
    """``torch_elastic_restart --mode live``'s output, for both modes'
    cases."""
    return _example("torch_elastic_restart").main(
        ["--mode", "live", "--device", "cpu"])


def test_examples_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _example("torch_quickstart").main(["--steps", "1"])


def test_train_cli_runs_a_scenario_config(tmp_path):
    events = str(tmp_path / "events.json")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--config",
         "configs/scenarios/early_exit.json", "--set", "steps=3",
         "--device", "cpu", "--events-out", events],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "done: loss" in out.stdout
    with open(events) as f:
        kinds = [e["kind"] for e in json.load(f)]
    assert kinds == ["log", "train_summary"]


def test_serve_cli_one_shot_path_and_dump_config(capsys):
    from repro_torch.api import RunSpec
    from repro_torch.launch.serve import main, run
    argv = ["--layers", "2", "--d-model", "64", "--stages", "2",
            "--prompt-len", "8", "--gen", "4", "--device", "cpu"]
    rep = run(argv + ["--rebalance-every", "2"])
    assert rep["tokens"].shape == (2, 4, 4)
    assert rep["final_lps"] == [1, 1]
    main(argv + ["--dump-config"])
    spec = RunSpec.from_json(capsys.readouterr().out)
    assert spec.model.layers == 2 and spec.parallel.num_micro == 2
    assert run(["--dump-config"]) is None
    assert RunSpec.from_json(capsys.readouterr().out).model.layers == 8
