"""A whole run of the harness on the CPU at a tiny size (the harness's
look for a card skipped): the result line's keys, the reference against
the program's CPU path, the control and the planted faults coming out
as not correct, and no JAX or JAX package loaded."""
import json
import subprocess
import sys

import pytest
import torch

from pb_paths import BENCH, DATA, REPO, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_tiny_run_is_correct_and_has_the_contracts_keys():
    out = run_tiny(seed=2**31 + 11)
    assert list(out) == KEYS
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_tokens_per_s", "train_mfu",
                                   "train_step_ms_p90", "setup_s"}
    assert out["attempted"] >= 2 and out["failed"] == 0
    for k, v in out["checks"].items():
        assert set(v) == {"value", "limit"}


def test_traced_tiny_run():
    out = run_tiny(seed=5, trace=True)
    assert out["correct"]
    # the CPU has no device activity to read: every reader finds nothing
    assert out["metrics"] == {}


@pytest.fixture
def forced_migration(monkeypatch):
    """The controller moves a layer at its first decision ([2, 2] ->
    [3, 1], in set-up); with ``scramble`` its migration hands two
    layers' AdamW ``m`` back swapped."""
    from repro_torch.core.controller import DynMoController
    decide0, apply0 = DynMoController.decide, DynMoController.apply

    def decide(ctrl, profile, iteration):
        new_lps, ev = decide0(ctrl, profile, iteration)
        return ([3, 1] if list(ctrl.lps) == [2, 2] else new_lps), ev

    def use(scramble=False):
        monkeypatch.setattr(DynMoController, "decide", decide)
        if not scramble:
            return

        def apply(ctrl, new_lps, params, opt_state, dyn, cache=None):
            out = apply0(ctrl, new_lps, params, opt_state, dyn, cache)
            m = out[1]["m"]["stages"]["wi"]
            with torch.no_grad():
                m[0, [0, 1]] = m[0, [1, 0]].clone()
            return out
        monkeypatch.setattr(DynMoController, "apply", apply)
    return use


def test_a_migration_carries_the_state_over(forced_migration, capsys):
    forced_migration()
    out = run_tiny(seed=17)
    assert "migration [2, 2] -> [3, 1]: 0 entries" in capsys.readouterr().err
    assert out["correct"], out["checks"]
    assert out["checks"]["migration_bits_wrong"]["value"] == 0


@pytest.fixture
def broken_step(monkeypatch, forced_migration):
    """Swap the program's step, or its migration, for a faulty one,
    under the harness."""
    from repro_torch.launch.engine import ElasticEngine
    real = ElasticEngine.step

    def use(kind):
        if kind == "scrambled_migration":
            return forced_migration(scramble=True)
        def step(engine, state, batch, lr):
            if kind == "half_batch":
                mask = batch["label_mask"].copy()
                flat = mask.reshape(-1, mask.shape[-1])
                flat[flat.shape[0] // 2:] = 0
                batch = {**batch, "label_mask": mask}
                return real(engine, state, batch, lr)
            saved = {k: v.clone() for k, v in _leaves(state.params)}
            out = real(engine, state, batch, lr)
            with torch.no_grad():
                for k, v in _leaves(state.params):
                    v.copy_(saved[k])
            return out
        monkeypatch.setattr(ElasticEngine, "step", step)
    return use


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("kind", ["unchanged_state", "half_batch",
                                  "scrambled_migration"])
def test_a_broken_step_is_not_correct(broken_step, kind):
    broken_step(kind)
    out = run_tiny(seed=13)
    assert not out["correct"]
    over = [k for k, v in out["checks"].items() if v["value"] > v["limit"]]
    assert over


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_and_fault_fail_the_limits(seed):
    import controls
    r = controls.readings(REPO, "tiny.prune", seed, "cpu",
                          manifest_path=DATA / "manifest.json",
                          data_dir=DATA)
    for variant in ("tf32", "half"):
        assert not r[variant]["correct"], (variant, r)
        assert any(v > lim for k, (v, lim) in r[variant].items()
                   if k != "correct"), (variant, r)


def test_no_jax_and_no_jax_package_loaded():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(BENCH / 'tests')!r})\n"
        "import torch; torch.set_num_threads(1)\n"
        "from pb_paths import run_tiny\n"
        "out = run_tiny(seed=3)\n"
        "import run\n"
        "print(json.dumps([run.loaded_forbidden(), out['correct']]))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(REPO))
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [[], True]


def test_refuses_without_a_card(monkeypatch):
    import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "smollm360m.train.prune", "--seed", "1",
                     "--seconds", "1"]) == 2
