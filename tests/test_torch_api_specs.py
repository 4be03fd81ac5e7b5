"""The port's RunSpec front door (``repro_torch.api``) against the
reference's (``repro.api``), with no device work.

* Every golden ``tests/golden/runspec_default_v{1..5}.json``, every
  scenario JSON, ``test_api.py``'s populated spec and hypothesis-drawn
  override combinations give the same ``to_dict()`` through both
  ``RunSpec.from_dict`` (exactly: a spec is data).
* Invalid specs raise ``SpecError`` with the same text in both packages.
* ``build_spec`` and ``--dump-config`` agree, train and serve, for argv
  both accept (the reference's ``--dump-config`` runs its own CLI
  ``main``); the port's own earlier flags and a bare bool flag resolve
  to what the reference spells out.
* ``train_spec`` / ``serve_spec`` map kwargs as the reference's do.
* The port's ``MetricsRegistry``, driven by ``tests/test_obs.py``'s
  script, equals ``tests/golden/metrics_snapshot.json`` and the
  reference's Prometheus text.
* ``scripts/torch_check_configs.py`` passes and
  ``scripts/torch_gen_scenarios.py`` writes the reference's bytes.
"""
import argparse
import contextlib
import glob
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                   # pragma: no cover
    from _hypothesis_fallback import given, settings, strategies as st

from repro.api import cli as R_cli  # noqa: E402
from repro.api import scenarios as R_sc  # noqa: E402
from repro.api import specs as R  # noqa: E402
from repro_torch.api import cli as T_cli  # noqa: E402
from repro_torch.api import scenarios as T_sc  # noqa: E402
from repro_torch.api import specs as T  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
SCENARIO_FILES = sorted(glob.glob(os.path.join(REPO, "configs", "scenarios",
                                               "*.json")))


def _both(d):
    """(reference, port) ``to_dict`` of ``RunSpec.from_dict(d)``."""
    return (R.RunSpec.from_dict(json.loads(json.dumps(d))).to_dict(),
            T.RunSpec.from_dict(json.loads(json.dumps(d))).to_dict())


@pytest.mark.parametrize("version", [1, 2, 3, 4, 5])
def test_golden_specs_match_reference(version):
    with open(os.path.join(GOLDEN, f"runspec_default_v{version}.json")) as f:
        d = json.load(f)
    assert d["schema_version"] == version
    ref, port = _both(d)
    assert port == ref
    assert T.RunSpec.from_dict(d) == T.RunSpec()
    assert port["schema_version"] == T.SCHEMA_VERSION == R.SCHEMA_VERSION


def test_default_spec_is_the_golden_byte_for_byte():
    with open(os.path.join(GOLDEN, "runspec_default_v5.json")) as f:
        assert T.RunSpec().to_json() + "\n" == f.read()


@pytest.mark.parametrize("path", SCENARIO_FILES,
                         ids=[os.path.basename(p) for p in SCENARIO_FILES])
def test_scenario_jsons_match_reference(path):
    name = os.path.splitext(os.path.basename(path))[0]
    ref, port = R.RunSpec.load(path), T.RunSpec.load(path)
    assert port.to_dict() == ref.to_dict()
    assert port == T_sc.scenario(name)
    assert T_sc.scenario(name).to_json() == R_sc.scenario(name).to_json()
    assert T.RunSpec.from_json(port.to_json()) == port


def test_scenario_registry_matches_reference():
    assert T_sc.scenario_names() == R_sc.scenario_names()
    assert len(SCENARIO_FILES) == len(T_sc.SCENARIOS) == 6
    with pytest.raises(KeyError, match="unknown scenario"):
        T_sc.scenario("nope")


def _populated(m):
    """``tests/test_api.py``'s populated spec, built from module ``m``."""
    return m.RunSpec(
        model=m.ModelSpec(arch="mixtral-8x7b", layers=4, d_model=96,
                          num_heads=8, num_kv_heads=4, d_ff=512,
                          vocab_size=1024),
        parallel=m.ParallelSpec(stages=8, num_micro=8, mb_global=2, seq=128,
                                slot_slack=1, remat="full",
                                param_dtype="bfloat16", kernel_impl="pallas"),
        dynamics=m.DynamicsSpec(kind="sparse_attention", sparse_block=16,
                                sparse_nbuckets=4),
        controller=m.ControllerSpec(
            balancer="partition", rebalance_every=3,
            repack=m.RepackSpec(enabled=True, policy="first_fit",
                                mem_cap=1.5, target=2),
            async_decide=True, async_drain=True,
            straggler={2: 1.5, 3: 1.25}, measure_stage_times=True),
        cluster=m.ClusterSpec(job_manager="file", job_manager_dir="/tmp/jm",
                              autoscale=True, autoscale_watermark=True,
                              heartbeat_timeout=5.0, simulate_recover=12),
        serve=m.ServeSpec(requests=32, prompt_len=16, gen=12, min_prompt=4,
                          burst_period=20, burst_len=5, burst_rate=6,
                          lull_rate=0, early_exit_frac=0.5, defrag_every=4,
                          min_stages=2, queue_high=3, occupancy_low=0.5,
                          patience=1, cooldown=2, latency_slo_s=0.25,
                          max_ticks=500),
        faults=m.FaultSpec(enabled=True, seed=3, worker_crash={4: 1},
                           rpc_loss=0.1, straggler_spike={6: 2.0}),
        obs=m.ObsSpec(in_step_timing=True, metrics_out="/tmp/m.json"),
        steps=64, seed=7, log_every=4, ckpt_dir="/tmp/ck", ckpt_every=8)


def test_populated_spec_matches_reference():
    ref, port = _populated(R), _populated(T)
    assert port.to_json() == ref.to_json()
    rt = T.RunSpec.from_json(ref.to_json())
    assert rt == port and rt.controller.straggler == {2: 1.5, 3: 1.25}
    assert rt.faults.worker_crash == {4: 1}


_MUTATIONS = [
    ("model.layers", [None, 2, 8, 16]),
    ("model.d_model", [32, 64, 256]),
    ("parallel.stages", [2, 4, 8, 16]),
    ("parallel.kernel_impl", ["reference", "scan", "pallas"]),
    ("parallel.param_dtype", ["float32", "bfloat16"]),
    ("dynamics.kind", ["none", "pruning", "freezing", "sparse_attention",
                       "early_exit", "mod", "moe"]),
    ("dynamics.prune_final_sparsity", [0.5, 0.9, 1.0]),
    ("controller.balancer", ["diffusion", "partition"]),
    ("controller.rebalance_every", [1, 5, 100]),
    ("controller.repack.enabled", [True, False]),
    ("controller.repack.policy", ["adjacent", "first_fit"]),
    ("controller.repack.mem_cap", [0.5, 1.1, 2.0]),
    ("controller.repack.target", [1, 2, 3]),
    ("controller.straggler", [None, "1:1.5", "0:2.0,1:1.25"]),
    ("cluster.job_manager", ["inproc", "file", "http"]),
    ("cluster.heartbeat_timeout", [0.5, 3.0, 10.0]),
    ("cluster.tenant_id", [None, "a"]),
    ("serve.gen", [1, 8, 64]),
    ("serve.kv_page_size", [0, 4, 8]),
    ("serve.min_stages", [1, 2, 4]),
    ("serve.occupancy_low", [0.0, 0.35, 1.0]),
    ("obs.in_step_timing", [False, True]),
    ("steps", [1, 50, 1000]),
    ("seed", [0, 1, 123]),
    ("ckpt_every", [0, 4]),
]


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_drawn_specs_match_reference(seed):
    """Random dotted-override combinations: both packages accept or both
    refuse (with the same message); accepted ones serialize the same."""
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 9))
    idx = rng.choice(len(_MUTATIONS), size=n, replace=False)
    overrides = {}
    for i in idx:
        path, values = _MUTATIONS[int(i)]
        overrides[path] = values[int(rng.randint(len(values)))]
    got = {}
    for name, m in (("ref", R), ("port", T)):
        try:
            got[name] = m.RunSpec().override(overrides).to_dict()
        except m.SpecError as e:
            got[name] = ("SpecError", str(e))
    assert got["port"] == got["ref"], overrides
    if not isinstance(got["port"], tuple):
        assert _both(got["port"])[1] == got["port"]


INVALID = [
    ("from_dict", {"controller": {"repack": {"polcy": "x"}}}),
    ("from_dict", {"paralel": {}}),
    ("from_dict", {"schema_version": 6}),
    ("from_dict", {"schema_version": "5"}),
    ("from_dict", {"model": {"layers": 0}}),
    ("from_dict", {"parallel": {"kernel_impl": "cuda"}}),
    ("from_dict", {"parallel": {"stages": 2},
                   "controller": {"repack": {"enabled": True,
                                             "target": 2}}}),
    ("from_dict", {"parallel": {"stages": 2}, "serve": {"min_stages": 3}}),
    ("from_dict", {"cluster": {"simulate_recover": 5}}),
    ("from_dict", {"parallel": {"stages": 2},
                   "controller": {"straggler": {"5": 1.5}}}),
    ("from_dict", {"controller": {"straggler": {"x": 1.5}}}),
    ("from_dict", {"serve": {"kv_page_size": 7}}),
    ("from_dict", {"serve": {"prefix_cache": True}}),
    ("from_dict", {"ckpt_every": 4}),
    ("from_dict", {"cluster": {"tenant_id": "t"}}),
    ("from_dict", {"cluster": {"manager_url": "http://x"}}),
    ("from_dict", {"faults": {"enabled": True, "kill_at": 3}}),
    ("from_dict", {"faults": {"enabled": True, "rpc_loss": 0.5}}),
    ("from_dict", {"obs": {"metrics_port": 70000}}),
    ("from_dict", {"dynamics": {"expert_watermark": 0.5}}),
    ("from_dict", []),
    ("from_json", "{not json"),
    ("override", {"parallel.stage": 4}),
    ("override", {"parallel.stages": "four"}),
    ("override", {"cluster.autoscale": "maybe"}),
    ("override", {"controller.straggler": "1-1.5"}),
    ("override", {"serve.temperature": "-0.5"}),
]


@pytest.mark.parametrize("how,arg", INVALID,
                         ids=[f"{h}-{i}" for i, (h, _) in enumerate(INVALID)])
def test_invalid_specs_raise_the_same_spec_error(how, arg):
    msgs = []
    for m in (R, T):
        with pytest.raises(m.SpecError) as e:
            if how == "override":
                m.RunSpec().override(arg)
            elif how == "from_json":
                m.RunSpec.from_json(arg)
            else:
                m.RunSpec.from_dict(arg)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


TRAIN_ARGV = [
    [],
    ["--layers", "4", "--stages", "2", "--steps", "15", "--straggler",
     "1:2.0", "--dynamism", "pruning", "--kernel-impl", "pallas"],
    ["--config", "configs/scenarios/early_exit.json", "--set", "steps=3"],
    ["--config", "configs/scenarios/pruning.json", "--stages", "2",
     "--set", "controller.repack.policy=first_fit"],
    ["--set", "model.layers=null", "--stages", "4", "--repack",
     "--grow-back", "5", "--ckpt-dir", "ck", "--ckpt-every", "8"],
    ["--autoscale", "--simulate-recover", "18", "--job-manager", "file",
     "--async-controller", "--async-drain", "--tenant-id", "t",
     "--priority", "3"],
    ["--dynamics.expert_relayout", "true", "--model.num_heads", "8",
     "--obs.in_step_timing", "true", "--cluster.rpc_timeout_s", "10"],
]
SERVE_ARGV = [
    ["--elastic"],
    ["--elastic", "--set", "model.layers=null", "--stages", "1", "--micro",
     "2", "--mb-global", "4", "--prompt-len", "1024", "--gen", "32",
     "--requests", "12", "--kv-page-size", "16", "--prefix-cache",
     "--dynamism", "sparse_attention", "--kernel-impl", "pallas"],
    ["--elastic", "--autoscale", "--min-stages", "2", "--queue-high", "2",
     "--temperature", "0.7", "--early-exit-frac", "0.5"],
    ["--config", "configs/scenarios/freezing.json", "--set",
     "serve.requests=4"],
]
# the port's own earlier flags: the reference's spelling of the same spec
PORT_SPELLING = [
    (["--num-heads", "8", "--num-kv-heads", "4", "--d-ff", "256",
      "--vocab-size", "256", "--slot-slack", "8", "--remat", "block",
      "--param-dtype", "bfloat16", "--in-step-timing", "--rpc-timeout-s",
      "10", "--dynamics.expert_relayout"],
     ["--model.num_heads", "8", "--model.num_kv_heads", "4",
      "--model.d_ff", "256", "--model.vocab_size", "256",
      "--parallel.slot_slack", "8", "--parallel.remat", "block",
      "--parallel.param_dtype", "bfloat16", "--obs.in_step_timing", "true",
      "--cluster.rpc_timeout_s", "10", "--dynamics.expert_relayout",
      "true"]),
]


def _spec(cli, aliases, defaults, argv):
    ap = argparse.ArgumentParser()
    cli.add_config_args(ap)
    cli.add_alias_flags(ap, aliases)
    cli.add_spec_flags(ap)
    return cli.build_spec(ap.parse_args(argv), aliases,
                          cli_defaults=defaults)


def _dump(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv + ["--dump-config"])
    return out.getvalue()


@pytest.mark.parametrize("argv", TRAIN_ARGV,
                         ids=[str(i) for i in range(len(TRAIN_ARGV))])
def test_train_cli_resolves_the_reference_spec(argv, monkeypatch):
    monkeypatch.chdir(REPO)
    from repro.launch.train import main as ref_main
    from repro_torch.launch.train import main as port_main
    ref = _spec(R_cli, R_cli.TRAIN_ALIASES, R_cli.TRAIN_CLI_DEFAULTS, argv)
    port = _spec(T_cli, T_cli.TRAIN_ALIASES, T_cli.TRAIN_CLI_DEFAULTS, argv)
    assert port.to_dict() == ref.to_dict()
    assert _dump(port_main, argv) == _dump(ref_main, argv) \
        == port.to_json() + "\n"


@pytest.mark.parametrize("argv", SERVE_ARGV,
                         ids=[str(i) for i in range(len(SERVE_ARGV))])
def test_serve_cli_resolves_the_reference_spec(argv, monkeypatch):
    monkeypatch.chdir(REPO)
    from repro.launch.serve import main as ref_main
    from repro_torch.launch.serve import main as port_main
    # --elastic is a plain flag of the two mains, not a spec alias
    spec_argv = [a for a in argv if a != "--elastic"]
    ref = _spec(R_cli, R_cli.SERVE_ALIASES, R_cli.SERVE_CLI_DEFAULTS,
                spec_argv)
    port = _spec(T_cli, T_cli.SERVE_ALIASES, T_cli.SERVE_CLI_DEFAULTS,
                 spec_argv)
    assert port.to_dict() == ref.to_dict()
    assert _dump(port_main, argv) == _dump(ref_main, argv) \
        == port.to_json() + "\n"


@pytest.mark.parametrize("port_argv,ref_argv", PORT_SPELLING)
def test_port_flags_resolve_to_the_reference_spelling(port_argv, ref_argv):
    for aliases, defaults in (
            ("TRAIN_ALIASES", "TRAIN_CLI_DEFAULTS"),
            ("SERVE_ALIASES", "SERVE_CLI_DEFAULTS")):
        port = _spec(T_cli, getattr(T_cli, aliases),
                     getattr(T_cli, defaults), port_argv)
        ref = _spec(R_cli, getattr(R_cli, aliases),
                    getattr(R_cli, defaults), ref_argv)
        assert port.to_dict() == ref.to_dict()
    # the reference's tables are a prefix of the port's: same paths
    for name in ("TRAIN_ALIASES", "SERVE_ALIASES"):
        ref_t, port_t = getattr(R_cli, name), getattr(T_cli, name)
        assert [(a.opt, a.path) for a in port_t[:len(ref_t)]] == [
            (a.opt, a.path) for a in ref_t]
        assert port_t[len(ref_t):] == T_cli.PORT_ALIASES
    assert T_cli.TRAIN_CLI_DEFAULTS == R_cli.TRAIN_CLI_DEFAULTS
    assert T_cli.SERVE_CLI_DEFAULTS == R_cli.SERVE_CLI_DEFAULTS


def test_train_spec_kwarg_mapping_matches_reference():
    from repro.launch.train import train_spec as ref
    from repro_torch.launch.train import train_spec as port
    kw = dict(steps=30, stages=4, layers=8, d_model=128, seq=32,
              num_micro=4, mb_global=2, dynamism="pruning",
              kernel_impl="pallas", dyn_overrides=dict(sparse_block=16),
              repack=True, repack_policy="first_fit", repack_mem_cap=1.5,
              repack_target=2, async_controller=True, autoscale=True,
              simulate_recover=18, job_manager="file", straggler={2: 1.5},
              measure_stage_times=True, grow_back=6)
    spec = port("smollm-360m", **kw)
    assert spec.to_dict() == ref("smollm-360m", **kw).to_dict()
    assert spec.controller.repack == T.RepackSpec(
        enabled=True, policy="first_fit", mem_cap=1.5, target=2)
    assert spec.cluster.grow_back == 6
    assert port("smollm-360m").to_dict() == ref("smollm-360m").to_dict()


def test_serve_spec_kwarg_mapping_matches_reference():
    from repro.launch.serve import serve_spec as ref
    from repro_torch.launch.serve import serve_spec as port
    kw = dict(stages=4, micro=2, mb_global=2, prompt_len=8, gen=10,
              layers=8, d_model=64, requests=30, burst_period=25,
              burst_len=3, burst_rate=6, lull_rate=0, early_exit_frac=0.5,
              autoscale=True, min_stages=2, queue_high=2, occupancy_low=0.6,
              patience=2, cooldown=3, defrag_every=4, job_manager="file",
              kernel_impl="reference", measure_stage_times=True,
              kv_page_size=6, prefix_cache=True, temperature=0.5)
    spec = port("smollm-360m", **kw)
    assert spec.to_dict() == ref("smollm-360m", **kw).to_dict()
    assert spec.serve.min_stages == 2 and spec.parallel.num_micro == 2
    assert port("smollm-360m").to_dict() == ref("smollm-360m").to_dict()


def test_metrics_registry_matches_golden_and_reference():
    """``tests/test_obs.py``'s scripted registry, in both packages."""
    from repro.obs import metrics as R_metrics
    from repro.obs.metrics import MetricsRegistry as RReg
    from repro_torch.obs.metrics import (DEFAULT_BUCKETS, SNAPSHOT_SCHEMA,
                                         MetricsRegistry)

    def script(reg):
        reg.inc("dynmo_train_steps_total", 3, help="train steps",
                mode="train")
        reg.inc("dynmo_resizes_total", kind="shrink", policy="preempt")
        reg.set("dynmo_stages", 4, help="live stage count")
        reg.set("dynmo_stage_time_seconds", 0.25, stage="0",
                source="in_step")
        for v in (0.004, 0.04, 0.4, 4.0):
            reg.observe("dynmo_step_seconds", v, help="steady step seconds")
        return reg

    port, ref = script(MetricsRegistry()), script(RReg())
    with open(os.path.join(GOLDEN, "metrics_snapshot.json")) as f:
        assert port.snapshot() == json.load(f)
    assert port.to_prometheus() == ref.to_prometheus()
    assert SNAPSHOT_SCHEMA == R_metrics.SNAPSHOT_SCHEMA
    assert DEFAULT_BUCKETS == R_metrics.DEFAULT_BUCKETS


def test_config_scripts(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_check_configs.py")],
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("ok   ") == len(SCENARIO_FILES)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_gen_scenarios.py"), "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=120,
        env=env)
    assert out.returncode == 0, out.stderr
    for path in SCENARIO_FILES:
        name = os.path.basename(path)
        got = (tmp_path / name).read_text()
        # the reference's generator writes SCENARIOS[name].save(path)
        assert got == R_sc.SCENARIOS[name[:-5]].to_json() + "\n"
        # the checked-in file (schema v3) upgrades to the same spec
        assert T.RunSpec.from_json(got) == T.RunSpec.load(path)
