"""Rules the PyTorch port keeps.

* ``repro_torch`` and ``chip_smoke.py`` import neither jax nor the JAX
  package, nor ``msgpack`` or ``ml_dtypes`` (the card's machine has
  neither) — checked in the source and in ``sys.modules`` after a CPU
  serve and a CPU train, of smollm and of the MoE slice (reduced Mixtral
  through the grouped-matmul kernels, the expert layout and the Mixtral
  config), after a checkpointed train, its ``--resume`` and a run
  with ``--async-controller``, after an autoscaled chaos train (traced,
  RPC duplicates on the file manager) and a sampling, autoscaled serve
  behind file and HTTP job managers; importing the stdlib observability
  modules and the RPC transports loads no torch either.
* ``chip_smoke.py``'s MoE phases require K4 and K5 launches, its serve
  phase every K6 launch split; its K6 bound counts the live pages; its
  fault phase refuses a serve without an evict, a train without the
  crashed worker's ``fail`` and a metrics scrape that disagrees with the
  report.
* Entry points run on CUDA and raise without a card unless the caller asks
  for the CPU; features not ported yet raise ``NotImplementedError`` (the
  one-shot serve refuses ``--chaos`` with a ``ValueError``), and
  every ROADMAP item such a message (or any other text of the port) names
  is a current item of ``ROADMAP.md``'s Queue 1.
* ``chip_smoke.py`` fails, and prints no result, without a card or outside
  the repository.
* ``convert`` round-trips a reference param tree bit-exactly.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
SERVE_ARGS = ["--elastic", "--stages", "2", "--layers", "4", "--d-model",
              "64", "--d-ff", "256", "--vocab-size", "256", "--prompt-len",
              "8", "--gen", "8", "--requests", "6", "--kv-page-size", "4",
              "--prefix-cache", "--kernel-impl", "pallas"]

TRAIN_ARGS = ["--stages", "2", "--layers", "4", "--d-model", "64", "--d-ff",
              "256", "--vocab-size", "256", "--seq", "16", "--num-micro",
              "2", "--mb-global", "2", "--steps", "2", "--dynamism",
              "pruning", "--kernel-impl", "pallas", "--rebalance-every",
              "1", "--straggler", "1:2.0"]

torch.set_num_threads(1)


def _env():
    return {**os.environ, "PYTHONPATH": str(SRC)}


# the modules a run of the port must not have loaded
BAD_CHECK = ("bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'repro', 'msgpack', 'ml_dtypes')]\n")


def test_cpu_serve_imports_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "from repro_torch.launch.serve import run\n"
        f"rep = run({SERVE_ARGS + ['--device', 'cpu']!r})\n"
        "assert len(rep['completions']) == 6, rep['completions']\n"
        f"{BAD_CHECK}"
        "assert not bad, bad\n"
        "print('CLEAN', rep['total_tokens'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN" in out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s)|(import|from)\s+(msgpack|ml_dtypes)\b)", re.M)



API_MODULES = ("repro_torch.api.specs", "repro_torch.api.cli",
               "repro_torch.api.session", "repro_torch.obs.metrics")


def test_cpu_train_imports_no_jax_and_no_reference():
    """The train CLI resolves its RunSpec through the port's own front door
    (``repro_torch.api``), never the reference's."""
    code = (
        "import sys\n"
        "from repro_torch.launch.train import run\n"
        f"rep = run({TRAIN_ARGS + ['--device', 'cpu']!r})\n"
        "assert len(rep['losses']) == 2, rep['losses']\n"
        f"{BAD_CHECK}"
        "assert not bad, bad\n"
        f"missing = [m for m in {API_MODULES!r} if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('CLEAN', rep['controller']['decided'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN 2" in out.stdout


ELASTIC_MODULES = ("repro_torch.checkpoint.elastic",
                   "repro_torch.cluster.rpc", "repro_torch.core.repack")


def test_cpu_elastic_train_imports_no_jax_and_no_reference():
    """A live shrink and grow back (``--repack --grow-back``) loads the
    elastic modules and nothing of jax or the reference."""
    code = (
        "import sys\n"
        "from repro_torch.launch.train import run\n"
        "rep = run(['--layers', '8', '--d-model', '64', '--d-ff', '256',"
        " '--vocab-size', '256', '--stages', '4', '--seq', '16',"
        " '--num-micro', '2', '--mb-global', '2', '--steps', '18',"
        " '--dynamism', 'pruning', '--repack', '--grow-back', '2',"
        " '--rebalance-every', '5', '--device', 'cpu'])\n"
        "assert [r['kind'] for r in rep['resizes']] == ['shrink', 'grow']\n"
        f"{BAD_CHECK}"
        "assert not bad, bad\n"
        f"missing = [m for m in {ELASTIC_MODULES!r} if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('CLEAN', rep['pool_log'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN" in out.stdout


CKPT_MODULES = ("repro_torch.checkpoint.checkpoint",
                "repro_torch.checkpoint.safepoint", "repro_torch.obs.timing")


def test_cpu_checkpointed_async_train_imports_no_jax_and_no_reference(
        tmp_path):
    """A train with ``--ckpt-every`` and ``--async-controller`` and its
    ``--resume`` load the checkpoint, safe-point and timing modules and
    nothing of jax, the reference, msgpack or ml_dtypes."""
    ck = str(tmp_path / "ck")
    code = (
        "import sys\n"
        "from repro_torch.launch.train import run\n"
        f"a = run({TRAIN_ARGS + ['--device', 'cpu', '--steps', '4']!r} + "
        f"['--ckpt-dir', {ck!r}, '--ckpt-every', '2', '--async-controller',"
        " '--async-drain', '--in-step-timing'])\n"
        f"b = run(['--resume', {ck!r}, '--device', 'cpu'], resume_step=1)\n"
        "assert b['losses'] == a['losses'][2:], (a['losses'], b['losses'])\n"
        "assert b['controller']['mode'] == 'async'\n"
        f"{BAD_CHECK}"
        "assert not bad, bad\n"
        f"missing = [m for m in {CKPT_MODULES!r} if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('CLEAN', len(a['safepoints']))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN 2" in out.stdout


CLUSTER_MODULES = ("repro_torch.cluster.autoscaler",
                   "repro_torch.cluster.scheduler",
                   "repro_torch.cluster.http_rpc",
                   "repro_torch.api.session", "repro_torch.obs.events",
                   "repro_torch.pipeline.sampling")


FAULT_MODULES = ("repro_torch.faults", "repro_torch.faults.plan",
                 "repro_torch.faults.injector", "repro_torch.obs.trace")


def test_cpu_cluster_and_sampling_import_no_jax_and_no_reference():
    """``--autoscale --simulate-recover`` chaos training (``--chaos``, RPC
    duplicates, traced) behind a file manager and a sampling
    (``--temperature``), autoscaled serve behind a private HTTP manager run
    in the port and load the cluster, fault, tracer, event and sampling
    modules and nothing of jax or the reference."""
    code = (
        "import sys\n"
        "from repro_torch.launch.serve import run as serve\n"
        "from repro_torch.launch.train import run as train\n"
        f"rep = train({TRAIN_ARGS + ['--device', 'cpu']!r} + ['--steps', "
        "'6', '--autoscale', '--simulate-recover', '4', '--job-manager',"
        " 'file', '--rpc-timeout-s', '20', '--chaos', '--set',"
        " 'faults.rpc_dup=0.3', '--set', 'obs.trace=true'])\n"
        "assert len(rep['losses']) == 6 and rep['rpc'] is not None\n"
        "assert rep['fault_plan']['rpc_dup'] == 0.3\n"
        f"srv = serve({SERVE_ARGS + ['--device', 'cpu']!r} + ["
        "'--temperature', '0.7', '--autoscale', '--job-manager', 'http',"
        " '--rpc-timeout-s', '20'])\n"
        "assert len(srv['completions']) == 6\n"
        "assert srv['spec']['serve']['temperature'] == 0.7\n"
        f"{BAD_CHECK}"
        "assert not bad, bad\n"
        f"missing = [m for m in {CLUSTER_MODULES + FAULT_MODULES!r} if m "
        "not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('CLEAN', srv['rpc']['stats']['calls'] > 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN True" in out.stdout


def test_stdlib_obs_and_rpc_modules_load_no_torch():
    """A job manager imports its transport, the scheduler and the stdlib
    observability modules: no torch (the packages' inits are lazy), so it
    answers within a second of its start."""
    code = ("import sys\n"
            "import repro_torch.obs.trace, repro_torch.obs.events\n"
            "import repro_torch.obs.metrics, repro_torch.cluster.rpc\n"
            "import repro_torch.cluster.http_rpc\n"
            "from repro_torch.obs import Tracer, stamp_record\n"
            "from repro_torch.cluster import FileJobManager\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro')]\n"
            "assert not bad, bad\n"
            "from repro_torch.obs import StageTimer\n"
            "assert 'torch' in sys.modules\n"
            "print('LIGHT')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LIGHT" in out.stdout


def test_forbidden_imports_pattern():
    for line in ("import jax", "from jax import numpy", "import repro",
                 "from repro.core import x", "import msgpack",
                 "from ml_dtypes import bfloat16", "    import msgpack"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch import x",
                 "import msgpackx", "import numpy"):
        assert not _FORBIDDEN.search(line), line


MOE_MODULES = ("repro_torch.kernels.grouped_matmul.ops",
               "repro_torch.kernels.grouped_matmul.backward",
               "repro_torch.core.expert_layout",
               "repro_torch.configs.mixtral_8x7b")
MOE_COMMON = ["--arch", "mixtral-8x7b", "--layers", "4", "--d-model", "64",
              "--d-ff", "128", "--vocab-size", "256", "--stages", "2",
              "--kernel-impl", "pallas", "--device", "cpu"]


def test_cpu_moe_train_and_serve_import_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "from repro_torch.launch.serve import run as serve\n"
        "from repro_torch.launch.train import run as train\n"
        f"rep = train({MOE_COMMON!r} + ['--seq', '16', '--num-micro', '2',"
        " '--mb-global', '2', '--steps', '3', '--dynamism', 'moe',"
        " '--rebalance-every', '1', '--dynamics.expert_relayout',"
        " '--dynamics.expert_watermark', '1.01',"
        " '--dynamics.expert_min_tokens', '1'])\n"
        "assert len(rep['losses']) == 3 and rep['relayouts'], rep\n"
        f"srv = serve(['--elastic', '--prompt-len', '8', '--gen', '4',"
        f" '--requests', '4'] + {MOE_COMMON!r})\n"
        "assert srv['moe_dropped_mean'] is not None\n"
        f"{BAD_CHECK}"
        "assert not bad, bad\n"
        f"missing = [m for m in {MOE_MODULES!r} if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('CLEAN', len(rep['relayouts']))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN" in out.stdout


DIST_MODULES = ("repro_torch.launch.mesh", "repro_torch.launch.dist",
                "repro_torch.launch.sharding", "repro_torch.launch.jm_proxy")
FAMILY_MODULES = ("repro_torch.models.mamba", "repro_torch.models.xlstm",
                  "repro_torch.configs.whisper_large_v3",
                  "repro_torch.configs.zamba2_1p2b",
                  "repro_torch.configs.xlstm_1p3b",
                  "repro_torch.configs.internvl2_26b")
FAMILY_COMMON = ["--layers", "4", "--d-model", "64", "--d-ff", "256",
                 "--vocab-size", "256", "--stages", "2", "--kernel-impl",
                 "pallas", "--device", "cpu"]


def test_cpu_family_train_and_serve_import_no_jax_and_no_reference():
    """A CPU train and serve of whisper (the one-shot serve: scalar
    positions), zamba2 and xLSTM (the elastic server) load the families'
    modules and nothing of jax or the reference."""
    code = (
        "import sys\n"
        "from repro_torch.launch.serve import run as serve\n"
        "from repro_torch.launch.train import run as train\n"
        "for arch in ('whisper-large-v3', 'zamba2-1.2b', 'xlstm-1.3b'):\n"
        f"    rep = train(['--arch', arch] + {FAMILY_COMMON!r} + ['--seq',"
        " '16', '--num-micro', '2', '--mb-global', '2', '--steps', '2'])\n"
        "    assert len(rep['losses']) == 2, rep['losses']\n"
        "    flags = [] if arch.startswith('whisper') else ['--elastic',"
        " '--requests', '4']\n"
        f"    srv = serve(['--arch', arch, '--prompt-len', '8', '--gen',"
        f" '4'] + flags + {FAMILY_COMMON!r})\n"
        f"{BAD_CHECK.replace(chr(10), '')}\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {FAMILY_MODULES!r} if m not in"
        " sys.modules]\n"
        "assert not missing, missing\n"
        "print('CLEAN')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN" in out.stdout


def test_no_jax_or_reference_imports_in_the_port():
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))
    assert {f.name for f in scripts} >= {"torch_check_trace.py",
                                         "torch_chaos_soak.py",
                                         "torch_cluster_smoke.py"}
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"] + scripts
    assert len(files) > 20
    names = {str(f.relative_to(SRC)) for f in files if SRC in f.parents}
    for mod in (MOE_MODULES + ELASTIC_MODULES + CKPT_MODULES
                + CLUSTER_MODULES + FAULT_MODULES + API_MODULES
                + FAMILY_MODULES + DIST_MODULES
                + ("repro_torch.runtime.compression",)):
        if mod == "repro_torch.faults":
            mod = "repro_torch.faults.__init__"
        assert mod.replace(".", "/") + ".py" in names, mod
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}" for f in files
            for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.launch.serve import run
    from repro_torch.pipeline.pipeline import PipelineShapes
    from repro_torch.serve import ElasticServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(get_config("smollm-360m"))
    dcfg = DistConfig(num_stages=1, param_dtype="float32")
    shapes = PipelineShapes(1, 2, 8, cache_len=16)
    for make in (lambda **kw: ElasticEngine(cfg, dcfg, DynamicsConfig(),
                                            shapes, **kw),
                 lambda **kw: ElasticServer(cfg, dcfg, DynamicsConfig(),
                                            shapes, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        with pytest.raises(RuntimeError, match="CUDA"):
            make(device="cuda")
        make(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        run(SERVE_ARGS)
    from repro_torch.launch.engine import make_train_step
    from repro_torch.launch.train import run as train_run
    with pytest.raises(RuntimeError, match="CUDA"):
        train_run(TRAIN_ARGS)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, dcfg, DynamicsConfig(), shapes)
    make_train_step(cfg, dcfg, DynamicsConfig(), shapes, device="cpu")
    assert resolve_device("cpu").type == "cpu"
    from repro_torch.api import RunSpec, Session, scenario
    from repro_torch.launch.serve import run_serving
    for make in (lambda: Session(RunSpec()),
                 lambda: Session(scenario("early_exit"), device="cuda"),
                 lambda: run_serving("smollm-360m", layers=2, d_model=64)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    Session(RunSpec(), device="cpu").close()


@pytest.mark.parametrize("extra", [
    ["--chaos"], ["--chaos", "--job-manager", "file"]])
def test_features_outside_the_slice_raise(extra):
    """``--chaos`` runs through the elastic server (the crash itself is
    held to the reference in ``test_torch_faults.py``); the one-shot
    generator, which the reference lets ignore it, refuses it."""
    from repro_torch.launch.serve import run
    rep = run(SERVE_ARGS + ["--device", "cpu"] + extra)
    assert rep["fault_plan"] is not None and rep["faults"] == []
    assert len(rep["completions"]) == 6
    with pytest.raises(ValueError, match="elastic server"):
        run([a for a in SERVE_ARGS if a != "--elastic"]
            + ["--device", "cpu"] + extra)


@pytest.mark.parametrize("extra,what", [
    (["--chaos"], "chaos"),
    (["--chaos", "--autoscale"], "chaos"),
    (["--arch", "mixtral-8x7b", "--dynamism", "pruning"], "moe"),
])
def test_train_features_outside_the_slice_raise(extra, what):
    """Features once outside the port now run: ``--chaos`` (an empty plan
    without ``faults.*`` fields or ``--faults.auto``) and pruning an MoE
    arch (``[moe-rest]``: the experts' block magnitudes)."""
    from repro_torch.launch.train import run
    rep = run(TRAIN_ARGS + ["--device", "cpu"] + extra)
    assert len(rep["losses"]) == 2
    if what == "chaos":
        assert rep["fault_plan"]["events"] == [] and rep["faults"] == []
    else:
        assert all(np.isfinite(rep["losses"]))
        assert rep["dyn"]["ff_mask"].shape[-1] == 2


def test_per_lane_encoder_decoder_serving_raises_as_the_reference():
    """The elastic server decodes at per-lane positions, which the
    reference refuses for encoder–decoder archs (no per-lane ``dec_pos``
    gather); the port raises the reference's words as a ``ValueError``
    that says the reference lacks it.  The one-shot serve (scalar
    positions) runs."""
    from repro_torch.launch.serve import run
    argv = ["--arch", "whisper-large-v3", "--stages", "2", "--layers", "4",
            "--d-model", "64", "--d-ff", "256", "--vocab-size", "256",
            "--prompt-len", "8", "--gen", "8", "--kernel-impl", "pallas",
            "--device", "cpu"]
    with pytest.raises(ValueError, match="reference lacks per-lane"):
        run(["--elastic", "--requests", "4"] + argv)
    rep = run(argv)
    assert rep["tokens"].shape[-1] == 8


def test_chip_smoke_fails_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(REPO), env=_env())
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path),
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_counts_device_time_once():
    """The busy share sums device-side profiler entries only: a host op
    (an autograd Function, ``aten::mm``) carries its kernels' device time
    too, and adding both counted that time twice."""
    import importlib.util
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ev = [SimpleNamespace(key=k, device_type=d, self_device_time_total=t)
          for k, d, t in (("_PrunedMatmul", DeviceType.CPU, 5000.0),
                          ("pm_kernel<float>", DeviceType.CUDA, 5000.0),
                          ("aten::mm", DeviceType.CPU, 2000.0),
                          ("sgemm", DeviceType.CUDA, 2000.0),
                          ("sgemm", DeviceType.CUDA, 500.0))]
    assert smoke.device_times(ev) == {"pm_kernel<float>": 5.0, "sgemm": 2.5}


def test_chip_smoke_moe_phases_require_k4_and_k5():
    """The MoE train phase holds K4 and K5 to their launches per step (48
    and 24 at 2 layers x 4 microbatches) and the MoE serve phase requires
    K4; the check fails a run in which either launched no time."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    per_step = smoke.MOE_TRAIN_LAUNCHES_PER_STEP
    assert per_step["grouped_matmul"] == 48
    assert per_step["grouped_matmul_dw"] == 24
    assert "grouped_matmul" in smoke.MOE_SERVE_PATH
    steps = 8
    good = {"grouped_matmul": 48 * steps, "grouped_matmul_dw": 24 * steps,
            "block_sparse_attention": 0}
    smoke.check_launches("moe train", good, per_step, steps)
    for name in ("grouped_matmul", "grouped_matmul_dw"):
        with pytest.raises(AssertionError, match=name):
            smoke.check_launches("moe train", {**good, name: 0}, per_step,
                                 steps)


@pytest.mark.parametrize("name", ["block_sparse_attention",
                                  "block_sparse_attention_bwd_dq",
                                  "block_sparse_attention_bwd_dkv",
                                  "pruned_matmul"])
def test_chip_smoke_requires_the_tensor_cores_on_the_smollm_paths(name):
    """Phases 4 and 4c fail unless every launch of K1, K2a, K2b and K3 on
    the smollm paths took the 3xTF32 tensor-core variant."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert name in smoke.FP32_TC_PATH
    launched = {n: 128 for n in smoke.FP32_TC_PATH}
    smoke.check_tensor_core("train", launched, dict(launched),
                            smoke.FP32_TC_PATH)
    with pytest.raises(AssertionError, match=name):
        smoke.check_tensor_core("train", launched, {**launched, name: 127},
                                smoke.FP32_TC_PATH)


def test_chip_smoke_requires_every_serve_k6_launch_split():
    """Phase 4 fails unless K6 launched and every launch of the serve cut
    its pages into splits (the serve's b 4, n_kv 5, J 66 gives 10)."""
    import importlib.util
    from repro_torch.kernels.paged_attention import ops as pa
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.check_k6_split(2272, 2272)
    for launched, split in ((2272, 2271), (0, 0)):
        with pytest.raises(AssertionError, match="K6"):
            smoke.check_k6_split(launched, split)
    assert pa.pa_splits(4, 5, 66, 16) > 1


def _smoke_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _crash_serve_report(**kw):
    rep = {"completions": [{"rid": 0, "tokens": [5, 6, 7]},
                           {"rid": 1, "tokens": [8, 9, 1]}],
           "requeued_total": 2,
           "resizes": [{"kind": "evict", "step": 8, "workers": [2]}],
           "total_tokens": 6, "ticks": 4,
           "tick_tokens": [2, 3, 2, 2]}
    rep.update(kw)
    return rep


def test_chip_smoke_fault_serve_checks_refuse_a_wrong_run():
    """Phase 4r (ii) refuses a crashed serve without an evict or without a
    requeue, a lost request and a flip where the fixed run was decided;
    it accepts a flip at a near-tie and the continuation after it."""
    smoke = _smoke_module()
    fixed = {0: [5, 6, 7], 1: [8, 9, 2]}
    gaps = {0: {0: 1.0, 1: 2.0, 2: 3.0}, 1: {0: 1.0, 1: 1.0, 2: 5e-4}}
    assert smoke.check_crash_serve(_crash_serve_report(), fixed, gaps) \
        == [(1, 2, 5e-4)]
    with pytest.raises(AssertionError, match="no evict"):
        smoke.check_crash_serve(_crash_serve_report(resizes=[]), fixed,
                                gaps)
    with pytest.raises(AssertionError, match="requeued no request"):
        smoke.check_crash_serve(_crash_serve_report(requeued_total=0),
                                fixed, gaps)
    with pytest.raises(AssertionError, match="requests"):
        smoke.check_crash_serve(_crash_serve_report(
            completions=[{"rid": 0, "tokens": [5, 6, 7]}]), fixed, gaps)
    with pytest.raises(AssertionError, match="differs at token 2"):
        smoke.check_crash_serve(_crash_serve_report(), fixed,
                                {**gaps, 1: {2: 0.5}})


def test_chip_smoke_fault_metrics_scrape_must_match_the_report():
    """Phase 4r (ii)'s GET /metrics: the emitted positions are the
    report's tick tokens, the completions' tokens plus the replayed
    ones; phase 4p's page counts the scheduler's events stream."""
    smoke = _smoke_module()
    page = ("# TYPE dynmo_serve_ticks_total counter\n"
            "dynmo_serve_ticks_total 4\n"
            "dynmo_serve_tokens_total 9\n")
    assert smoke.check_serve_scrape(page, _crash_serve_report()) == (9, 3)
    with pytest.raises(AssertionError, match="tokens"):
        smoke.check_serve_scrape(page.replace(" 9", " 6"),
                                 _crash_serve_report())
    with pytest.raises(AssertionError, match="without a requeue"):
        smoke.check_serve_scrape(page, _crash_serve_report(
            requeued_total=0))
    with pytest.raises(AssertionError, match="ticks"):
        smoke.check_serve_scrape(page.replace("total 4", "total 5"),
                                 _crash_serve_report())
    with pytest.raises(AssertionError, match="no serve counters"):
        smoke.check_serve_scrape("", _crash_serve_report())
    events = [{"tenant": "train", "ev": "grant"}] * 2 + [
        {"tenant": "serve", "ev": "steal"}]
    page = ('dynmo_scheduler_events_total{event="grant",tenant="train"} 2\n'
            'dynmo_scheduler_events_total{event="steal",tenant="serve"} 1\n')
    assert smoke.check_scheduler_scrape(page, events) == {
        "train:grant": 2.0, "serve:steal": 1.0}
    with pytest.raises(AssertionError, match="events stream"):
        smoke.check_scheduler_scrape(page, events[:1])


def test_chip_smoke_fault_train_checks_refuse_a_wrong_run():
    """Phase 4r (i) refuses a chaos train whose pool log lacks the crashed
    worker's ``fail``, one without an evict, one past the loss tolerance
    and one whose losses part before its stage history does."""
    smoke = _smoke_module()
    base = {"losses": [3.0, 2.5, 2.0, 1.5, 1.0],
            "stages_history": [4] * 5, "step_times": [1.0] * 5}
    rep = {"losses": [3.0, 2.5, 2.0, 1.5001, 1.0002],
           "stages_history": [4, 4, 4, 3, 3], "step_times": [1.0] * 5,
           "resizes": [{"kind": "evict", "step": 2, "workers": [2],
                        "seconds": 0.01}],
           "pool_log": ["fail:2"],
           "faults": [{"step": 1, "kind": "worker_crash",
                       "detail": {"worker": 2}}]}
    got = smoke.check_crash_train(rep, 2, base)
    assert got["part_step"] == 3 and got["recover_steps"] == 2
    assert got["recover_s"] == pytest.approx(1.01)
    with pytest.raises(AssertionError, match="fail:2"):
        smoke.check_crash_train({**rep, "pool_log": ["release:2"]}, 2,
                                base)
    with pytest.raises(AssertionError, match="no evict"):
        smoke.check_crash_train({**rep, "resizes": []}, 2, base)
    with pytest.raises(AssertionError, match="differs by"):
        smoke.check_crash_train({**rep, "losses": [3.0, 2.5, 2.0, 1.6,
                                                   1.0]}, 2, base)
    with pytest.raises(AssertionError, match="before the stage"):
        smoke.check_crash_train({**rep, "losses": [3.0, 2.5001, 2.0, 1.5,
                                                   1.0]}, 2, base)


@pytest.mark.parametrize("serve_k1", [1, 0])
def test_chip_smoke_ee_serve_reads_its_own_launches(monkeypatch, serve_k1):
    """Phase 4j zeroes every count just before the early-exit serve and
    reads it just after: launches left from the early-exit train run (K1
    and K3 included) neither show in the serve's counts nor hide a kernel
    the serve missed; every K6 launch of the serve must be split."""
    import importlib.util
    import types
    from repro_torch import kernels
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.launch import serve as serve_cli
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    by_name = {k.name: k for k in kernels.KERNELS}
    for k in kernels.KERNELS:          # what the train run left behind
        k.launches = k.launches_tc = 1000

    def fake_serve(argv):
        assert "early_exit" in argv
        for name, n in (("block_sparse_attention", serve_k1),
                        ("pruned_matmul", 6), ("paged_attention", 5)):
            by_name[name].launches += n
            by_name[name].launches_tc += n
        pa.KERNEL.launches_split += 5
        comps = [{"kind": "early_exit" if i < 2 else "none",
                  "tokens": [1, 2]} for i in range(8)]
        return {"completions": comps, "total_tokens": 16, "ticks": 4,
                "tokens_per_s": 1.0}

    fake_torch = types.SimpleNamespace(cuda=types.SimpleNamespace(
        synchronize=lambda: None, empty_cache=lambda: None))
    monkeypatch.setattr(serve_cli, "run", fake_serve)
    try:
        if serve_k1:
            got = smoke.run_ee_serve_phase(fake_torch, kernels)
            assert got["block_sparse_attention"] == 1
            assert got["pruned_matmul"] == 6 and got["paged_attention"] == 5
            assert got["block_sparse_attention_bwd_dq"] == 0
        else:
            with pytest.raises(AssertionError, match="never launched"):
                smoke.run_ee_serve_phase(fake_torch, kernels)
    finally:
        for k in kernels.KERNELS:
            k.reset()


@pytest.mark.parametrize("shape,mbytes", [("main", 4.246604),
                                          ("long", 10.518544)])
def test_chip_smoke_k6_byte_bound(shape, mbytes):
    """K6's bound counts once the K/V rows below each lane's length in its
    mapped pages, the page-table entries of its live pages, the lengths, q
    and the output: 3,293 rows (not the 207 x 16 of whole pages) of 5 kv
    heads x 64 bf16 K and V at the serve's decode shape, 8,192 (~3.1 us at
    3.35 TB/s) with every lane at 2048 tokens."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    clens, n_q, n_kv, hd, page, J, pool = smoke.K6_SHAPES[shape]
    q = torch.zeros((len(clens), n_q, hd))
    kp = torch.zeros((pool + 1, page, n_kv, hd), dtype=torch.bfloat16)
    pt = torch.full((len(clens), J), -1, dtype=torch.int32)
    n = 0
    for i, c in enumerate(clens):
        for j in range(-(-c // page)):
            pt[i, j] = n
            n += 1
    ms, by = smoke.paged_bound(q, kp, pt, torch.tensor(clens))
    assert by == "bytes"
    assert ms == pytest.approx(mbytes * 1e6 / smoke.PEAK_BYTES * 1e3,
                               rel=1e-9)
    pt[0, 1] = -1                  # an unmapped page is not read
    assert smoke.paged_bound(q, kp, pt, torch.tensor(clens))[0] < ms


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_convert_round_trips_reference_params_bit_exactly(param_dtype):
    pytest.importorskip("jax")
    import jax
    from repro.configs import DistConfig, get_config, reduced_config
    from repro.models import model as JM
    from repro_torch import convert

    cfg = reduced_config(get_config("smollm-360m"))
    dcfg = DistConfig(num_stages=2, param_dtype=param_dtype)
    ref = jax.tree.map(np.asarray,
                       JM.init_params(jax.random.PRNGKey(3), cfg, dcfg))
    tree = convert.to_torch(ref, "cpu")
    want_dt = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
    assert tree["stages"]["wq"].dtype == want_dt
    assert tree["embed"].dtype == torch.float32
    back = convert.to_numpy(tree, like=ref)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, a in flat_ref:
        b = flat_back[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_convert_carries_reference_moe_trees_bit_exactly():
    """A reference Mixtral tree (bf16 experts, the fp32 router) and its
    ``expert_map`` dyn leaf reach the port bit-exactly, in the dtypes and
    shapes the port's own spec gives them."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import DistConfig, get_config, reduced_config
    from repro.dynamics.config import DynamicsConfig
    from repro.models import model as JM
    from repro_torch import convert
    from repro_torch.configs import DistConfig as TDist
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import reduced_config as treduce
    from repro_torch.dynamics.config import DynamicsConfig as TDyn
    from repro_torch.launch.engine import _check_tree
    from repro_torch.models import model as TM

    cfg = reduced_config(get_config("mixtral-8x7b"))
    dcfg = DistConfig(num_stages=2, param_dtype="bfloat16")
    ref = jax.tree.map(np.asarray, {
        "params": JM.init_params(jax.random.PRNGKey(4), cfg, dcfg),
        "dyn": JM.init_dyn(cfg, dcfg, DynamicsConfig(
            kind="moe", expert_relayout=True))})
    tree = convert.to_torch(ref, "cpu")
    st = tree["params"]["stages"]
    assert st["router"].dtype == torch.float32
    assert st["ewg"].dtype == st["ewo"].dtype == torch.bfloat16
    tcfg = treduce(tget("mixtral-8x7b"))
    tdcfg = TDist(num_stages=2, param_dtype="bfloat16")
    _check_tree(tree["params"], TM.param_spec(tcfg, tdcfg))
    tdyn = TM.init_dyn(tcfg, tdcfg, TDyn(kind="moe", expert_relayout=True))
    assert set(tdyn) == set(tree["dyn"])
    assert torch.equal(tdyn["expert_map"], tree["dyn"]["expert_map"])
    back = convert.to_numpy(tree, like=ref)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, a in flat_ref:
        b = flat_back[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def _roadmap_items():
    """The tags of ``ROADMAP.md``'s Queue 1 items (``1. **[tag] ...``)."""
    text = (REPO / "ROADMAP.md").read_text()
    queue = text.split("### Queue 1", 1)[1].split("\n### ", 1)[0]
    return set(re.findall(r"^\d+\. \*\*\[([a-z0-9-]+)\]", queue, re.M))


def _port_strings():
    """(file, line, text) of every string constant in the port, f-string
    parts joined."""
    import ast
    for f in sorted((SRC / "repro_torch").rglob("*.py")):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.JoinedStr):
                text = "".join(v.value for v in node.values
                               if isinstance(v, ast.Constant))
            elif (isinstance(node, ast.Constant)
                  and isinstance(node.value, str)):
                text = node.value
            else:
                continue
            yield f.relative_to(REPO), node.lineno, text


def test_roadmap_tags_in_the_port_are_current_items():
    """Every ``[tag]`` the port names next to ``ROADMAP`` — in a
    ``NotImplementedError`` message, a flag table or a docstring — is an
    item of ROADMAP.md's Queue 1, so a user who follows it finds it."""
    items = _roadmap_items()
    assert {"bench"} <= items, items
    assert not {"checkpoint", "control-timing", "sim-data", "cluster",
                "serve-sampling", "api", "faults-obs", "moe-rest",
                "block-families", "multi-card", "tpu-mesh", "examples",
                "scan-vjp"} & items, items
    stale, seen, named = [], 0, set()
    for path, line, text in _port_strings():
        if "ROADMAP" not in text:
            continue
        for tag in re.findall(r"\[([a-z][a-z0-9-]*)\]",
                              text.split("ROADMAP", 1)[1]):
            seen += 1
            named.add(tag)
            if tag not in items:
                stale.append(f"{path}:{line} [{tag}]")
    # the scanner finds every refusal's item (the retired [faults-obs]
    # mentions took the count from 21 to 10, [moe-rest] and
    # [block-families] from 10 to 3; the ranks' refusals of what is left of
    # [multi-card] — resizes, safe points, the elastic server, the other
    # families, FSDP — took it from 3 to 13; resizes across ranks and the
    # elastic server across ranks, ported, took it to 9; safe points
    # across ranks, ported, took the engine's restore refusal: 8; every
    # family across ranks and the end of the FSDP refusal retired
    # [multi-card]: 1, the ranks' layout note naming [tpu-mesh]; the dry
    # run, the examples and the scan's flash backward, ported, retired
    # [tpu-mesh], [examples] and [scan-vjp]: 0 — the port names no item,
    # and Queue 1 holds only [bench], which no port code refuses)
    assert seen == 0 and not named, named
    assert not stale, stale


def test_not_implemented_errors_name_a_roadmap_item():
    """Each ``raise NotImplementedError`` of the port names its ROADMAP
    item in its message (or in the flag table it formats)."""
    import ast
    bare = []
    for f in sorted((SRC / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if not (isinstance(node, ast.Raise) and isinstance(
                    node.exc, ast.Call) and getattr(
                    node.exc.func, "id", None) == "NotImplementedError"):
                continue
            text = ast.unparse(node.exc)
            if "ROADMAP" not in text and "what" not in text:
                bare.append(f"{f.relative_to(REPO)}:{node.lineno} {text}")
    # configs.base keeps the reference's guard against a per-model call
    assert bare == ["src/repro_torch/configs/base.py:235 "
                    "NotImplementedError('use slots_for(model_cfg)')"], bare
