"""Rules the PyTorch port keeps.

* ``repro_torch`` and ``chip_smoke.py`` import neither jax nor the JAX
  package — checked in the source and in ``sys.modules`` after a CPU serve
  and a CPU train, of smollm and of the MoE slice (reduced Mixtral through
  the grouped-matmul kernels, the expert layout and the Mixtral config).
* ``chip_smoke.py``'s MoE phases require K4 and K5 launches.
* Entry points run on CUDA and raise without a card unless the caller asks
  for the CPU; features outside the slice raise ``NotImplementedError``.
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


def test_cpu_serve_imports_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "from repro_torch.launch.serve import run\n"
        f"rep = run({SERVE_ARGS + ['--device', 'cpu']!r})\n"
        "assert len(rep['completions']) == 6, rep['completions']\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('CLEAN', rep['total_tokens'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN" in out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


def test_cpu_train_imports_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "from repro_torch.launch.train import run\n"
        f"rep = run({TRAIN_ARGS + ['--device', 'cpu']!r})\n"
        "assert len(rep['losses']) == 2, rep['losses']\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('CLEAN', rep['controller']['decided'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN 2" in out.stdout


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
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {MOE_MODULES!r} if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('CLEAN', len(rep['relayouts']))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN" in out.stdout


def test_no_jax_or_reference_imports_in_the_port():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert len(files) > 20
    names = {str(f.relative_to(SRC)) for f in files if SRC in f.parents}
    for mod in MOE_MODULES:
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


@pytest.mark.parametrize("extra,what", [
    (["--dynamism", "early_exit"], "early_exit"),
    (["--dynamism", "mod"], "mod"),
    (["--temperature", "0.7"], "temperature"),
    (["--autoscale"], "autoscal"),
    (["--chaos"], "fault"),
])
def test_features_outside_the_slice_raise(extra, what):
    from repro_torch.launch.serve import run
    with pytest.raises(NotImplementedError, match=what):
        run(SERVE_ARGS + ["--device", "cpu"] + extra)


@pytest.mark.parametrize("extra,what", [
    (["--repack"], "consolidation"),
    (["--autoscale"], "autoscal"),
    (["--async-controller"], "asynchronous"),
    (["--job-manager", "file"], "job managers"),
    (["--resume", "ckpt"], "resume"),
    (["--ckpt-dir", "ckpt"], "checkpoint"),
    (["--chaos"], "fault"),
    (["--measure-stage-times"], "stage-time"),
    (["--in-step-timing"], "in-step"),
    (["--dynamism", "early_exit"], "early_exit"),
    (["--dynamism", "mod"], "mod"),
    (["--arch", "mixtral-8x7b", "--dynamism", "pruning"], "moe"),
])
def test_train_features_outside_the_slice_raise(extra, what):
    from repro_torch.launch.train import run
    with pytest.raises(NotImplementedError, match=what):
        run(TRAIN_ARGS + ["--device", "cpu"] + extra)


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
