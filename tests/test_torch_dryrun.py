"""The port's dry run (``repro_torch.launch.{mesh,specs,sharding,
roofline,counting,dryrun}``) held to the reference's on the CPU.

One subprocess with 512 host devices dumps, for all 80 (arch x shape x
mesh) cells, the reference's ``input_specs`` (every leaf's shape, dtype,
partition entries and per-card shard shape), ``plan_shapes``,
``arch_dist_config``, the skip reasons and ``_analytic_roofline`` (~2 s of
work); a module fixture shares the dump.  Per cell the port's specs and
placements, per-card argument bytes and analytic terms must equal it (the
FLOPs, bytes, collective bytes and model FLOPs to rtol 1e-12; the times
too when the reference's v5e constants are passed in).  The counted probe
is checked against the cost model at a reduced dense config, on ``meta``
against the CPU, and for which cells it runs; the dry run allocates
nothing and never asks for a device.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES, DistConfig, get_config, \
    reduced_config
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.pipeline.pipeline import PipelineShapes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": False, "2x16x16": True}
CELLS = [(a, s, m) for m in MESHES for a in DR.ARCHS for s in SHAPES]

_DUMP = textwrap.dedent('''
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import dataclasses, json, sys
    import jax, numpy as np
    from repro.configs.base import SHAPES
    from repro.launch.dryrun import ARCHS, _analytic_roofline
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import input_specs, arch_dist_config
    out = {}
    for name, mp in (("16x16", False), ("2x16x16", True)):
        mesh = make_production_mesh(multi_pod=mp)
        for a in ARCHS:
            for s in SHAPES:
                cell = input_specs(a, s, mesh)
                d = {"skip": cell.skip_reason,
                     "shapes": dataclasses.asdict(cell.shapes),
                     "dcfg": {k: getattr(cell.dcfg, k) for k in (
                         "num_stages", "slot_slack", "remat", "optimizer",
                         "fsdp", "param_dtype")}}
                if not cell.skip_reason:
                    leaves = []
                    flat, _ = jax.tree_util.tree_flatten_with_path(
                        cell.args)
                    nbytes = 0
                    for path, leaf in flat:
                        keys = [str(getattr(p, "key", getattr(p, "idx",
                                                              None)))
                                for p in path]
                        sh = leaf.sharding
                        spec = [] if sh is None else [
                            list(e) if isinstance(e, tuple) else e
                            for e in sh.spec]
                        shard = (list(leaf.shape) if sh is None
                                 else list(sh.shard_shape(leaf.shape)))
                        nbytes += int(np.prod(shard)) * leaf.dtype.itemsize
                        leaves.append([keys, list(leaf.shape),
                                       str(leaf.dtype), spec, shard])
                    d["leaves"] = leaves
                    d["arg_bytes"] = nbytes
                    S = cell.dcfg.num_stages
                    d["roofline"] = _analytic_roofline(
                        cell, mesh.size, cell.shapes.num_micro + S - 1)
                out[f"{a}|{s}|{name}"] = d
    json.dump(out, sys.stdout, default=str)
''')


@pytest.fixture(scope="module")
def ref():
    res = subprocess.run(
        [sys.executable, "-c", _DUMP], capture_output=True, text=True,
        timeout=600, cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
             "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout)


def _port_leaves(args):
    out = []

    def walk(node, keys):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], keys + [k])
        else:
            out.append((keys, node))
    for i, a in enumerate(args):
        walk(a, [str(i)])
    return out


def _entries(spec, ndim):
    """Partition entries padded to the leaf's rank (a tuple of axes as a
    list, as the dump writes it)."""
    spec = [list(e) if isinstance(e, tuple) else e for e in spec]
    return (spec + [None] * ndim)[:ndim]


@pytest.mark.parametrize("arch,shape,mesh_name", CELLS,
                         ids=["-".join(c) for c in CELLS])
def test_cell_specs_bytes_and_analytic_terms_match_the_reference(
        ref, arch, shape, mesh_name):
    r = ref[f"{arch}|{shape}|{mesh_name}"]
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    cell = input_specs(arch, shape, mesh)
    assert cell.skip_reason == r["skip"]
    shp = cell.shapes
    assert {k: getattr(shp, k) for k in r["shapes"]} == r["shapes"]
    assert {k: getattr(cell.dcfg, k) for k in r["dcfg"]} == r["dcfg"]
    if r["skip"]:
        assert cell.args == ()
        return
    port = _port_leaves(cell.args)
    assert [p[0] for p in port] == [x[0] for x in r["leaves"]]
    for (keys, leaf), (_, shape_, dtype, spec, shard) in zip(
            port, r["leaves"]):
        where = "/".join(keys)
        assert list(leaf.shape) == shape_, where
        assert str(leaf.dtype).replace("torch.", "") == dtype, where
        nd = len(shape_)
        assert _entries(leaf.placement, nd) == _entries(spec, nd), where
        assert list(SH.shard_shape(leaf.shape, leaf.placement,
                                   mesh)) == shard, where
    assert sum(SH.tree_bytes(a, mesh) for a in cell.args) == r["arg_bytes"]
    T_real = shp.num_micro + cell.dcfg.num_stages - 1
    want = r["roofline"]
    got = DR.analytic_roofline(cell, mesh.size, T_real)
    for k in ("flops_per_chip", "hbm_bytes_per_chip", "coll_bytes_per_chip",
              "model_flops"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    # the reference's v5e constants in: its times and verdict out
    v5e = DR.analytic_roofline(cell, mesh.size, T_real, peak_flops=197e12,
                               hbm_bw=819e9, link_bw=50e9)
    for k in ("t_compute_s", "t_memory_s", "t_collective_s",
              "t_memory_analytic_s", "useful_flops_ratio", "mfu_bound"):
        np.testing.assert_allclose(v5e[k], want[k], rtol=1e-12, err_msg=k)
    assert v5e["bottleneck"] == want["bottleneck"]
    # and the port's own: the H100's data-sheet peaks
    assert got["t_compute_s"] == got["flops_per_chip"] / 989e12
    assert got["t_memory_s"] == got["hbm_bytes_per_chip"] / 3.35e12
    assert got["t_collective_s"] == got["coll_bytes_per_chip"] / 50e9


def test_fsdp_layout_and_per_card_bytes():
    """Above 8e9 parameters a stage leaf is split over ``data`` on its
    largest divisible dim (and its Adam moments with it); below, only over
    ``model``.  Per-card bytes are the whole tree's over the cards that
    split it."""
    mesh = make_production_mesh()
    big = input_specs("mixtral-8x7b", "train_4k", mesh)
    small = input_specs("smollm-360m", "train_4k", mesh)
    assert big.dcfg.fsdp and not small.dcfg.fsdp
    wi = big.args[0]["stages"]["ewi"]
    assert wi.placement == ("model", None, None, None, "data")
    assert big.args[1]["m"]["stages"]["ewi"].placement == wi.placement
    assert SH.shard_shape(wi.shape, wi.placement, mesh) == (
        1, 3, 8, 4096, 14336 // 16)
    assert all(p.placement[0] == "model" and "data" not in p.placement
               for p in small.args[0]["stages"].values())
    whole = SH.tree_bytes(big.args[0]["stages"])
    assert SH.tree_bytes(big.args[0]["stages"], mesh) < whole / 16
    llama = input_specs("llama3-405b", "train_4k", mesh)
    f = llama.args[1]["f"]["stages"]["wq"]
    assert set(f) == {"vr", "vc"}          # Adafactor's factored moments


def test_counted_probe_matches_the_cost_model_at_a_reduced_dense_config():
    """A prefill probe of one dense stage (no head): the projections' and
    FFN's matmul FLOPs equal ``cost_model.layer_flops``' terms exactly;
    K1's equal its attention term times the causal share of tiles,
    (n + 1) / 2n for n query blocks (``layer_flops`` counts the whole
    square).  The tolerance is float rounding, rtol 1e-12."""
    from repro_torch.core import cost_model as CM
    cfg = reduced_config(get_config("smollm-360m"), num_layers=4,
                         d_model=128, num_heads=4, num_kv_heads=2,
                         d_ff=256, vocab_size=256)
    dcfg = DistConfig(num_stages=2, slot_slack=0, param_dtype="float32",
                      remat="none")
    shapes = PipelineShapes(num_micro=1, mb_global=2, seq=512,
                            cache_len=512)
    res = DR.probe_stage(cfg, dcfg, DynamicsConfig(), "prefill", shapes,
                         stages=[0])
    t, seq = 2 * 512, 512
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    proj = 2 * t * d * (2 * nq * hd + 2 * nkv * hd)
    ffn = 2 * t * 3 * d * cfg.d_ff
    att = 2 * t * seq * nq * hd * 2
    layers = res["slots"]
    assert layers == 2
    assert np.isclose(
        sum(CM.layer_flops(cfg, 1, t, seq) for _ in range(layers)),
        layers * (proj + ffn + att), rtol=1e-12)
    k = res["kernels"]
    np.testing.assert_allclose(k["K3"]["flops"], layers * ffn, rtol=1e-12)
    np.testing.assert_allclose(res["flops"] - k["K3"]["flops"]
                               - k["K1"]["flops"], layers * proj,
                               rtol=1e-12)
    n = seq // 128
    np.testing.assert_allclose(k["K1"]["flops"],
                               layers * att * (n + 1) / (2 * n), rtol=1e-12)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_probe_on_meta_equals_the_probe_on_the_cpu(kind):
    """The same probe on ``meta`` tensors and on CPU tensors (the kernels'
    plain versions run there) counts the same FLOPs, bytes, live peak and
    per-kernel work."""
    cfg = reduced_config(get_config("smollm-360m"), num_layers=4,
                         d_model=64, num_heads=4, num_kv_heads=2,
                         d_ff=256, vocab_size=256)
    dcfg = DistConfig(num_stages=2, slot_slack=1, param_dtype="float32",
                      remat="full")
    shapes = PipelineShapes(num_micro=2, mb_global=2, seq=256,
                            cache_len=256)
    meta = DR.probe_stage(cfg, dcfg, DynamicsConfig(), kind, shapes)
    cpu = DR.probe_stage(cfg, dcfg, DynamicsConfig(), kind, shapes,
                         device="cpu")
    assert meta == cpu
    assert meta["flops"] > 0 and meta["peak_bytes"] > 0
    if kind != "decode":
        assert {"K1", "K3"} <= set(meta["kernels"])
    if kind == "train":
        assert {"K2a", "K2b", "K3.bwd"} <= set(meta["kernels"])


@pytest.mark.parametrize("stages", [None, (0, 1)])
def test_two_probes_give_the_step_of_m_microbatches(stages):
    """From the second microbatch on, each adds the same work and keeps
    the same bytes until the backward, so the probes of two and three
    microbatches, extrapolated to five, equal the probe of five: FLOPs,
    bytes and the live peak (the last stage, and both stages in a row as
    one card runs them).  At m = 1 the step is the probe of one."""
    cfg = reduced_config(get_config("smollm-360m"), num_layers=4,
                         d_model=64, num_heads=4, num_kv_heads=2,
                         d_ff=256, vocab_size=256)
    dcfg = DistConfig(num_stages=2, slot_slack=1, param_dtype="float32",
                      remat="full")
    shapes = PipelineShapes(num_micro=5, mb_global=2, seq=256,
                            cache_len=256)
    lo, hi = DR.probe_step(cfg, dcfg, DynamicsConfig(), "train", shapes,
                           stages=stages)
    assert (lo["micro"], hi["micro"]) == (2, 3)
    five = DR.probe_stage(cfg, dcfg, DynamicsConfig(), "train", shapes,
                          stages=stages, micro=5)
    got = DR.scale_probe(lo, hi, 5)
    for k in ("flops", "bytes", "peak_bytes"):
        np.testing.assert_allclose(got[k], five[k], rtol=1e-12, err_msg=k)
    assert five["peak_bytes"] > hi["peak_bytes"]
    one = DR.probe_stage(cfg, dcfg, DynamicsConfig(), "train", shapes,
                         stages=stages, micro=1)
    single = dataclasses.replace(shapes, num_micro=1)
    got = DR.scale_probe(*DR.probe_step(cfg, dcfg, DynamicsConfig(),
                                        "train", single, stages=stages), 1)
    assert got == {k: one[k] for k in ("flops", "bytes", "peak_bytes")}


def test_dry_run_allocates_nothing_and_needs_no_device(monkeypatch,
                                                       tmp_path):
    """``--all`` over both meshes with ``torch.cuda.is_available``
    patched to False: no op makes a tensor off ``meta``, and
    ``resolve_device`` is never called.  A probe's only host tensors are
    the ``frozen`` leaf (a stage's slots) and the positions."""
    from torch.utils._python_dispatch import TorchDispatchMode
    import repro_torch.device as D
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*a, **k):
        raise AssertionError("resolve_device called")
    monkeypatch.setattr(D, "resolve_device", refuse)

    class Devices(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.host_bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor) and not t.is_meta:
                    self.host_bytes += t.numel() * t.element_size()
            return out

    with Devices() as dev:
        for mp in (False, True):
            argv = ["--all", "--out", str(tmp_path), "--force"]
            res = DR.main(argv + (["--multi-pod"] if mp else []))
            summ = DR.summary(res, "x")
            assert (summ["analysed"], summ["skipped"]) == (34, 6)
            # no probe, no count of the activations: no verdict
            assert (summ["unprobed"], summ["fits_80GB"],
                    summ["over_80GB"]) == (34, 0, 0)
            assert all(r["memory"]["peak_bytes_per_chip"] is None
                       for r in res if "memory" in r)
    assert dev.host_bytes == 0
    with Devices() as dev:
        out = DR.run_cell("mixtral-8x7b", "train_4k", probes=True,
                          verbose=False)
    assert "error" not in out["probe"]
    assert 0 < dev.host_bytes < 64 * 1024
    assert len(os.listdir(tmp_path)) == 80


def test_probes_run_for_every_dense_arch_and_mixtral():
    """The counted probe runs at full width for every dense arch and both
    Mixtrals on ``train_4k``: the dense archs' attention and FFN through
    K1 / K2a / K2b / K3, Mixtral's experts through K4 / K5 (its sliding
    window keeps attention on the scan, counted op by op).  The only cells
    it refuses are xLSTM's 32k-position prefills (named in the JSON)."""
    for arch in ("smollm-360m", "llama3-405b", "command-r-plus-104b",
                 "deepseek-coder-33b", "mixtral-8x7b", "mixtral-8x22b"):
        out = DR.run_cell(arch, "train_4k", probes=True, verbose=False)
        pr = out["probe"]
        assert "error" not in pr, (arch, pr)
        assert pr["flops_per_step"] > 0
        # every microbatch's stage input waits for the backward: the
        # step's temp is above one microbatch's
        assert out["memory"]["temp_bytes_per_chip"] == pr["temp_bytes"] \
            > pr["per_micro"]["peak_bytes"]
        assert isinstance(out["memory"]["fits_80GB"], bool)
        if "mixtral" in arch:
            assert set(pr["kernels"]) == {"K4", "K4.dx", "K5"}
        else:
            assert set(pr["kernels"]) == {"K1", "K2a", "K2b", "K3",
                                          "K3.bwd"}
    out = DR.run_cell("xlstm-1.3b", "prefill_32k", probes=True,
                      verbose=False)
    assert "xLSTM prefill" in out["probe"]["error"]


def test_roofline_constants_are_the_h100_data_sheet():
    t = RL.RooflineTerms(flops=989e12, hbm_bytes=3.35e12, coll_bytes=50e9,
                         chips=256, model_flops=989e12 * 128)
    assert t.t_compute == t.t_memory == t.t_collective == 1.0
    assert RL.peak_flops("float32") == 67e12
    assert RL.link_bandwidth(8) == 450e9 and RL.link_bandwidth(256) == 50e9
    assert t.mfu_bound == 0.5
    ex = RL.extrapolate({"flops": 10.0}, {"flops": 14.0}, 2, 3, 10)
    assert ex == {"flops": 42.0}
