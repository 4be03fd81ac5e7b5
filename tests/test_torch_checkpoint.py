"""The port's checkpoints and safe points (``repro_torch.checkpoint``),
held to ``repro.checkpoint``.

* A training state (params, AdamW moments and count, dyn state) round
  trips bitwise, in fp32 and — stored as raw 16 bits, the dtype in the
  index — in bf16 (the reduced Mixtral config's experts).
* A torn newest checkpoint (a shard that fails its sha256, or a ``.tmp``
  directory a crash left behind) falls back to the newest complete one;
  the managers keep the newest ``keep``.
* Shard parity: the reference's ``save_checkpoint`` and the port's, on the
  same fp32 state (the reference's, converted), write the same file names,
  the same npz keys and the same arrays bitwise, and indexes with the same
  ``step``, ``layers_per_stage`` and ``num_stages``.
* ``WorkerPool.state_dict`` / ``from_state`` round-trip the pool (sets as
  sets, the log too) with the reference's keys.
* A safe point stores the producing ``RunSpec`` as ``spec``; one that
  carries the train CLI's flags as ``args`` and no ``spec`` (written
  before the RunSpec front door) is refused by name, by ``peek`` and by
  ``Session.resume``.

Sizes: reduced smollm (4 layers, d_model 64, heads 4/2, d_ff 256, vocab
256) on 2 stage buffers; bitwise everywhere (no arithmetic).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.api.specs import RunSpec
from repro_torch.checkpoint import (CheckpointManager, SafepointManager,
                                    latest_index, load_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint import safepoint as sp
from repro_torch.configs import DistConfig, get_config, reduced_config
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.launch.engine import ElasticEngine
from repro_torch.pipeline.pipeline import PipelineShapes
from repro_torch.runtime.fault_tolerance import WorkerPool

torch.set_num_threads(1)
KW = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, d_ff=256,
          vocab_size=256)


def _engine(arch="smollm-360m", param_dtype="float32", dyncfg=None,
            stages=2):
    cfg = reduced_config(get_config(arch), **KW)
    dcfg = DistConfig(num_stages=stages, param_dtype=param_dtype)
    return ElasticEngine(cfg, dcfg, dyncfg or DynamicsConfig(kind="pruning"),
                         PipelineShapes(2, 2, 16), device="cpu")


def _state(engine, seed=0):
    st = engine.init_state(seed, with_opt=True)
    g = torch.Generator().manual_seed(seed + 1)
    # non-trivial moments, count and masks, so a swapped leaf would show
    for tree in (st.opt_state["m"], st.opt_state["v"]):
        for k, v in _flat(tree).items():
            v.copy_(torch.randn(v.shape, generator=g).to(v.dtype))
    st.opt_state["count"] = torch.tensor(7, dtype=torch.int32)
    st.dyn["ff_mask"] = (torch.rand(st.dyn["ff_mask"].shape, generator=g)
                         > 0.5).float()
    return st


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _assert_bitwise(got, want):
    fg, fw = _flat(got), _flat(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and fg[k].shape == fw[k].shape, k
        assert fg[k].numpy().tobytes() == fw[k].numpy().tobytes() \
            if fg[k].dtype != torch.bfloat16 else torch.equal(
                fg[k].view(torch.int16), fw[k].view(torch.int16)), k


def _save(path, step, st, meta=None):
    return save_checkpoint(str(path), step, st.params, st.opt_state, st.dyn,
                           st.lps, extra_meta=meta)


def test_round_trip_is_bitwise(tmp_path):
    eng = _engine()
    st = _state(eng)
    ck = _save(tmp_path, 5, st, {"note": "x"})
    assert sorted(os.listdir(ck)) == ["common.npz", "index.json",
                                      "stage_000.npz", "stage_001.npz"]
    p, o, d, idx = load_checkpoint(str(tmp_path),
                                   eng.state_templates(2), device="cpu")
    _assert_bitwise({"p": p, "o": o, "d": d},
                    {"p": st.params, "o": st.opt_state, "d": st.dyn})
    assert idx["step"] == 5 and idx["num_stages"] == 2
    assert idx["layers_per_stage"] == [2, 2] and idx["meta"] == {"note": "x"}
    assert idx["dtypes"]["opt/count"] == "int32"
    assert latest_index(str(tmp_path))["step"] == 5


def test_bf16_mixtral_round_trip_is_bitwise(tmp_path):
    eng = _engine("mixtral-8x7b", "bfloat16",
                  DynamicsConfig(kind="moe", expert_relayout=True))
    st = _state(eng, seed=3)
    assert st.params["stages"]["ewg"].dtype == torch.bfloat16
    _save(tmp_path, 2, st)
    idx = latest_index(str(tmp_path))
    assert idx["dtypes"]["params/stages/ewg"] == "bfloat16"
    assert idx["dtypes"]["params/stages/router"] == "float32"
    with np.load(os.path.join(str(tmp_path), "step_00000002",
                              "stage_001.npz")) as z:
        assert z["params/stages/ewg"].dtype == np.uint16   # raw 16 bits
        assert "dyn/expert_map" in z.files
    p, o, d, _ = load_checkpoint(str(tmp_path), eng.state_templates(2))
    _assert_bitwise({"p": p, "o": o, "d": d},
                    {"p": st.params, "o": st.opt_state, "d": st.dyn})


@pytest.mark.parametrize("tear", ["shard", "index", "tmp"])
def test_torn_newest_falls_back_to_complete(tmp_path, tear):
    eng = _engine()
    old, new = _state(eng, 0), _state(eng, 1)
    _save(tmp_path, 4, old)
    ck = _save(tmp_path, 8, new)
    if tear == "shard":                 # a shard cut short: sha256 fails
        f = os.path.join(ck, "stage_001.npz")
        with open(f, "r+b") as fh:
            fh.truncate(os.path.getsize(f) // 2)
    elif tear == "index":               # died before the index was written
        os.remove(os.path.join(ck, "index.json"))
    else:                               # died before the rename
        os.rename(ck, ck + ".tmp")
    p, o, d, idx = load_checkpoint(str(tmp_path), eng.state_templates(2))
    assert idx["step"] == 4
    _assert_bitwise({"p": p, "o": o, "d": d},
                    {"p": old.params, "o": old.opt_state, "d": old.dyn})
    assert latest_index(str(tmp_path))["step"] == 4
    # a named step is that checkpoint or, when absent, the newest complete
    # one (the reference's rule); named and torn, it is not loaded
    assert load_checkpoint(str(tmp_path), eng.state_templates(2),
                           step=6)[3]["step"] == 4
    if tear != "tmp":
        with pytest.raises(FileNotFoundError):
            load_checkpoint(str(tmp_path), eng.state_templates(2), step=8)


def test_load_refuses_a_template_of_another_world(tmp_path):
    eng = _engine()
    _save(tmp_path, 1, _state(eng))
    with pytest.raises(ValueError, match="shape|stages"):
        load_checkpoint(str(tmp_path), _engine(stages=4).state_templates(4))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"), eng.state_templates(2))


def test_managers_keep_the_newest(tmp_path):
    eng = _engine()
    st = _state(eng)
    cm = CheckpointManager(str(tmp_path / "ck"), keep=2, every=2)
    saved = [cm.maybe_save(s, st.params, st.opt_state, st.dyn, st.lps)
             for s in range(7)]
    assert [s is not None for s in saved] == [True, False] * 3 + [True]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000004",
                                                   "step_00000006"]
    assert cm.restore(eng.state_templates(2))[3]["step"] == 6

    spm = SafepointManager(str(tmp_path / "sp"), every=3, keep=2)
    assert [s for s in range(10) if spm.due(s)] == [2, 5, 8]
    for s in (2, 5, 8):
        spm.save(s, st, spec=RunSpec(steps=9), engine=eng,
                 repack_enabled=True)
    assert sorted(os.listdir(tmp_path / "sp")) == ["step_00000005",
                                                   "step_00000008"]
    idx = sp.peek(str(tmp_path / "sp"))
    meta = idx["meta"]
    assert meta["kind"] == "safepoint" and meta["step"] == 8
    assert meta["spec"] == RunSpec(steps=9).to_dict()
    assert RunSpec.from_dict(meta["spec"]) == RunSpec(steps=9)
    assert meta["scaler"] is None
    assert meta["stage_workers"] == [0, 1] and meta["epoch"] == 0
    assert meta["repack_enabled"] is True
    assert WorkerPool.from_state(meta["pool"]).state_dict() \
        == eng.pool.state_dict()
    assert sp.peek(str(tmp_path / "sp"), step=5)["step"] == 5
    # a plain checkpoint is not a safe point
    with pytest.raises(ValueError, match="not a safe point"):
        sp.peek(str(tmp_path / "ck"))


def test_args_only_safe_point_is_refused_by_name(tmp_path):
    """A safe point written before the RunSpec front door (the train CLI's
    flags as ``args``, no ``spec``) is refused with a ValueError naming
    what it lacks, by ``peek`` and by ``Session.resume``; its shards still
    load as a plain checkpoint."""
    from repro_torch.api.session import Session
    eng = _engine()
    st = _state(eng)
    meta = {"kind": "safepoint", "args": {"steps": 9, "resume": None},
            "step": 3, "stage_workers": [0, 1], "epoch": 0, "pool": None,
            "scaler": None, "repack_enabled": True}
    save_checkpoint(str(tmp_path), 3, st.params, st.opt_state, st.dyn,
                    st.lps, extra_meta=meta)
    for call in (lambda: sp.peek(str(tmp_path)),
                 lambda: Session.resume(str(tmp_path), device="cpu")):
        with pytest.raises(ValueError,
                           match="'args'.*RunSpec.*predates the RunSpec "
                                 "front door"):
            call()
    assert load_checkpoint(str(tmp_path), eng.state_templates(2))[3][
        "step"] == 3


def test_worker_pool_state_round_trip():
    pool = WorkerPool(4)
    pool.release([2, 3])
    pool.fail(1)
    assert pool.request(1) == [2]
    sd = json.loads(json.dumps(pool.state_dict()))
    back = WorkerPool.from_state(sd)
    assert back.active == {0, 2} and isinstance(back.active, set)
    assert back.released == {3} and back.dead == {1}
    assert sd["provisioned"] == [] and sd["spares"] == 0
    assert back.log == ["release:2", "release:3", "fail:1", "grant:2"]
    assert back.state_dict() == sd
    back.check_consistent()
    assert back.request(2) == [3] and back.log[-1] == "grant:3"
    pytest.importorskip("jax")
    from repro.runtime.fault_tolerance import WorkerPool as RefPool
    ref = RefPool(4)
    ref.release([2, 3])
    ref.fail(1)
    ref.request(1)
    want = ref.state_dict()
    assert {k: v for k, v in sd.items() if k != "log"} == want
    assert RefPool.from_state(sd).state_dict() == want
    # a pool with spare machines round-trips too (fresh ids minted past
    # next_id when the released ones run out)
    spare = WorkerPool.from_state({**want, "spares": 2})
    assert spare.spares == 2 and spare.request(3) == [3, 4, 5]
    assert {k: v for k, v in spare.state_dict().items() if k != "log"} \
        == RefPool.from_state({**want, "spares": 2}).state_dict() | {
            "active": [0, 2, 3, 4, 5], "released": [],
            "provisioned": [4, 5], "next_id": 6}


def test_shards_equal_the_references_key_by_key(tmp_path):
    pytest.importorskip("jax")
    import jax
    from repro.checkpoint.checkpoint import \
        save_checkpoint as ref_save
    from repro.configs import DistConfig as RDist
    from repro.configs import get_config as rget
    from repro.configs import reduced_config as rreduce
    from repro.dynamics.config import DynamicsConfig as RDyn
    from repro.models import model as RM
    from repro.optim.optimizers import OptConfig, make_optimizer
    from repro_torch import convert

    cfg = rreduce(rget("smollm-360m"), **KW)
    dcfg = RDist(num_stages=2, param_dtype="float32")
    params = RM.init_params(jax.random.PRNGKey(2), cfg, dcfg)
    opt = make_optimizer(OptConfig())[0](params)
    opt = {**opt, "m": jax.tree.map(lambda a: a + 0.5, params),
           "count": opt["count"] + 3}
    dyn = RM.init_dyn(cfg, dcfg, RDyn(kind="pruning"))
    lps = [2, 2]
    ref_dir = ref_save(str(tmp_path / "ref"), 6, params, opt, dyn, lps)
    tree = convert.to_torch(jax.tree.map(np.asarray, {
        "p": params, "o": opt, "d": dyn}), "cpu")
    got_dir = save_checkpoint(str(tmp_path / "port"), 6, tree["p"],
                              tree["o"], tree["d"], lps)
    npz = sorted(f for f in os.listdir(ref_dir) if f.endswith(".npz"))
    assert npz == sorted(f for f in os.listdir(got_dir)
                         if f.endswith(".npz")) == [
        "common.npz", "stage_000.npz", "stage_001.npz"]
    n = 0
    for f in npz:
        with np.load(os.path.join(ref_dir, f)) as a, \
                np.load(os.path.join(got_dir, f)) as b:
            assert a.files == b.files, f
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (f, k)
                assert a[k].shape == b[k].shape, (f, k)
                assert a[k].tobytes() == b[k].tobytes(), (f, k)
                n += 1
    assert n > 30
    import msgpack
    with open(os.path.join(ref_dir, "index.msgpack"), "rb") as fh:
        ref_idx = msgpack.unpackb(fh.read(), strict_map_key=False)
    with open(os.path.join(got_dir, "index.json")) as fh:
        got_idx = json.load(fh)
    for key in ("step", "layers_per_stage", "num_stages", "files"):
        assert got_idx[key] == ref_idx[key], key
