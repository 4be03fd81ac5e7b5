"""Safe points and bit-identical resume in the port's train CLI
(``--ckpt-dir``, ``--ckpt-every``, ``--resume``), on the CPU.

* A 12-step run with ``--ckpt-every 4`` (safe points after steps 3, 7 and
  11), resumed from step 7 through ``--resume DIR`` (the newest complete
  safe point named by step), gives the uninterrupted run's losses for
  steps 8-11 and its final params and moments bitwise.
* The CPU elastic configuration (``--layers 8 --d-model 128 --stages 4
  --num-micro 4 --seq 32 --rebalance-every 5 --dynamism pruning
  --repack``, 20 steps, ``--ckpt-every 8``): resumed from step 7 (4
  buffers) it prunes at 10, shrinks 4 -> 2 at 14 on its own decision and
  equals the uninterrupted run; resumed from step 15 (the 2-buffer world
  after the shrink) it equals it too — tails bitwise, the same resizes and
  the same pool log.
* After a ``--grow-back`` run grows back, a safe point written after the
  grow carries ``repack_enabled: false`` and resumes with repack latched
  off (no second shrink), bitwise.
* Held to the reference: the reference's ``Session.resume`` and the port
  resume the same ``--grow-back`` run from its 2-buffer safe point (step
  15) with losses within 1e-4 and the same (empty) resizes — neither grows
  back, since the engine's last shrink step is not in a safe point (a gap
  both share, ROADMAP Queue 3), while both uninterrupted runs grow at 20.
* Across ranks, on the elastic configuration: ``--procs 4`` writes safe
  points whose arrays and index are the one process's (each rank its own
  stage's shard, rank 0 also ``common.npz``; after the shrink ranks 2 and
  3 write nothing); ``--resume`` of the one-process safe points with
  ``--procs 4`` (from 15: the 2-buffer world, ranks 2 and 3 released and
  reading nothing; from 7) and of a rank-written one (15) in one process
  equal the uninterrupted run's tails bitwise, each rank reading
  ``common.npz`` and its own shard only.  A 2 x 2 (data x model) mesh's
  safe point and resumed tail are within 1e-6 of one process's (the
  replicas' gradient sums add in another order than one process's whole
  microbatch, ``test_torch_dist_elastic.py``).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.launch.train import run

torch.set_num_threads(1)
SMALL = ["--layers", "4", "--d-model", "64", "--num-heads", "4",
         "--num-kv-heads", "2", "--d-ff", "256", "--vocab-size", "256",
         "--stages", "2", "--num-micro", "2", "--mb-global", "2", "--seq",
         "16", "--steps", "12", "--dynamism", "pruning", "--rebalance-every",
         "5", "--straggler", "1:2.0", "--log-every", "100", "--device", "cpu"]
ELASTIC = ["--layers", "8", "--d-model", "128", "--stages", "4",
           "--num-micro", "4", "--mb-global", "2", "--seq", "32",
           "--rebalance-every", "5", "--dynamism", "pruning", "--repack",
           "--steps", "20", "--seed", "0", "--log-every", "100"]
PORT_WIDTHS = ["--num-heads", "4", "--num-kv-heads", "2", "--d-ff", "256",
               "--vocab-size", "512"]
REF_WIDTHS = ["--model.num_heads", "4", "--model.num_kv_heads", "2",
              "--model.d_ff", "256", "--model.vocab_size", "512"]


def _resizes(rep):
    return [(r["kind"], r["step"], r["from_stages"], r["to_stages"],
             r["workers"]) for r in rep["resizes"]]


def _bitwise(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _bitwise(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.numpy().tobytes() == b.numpy().tobytes()


def test_resume_from_the_middle_is_bitwise(tmp_path):
    ck = str(tmp_path / "ck")
    full = run(SMALL + ["--ckpt-dir", ck, "--ckpt-every", "4"])
    assert sorted(os.listdir(ck)) == ["step_00000003", "step_00000007",
                                      "step_00000011"]
    assert full["safepoints"] == [os.path.join(ck, f"step_{s:08d}")
                                  for s in (3, 7, 11)]
    assert len(full["timing"]["safepoint_s"]) == 3
    # the flags come from the safe point: only --device is taken
    rep = run(["--resume", ck, "--device", "cpu", "--steps", "99"],
              resume_step=7)
    assert rep["start_step"] == 8 and rep["resumed_from"] == 7
    assert rep["spec"] == full["spec"] and rep["spec"]["steps"] == 12
    assert rep["spec"]["ckpt_dir"] == ck
    assert rep["losses"] == full["losses"][8:]
    assert rep["gnorms"] == full["gnorms"][8:]
    assert [(e.iteration, e.moved_layers) for e in rep["events"]] == [
        (e.iteration, e.moved_layers) for e in full["events"]
        if e.iteration > 8]
    _bitwise(rep["params"], full["params"])
    _bitwise(rep["opt_state"], full["opt_state"])
    _bitwise(rep["dyn"], full["dyn"])
    assert rep["timing"]["restore_s"] > 0
    # the resumed run rewrote the step-11 safe point with the same shards
    # and the same RunSpec
    with open(os.path.join(ck, "step_00000011", "index.json")) as fh:
        assert json.load(fh)["meta"]["spec"] == full["spec"]


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("elastic") / "ck")
    full = run(ELASTIC + PORT_WIDTHS + ["--device", "cpu", "--ckpt-dir", ck,
                                        "--ckpt-every", "8"])
    return ck, full


@pytest.mark.parametrize("at,stages", [(15, 2), (7, 4)])
def test_elastic_resume_is_bitwise(elastic, at, stages):
    """Run (b), the 2-buffer world, before (a): a run resumed from 7
    rewrites step 15's safe point (with the same shards)."""
    ck, full = elastic
    assert _resizes(full) == [("shrink", 14, 4, 2, [2, 3])]
    with open(os.path.join(ck, f"step_{at:08d}", "index.json")) as fh:
        idx = json.load(fh)
    assert idx["num_stages"] == stages
    assert idx["meta"]["stage_workers"] == list(range(stages))
    rep = run(["--device", "cpu"], resume=ck, resume_step=at)
    assert rep["start_step"] == at + 1
    assert rep["losses"] == full["losses"][at + 1:]
    assert rep["stages_history"] == full["stages_history"][at + 1:]
    assert _resizes(rep) == [r for r in _resizes(full) if r[1] > at]
    assert rep["pool_log"] == full["pool_log"] == ["release:2", "release:3"]
    assert rep["final_lps"] == full["final_lps"]
    _bitwise(rep["params"], full["params"])
    _bitwise(rep["opt_state"], full["opt_state"])


def test_resume_after_grow_keeps_repack_latched_off(tmp_path):
    ck = str(tmp_path / "ck")
    flags = [f for f in ELASTIC if f not in ("20",)]
    flags[flags.index("--steps") + 1:flags.index("--steps") + 1] = ["26"]
    with pytest.warns(DeprecationWarning, match="grow-back"):
        full = run(flags + PORT_WIDTHS + ["--device", "cpu", "--grow-back",
                                          "6", "--ckpt-dir", ck,
                                          "--ckpt-every", "11"])
    assert [r[:4] for r in _resizes(full)] == [("shrink", 14, 4, 2),
                                               ("grow", 20, 2, 4)]
    with open(os.path.join(ck, "step_00000021", "index.json")) as fh:
        meta = json.load(fh)["meta"]
    assert meta["repack_enabled"] is False
    assert meta["stage_workers"] == [0, 1, 2, 3]
    assert meta["pool"]["log"] == ["release:2", "release:3", "grant:2",
                                   "grant:3"]
    with open(os.path.join(ck, "step_00000010", "index.json")) as fh:
        assert json.load(fh)["meta"]["repack_enabled"] is True
    with pytest.warns(DeprecationWarning, match="grow-back"):
        rep = run(["--device", "cpu"], resume=ck, resume_step=21)
    assert rep["losses"] == full["losses"][22:]
    assert rep["resizes"] == [] and rep["final_stages"] == 4
    assert rep["pool_log"] == full["pool_log"]


def _reference_resume(argv, ckpt, at, tmp_path):
    """The reference CLI's Session on ``argv`` with safe points under
    ``ckpt``, then ``Session.resume(ckpt, step=at)``, in a 4-device
    subprocess; returns (report summaries, initial params)."""
    pytest.importorskip("jax")
    from conftest import run_in_subprocess
    npz = os.path.join(str(tmp_path), "init.npz")
    out = run_in_subprocess(f"""
import argparse, json, warnings
import numpy as np
import jax
from repro.api.cli import (TRAIN_ALIASES, TRAIN_CLI_DEFAULTS,
                           add_alias_flags, add_config_args, add_spec_flags,
                           build_spec)
from repro.api.session import Session
from repro.models import model as JM

warnings.simplefilter("ignore", DeprecationWarning)
ap = argparse.ArgumentParser()
add_config_args(ap)
add_alias_flags(ap, TRAIN_ALIASES)
add_spec_flags(ap)
spec = build_spec(ap.parse_args({argv!r}), TRAIN_ALIASES,
                  cli_defaults=TRAIN_CLI_DEFAULTS)
with Session(spec) as s:
    params = JM.init_params(jax.random.PRNGKey(spec.seed),
                            s._model_config(), s._dist_config())
    full = s.train()
flat = {{}}

def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        flat[prefix] = np.asarray(jax.device_get(tree))

put("params", params)
np.savez({npz!r}, **flat)
with Session.resume({ckpt!r}, step={at}) as s:
    rep = s.train()

def summary(r):
    return {{"losses": r["losses"], "start_step": r["start_step"],
             "resizes": [[x["kind"], x["step"], x["from_stages"],
                          x["to_stages"], x["workers"]]
                         for x in r["resizes"]],
             "final_lps": r["final_lps"]}}

print("REPORT " + json.dumps({{"full": summary(full),
                               "resumed": summary(rep)}}))
""", devices=4)
    line = [ln for ln in out.splitlines() if ln.startswith("REPORT ")][-1]
    tree = {"params": {"shared": {}}}
    with np.load(npz) as z:
        for key in z.files:
            node = tree
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return json.loads(line[7:]), tree["params"]


def test_resume_from_the_shrunk_world_matches_the_reference(tmp_path):
    from repro_torch import convert
    flags = [f for f in ELASTIC if f != "20"]
    flags[flags.index("--steps") + 1:flags.index("--steps") + 1] = ["26"]
    flags += ["--grow-back", "6", "--ckpt-every", "8"]
    want, params = _reference_resume(
        flags + REF_WIDTHS + ["--ckpt-dir", str(tmp_path / "ref")],
        str(tmp_path / "ref"), 15, tmp_path)
    ck = str(tmp_path / "port")
    with pytest.warns(DeprecationWarning, match="grow-back"):
        full = run(flags + PORT_WIDTHS + ["--device", "cpu", "--ckpt-dir",
                                          ck],
                   params=convert.to_torch(params, "cpu"))
    with pytest.warns(DeprecationWarning, match="grow-back"):
        rep = run(["--device", "cpu"], resume=ck, resume_step=15)
    # both uninterrupted runs shrink at 14 and grow back at 20 ...
    assert [list(r) for r in _resizes(full)] == want["full"]["resizes"] == [
        ["shrink", 14, 4, 2, [2, 3]], ["grow", 20, 2, 4, [2, 3]]]
    np.testing.assert_allclose(full["losses"], want["full"]["losses"],
                               rtol=0, atol=1e-4)
    # ... and both resumed runs stay on 2 buffers: the last shrink step is
    # not in the safe point
    assert rep["start_step"] == want["resumed"]["start_step"] == 16
    assert rep["resizes"] == [] and want["resumed"]["resizes"] == []
    assert rep["final_lps"] == want["resumed"]["final_lps"]
    np.testing.assert_allclose(rep["losses"], want["resumed"]["losses"],
                               rtol=0, atol=1e-4)
    assert rep["losses"][:4] == full["losses"][16:20]   # before the grow


def test_plain_checkpoints_and_flag_checks(tmp_path):
    """``--ckpt-dir`` alone writes plain checkpoints every max(10, steps //
    5) steps, which ``--resume`` refuses (they lack the control-plane
    state); ``--ckpt-every`` needs a directory (the RunSpec's own check,
    with the reference's message)."""
    ck = str(tmp_path / "plain")
    run(SMALL + ["--ckpt-dir", ck])
    assert sorted(os.listdir(ck)) == ["step_00000000", "step_00000010"]
    with pytest.raises(ValueError, match="not a safe point"):
        run(["--resume", ck, "--device", "cpu"])
    with pytest.raises(ValueError, match="ckpt_every: requires ckpt_dir"):
        run(SMALL + ["--ckpt-every", "4"])
    os.makedirs(tmp_path / "none")
    with pytest.raises(FileNotFoundError):
        run(["--device", "cpu"], resume=str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# Across ranks
# ---------------------------------------------------------------------------
def _shards(ckdir):
    """Every array of a safe point ({(file, key): (dtype, shape, bytes)})
    and its index without the checksums and the producing run's
    directory."""
    out = {}
    for f in sorted(os.listdir(ckdir)):
        if f.endswith(".npz"):
            with np.load(os.path.join(ckdir, f)) as z:
                for k in z.files:
                    out[(f, k)] = (z[k].dtype, z[k].shape, z[k].tobytes())
    with open(os.path.join(ckdir, "index.json")) as fh:
        idx = json.load(fh)
    idx.pop("sha256")
    idx["meta"]["spec"].pop("ckpt_dir")
    return out, idx


@pytest.fixture(scope="module")
def elastic_ranks(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("elastic_ranks") / "ck")
    rep = run(ELASTIC + PORT_WIDTHS + ["--device", "cpu", "--ckpt-dir", ck,
                                       "--ckpt-every", "8", "--procs", "4"])
    return ck, rep


def test_ranks_write_the_one_process_safe_points(elastic, elastic_ranks):
    ck, full = elastic
    ck4, rep = elastic_ranks
    assert rep["losses"] == full["losses"]
    assert _resizes(rep) == _resizes(full)
    assert rep["pool_log"] == full["pool_log"]
    for at in (7, 15):
        d = f"step_{at:08d}"
        a, ia = _shards(os.path.join(ck, d))
        b, ib = _shards(os.path.join(ck4, d))
        assert sorted(a) == sorted(b) and ia == ib
        assert all(a[k] == b[k] for k in a), [k for k in a if a[k] != b[k]]
    # each rank its own stage's shard, rank 0 (the world's leader) also the
    # replicated leaves; released ranks write nothing
    files = [[w["files"] for w in r["safepoint_writes"]]
             for r in rep["ranks"]]
    assert files == [[["common.npz", "stage_000.npz"]] * 2,
                     [["stage_001.npz"]] * 2, [["stage_002.npz"], []],
                     [["stage_003.npz"], []]]


@pytest.mark.parametrize("at,released", [(15, [2, 3]), (7, [])])
def test_one_process_safe_point_resumes_on_four_ranks(elastic, at,
                                                      released):
    ck, full = elastic
    rep = run(["--device", "cpu", "--procs", "4"], resume=ck,
              resume_step=at, gather=True)
    assert rep["start_step"] == at + 1
    assert rep["losses"] == full["losses"][at + 1:]
    assert rep["stages_history"] == full["stages_history"][at + 1:]
    assert _resizes(rep) == [r for r in _resizes(full) if r[1] > at]
    assert rep["pool_log"] == full["pool_log"]
    assert rep["final_lps"] == full["final_lps"]
    _bitwise(rep["params"], full["params"])
    _bitwise(rep["opt_state"], full["opt_state"])
    # each rank of the safe point's world read its own shard alone
    for r in rep["ranks"]:
        want = ([] if r["rank"] in released else
                ["common.npz", f"stage_{r['rank']:03d}.npz"])
        assert r["restore"]["files"] == want
        if r["rank"] in released:
            assert r["held_bytes"][0] == 0
    # chip_smoke.py 7f's check of a resume across ranks takes this run
    # and refuses it with a rank that read another shard, a tail that
    # differs or another final state
    smoke, want = _smoke(), _ckpt_run(ck, full)
    got = smoke.state_digests(rep["params"], rep["opt_state"])
    assert smoke.check_resume_across("resume", rep, rep["ranks"], want, at,
                                     got, released)["steps"] == 19 - at
    bad = [dict(r, restore=dict(r["restore"], files=["common.npz",
                                                     "stage_000.npz"]))
           for r in rep["ranks"]]
    with pytest.raises(AssertionError, match="rank 1 read"):
        smoke.check_resume_across("resume", rep, bad, want, at, got,
                                  released)
    with pytest.raises(AssertionError, match="differs from 4k's"):
        smoke.check_resume_across("resume", dict(rep, losses=rep[
            "losses"][:-1] + [0.0]), rep["ranks"], want, at, got, released)
    with pytest.raises(AssertionError, match="params or moments"):
        smoke.check_resume_across("resume", rep, rep["ranks"], want, at,
                                  dict(got, rest="0"), released)


def test_rank_safe_point_resumes_in_one_process(elastic, elastic_ranks):
    _, full = elastic
    ck4, _ = elastic_ranks
    rep = run(["--device", "cpu"], resume=ck4, resume_step=15)
    assert rep["losses"] == full["losses"][16:]
    assert rep["stages_history"] == full["stages_history"][16:] == [2] * 4
    assert rep["pool_log"] == full["pool_log"]
    _bitwise(rep["params"], full["params"])
    _bitwise(rep["opt_state"], full["opt_state"])


def _smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _ckpt_run(ck, full):
    """The uninterrupted run as chip_smoke.py's CKPT_RUN holds 4k's."""
    smoke = _smoke()
    return {"losses": list(full["losses"]), "pool_log": full["pool_log"],
            "stages": full["stages_history"],
            "resizes": [r[:4] for r in _resizes(full)],
            "digests": smoke.state_digests(full["params"],
                                           full["opt_state"]),
            "bytes": {d: sum(os.path.getsize(os.path.join(ck, d, f))
                             for f in os.listdir(os.path.join(ck, d)))
                      for d in os.listdir(ck)}}


def test_chip_smoke_7f_checks_refuse_a_wrong_run(elastic, elastic_ranks,
                                                 tmp_path):
    """7f holds the ranks' safe points to 4k's: these runs pass; a shard
    with one array changed, or ranks that wrote other files, fail it."""
    import shutil
    smoke = _smoke()
    ck, _ = elastic
    ck4, rep = elastic_ranks
    got = smoke.check_safepoints_across(ck, ck4, (7, 15), rep["ranks"])
    assert got == {7: 126, 15: 68}
    bad = [dict(r, safepoint_writes=[dict(w, files=["stage_000.npz"])
                                     for w in r["safepoint_writes"]])
           for r in rep["ranks"]]
    with pytest.raises(AssertionError, match="the ranks wrote"):
        smoke.check_safepoints_across(ck, ck4, (7, 15), bad)
    shutil.copytree(ck4, tmp_path / "ck")
    shard = tmp_path / "ck" / "step_00000015" / "stage_001.npz"
    with np.load(shard) as z:
        arrays = {k: z[k].copy() for k in z.files}
    key = sorted(arrays)[-1]
    arrays[key].reshape(-1)[0] += 1
    np.savez(shard, **arrays)
    with pytest.raises(AssertionError, match=f"stage_001.npz/{key}"):
        smoke.check_safepoints_across(ck, str(tmp_path / "ck"), (7, 15),
                                      rep["ranks"])


# test_torch_dist_mesh.py's 2 x 2 (data x model) flags
MESH = ["--layers", "8", "--d-model", "64", "--seq", "32", "--num-micro",
        "2", "--mb-global", "4", "--kernel-impl", "pallas", "--stages",
        "2", "--straggler", "1:4.0", "--seed", "0", "--log-every", "100",
        "--dynamism", "pruning", "--steps", "3", "--rebalance-every", "2",
        "--set", "parallel.data=2", "--ckpt-every", "2"]


def test_data_by_model_mesh_safe_point_and_resume(tmp_path):
    """The 2 x 2 mesh's safe point (after step 1) holds one process's
    arrays and resumes as 4 ranks to one process's tail: the params and
    the losses within 1e-6 (the replicas' gradient sums add in another
    order), the Adam moments within 4e-6 of each leaf's largest element
    (the first moment carries the gradients' own difference, ~1e-6 here,
    the second their squares', twice that)."""
    argv = MESH + PORT_WIDTHS + ["--device", "cpu"]
    one = run(argv + ["--ckpt-dir", str(tmp_path / "one")])
    run(argv + ["--ckpt-dir", str(tmp_path / "ranks"), "--procs", "4"])
    a, ia = _shards(str(tmp_path / "one" / "step_00000001"))
    b, ib = _shards(str(tmp_path / "ranks" / "step_00000001"))
    assert sorted(a) == sorted(b) and ia == ib
    for k, (dt, shape, raw) in a.items():
        x = np.frombuffer(raw, dt).astype(np.float64)
        y = np.frombuffer(b[k][2], b[k][0]).astype(np.float64)
        assert b[k][:2] == (dt, shape)
        tol = 4e-6 if k[1].startswith("opt/") else 1e-6
        assert np.abs(x - y).max(initial=0.0) <= \
            tol * max(np.abs(x).max(initial=0.0), 1e-30), k
    rep = run(["--device", "cpu", "--procs", "4"],
              resume=str(tmp_path / "ranks"), resume_step=1)
    assert rep["start_step"] == 2
    np.testing.assert_allclose(rep["losses"], one["losses"][2:], rtol=1e-6)
    assert [(r["stage"], r["replica"], r["restore"]["files"])
            for r in rep["ranks"]] == [
        (s, d, ["common.npz", f"stage_{s:03d}.npz"])
        for d in (0, 1) for s in (0, 1)]
