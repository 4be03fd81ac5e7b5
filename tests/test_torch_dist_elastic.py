"""Resizes across ranks on the CPU: a shrink or an evict releases a column
of ranks to the job manager, a grow binds one back.

* The engine on 4 ranks (``_dist_targets.engine_scenario``: reduced
  smollm, 8 layers, 4 stages, the moves of ``test_elastic_engine.py``):
  ``resize(2)`` keeps the loss within 3e-3 (the reference test's bound) and
  a step after it trains; a 4 -> 2 -> 4 round trip gives back params, both
  Adam moments, dyn state and the step count bitwise; ``evict([1])``
  leaves workers [0, 2, 3] on ranks 0, 2 and 3 with rank 1 holding
  nothing and the dead worker not grantable; a never-seen id granted
  later binds rank 1's column.  Every loss, gradient norm and gathered
  tree is bitwise the one-process engine's through the same moves.
* The train CLI over ``--procs 4`` with the ``--repack --grow-back 6``
  flags is ``test_torch_elastic_cli.py``'s (it shares that file's
  reference run).
* ``--autoscale`` (the logical watermark clock) over a file job manager:
  the same decisions, resizes and pool log as one process, bitwise
  losses; the manager's journal holds rank 0's calls only.
* A 2 x 2 (data x model) mesh shrinking to 2 x 1 and growing back (a
  column of two ranks released and rebound): the reference's resizes and
  pool log, losses within rtol 1e-5 of the reference and 1e-6 of one
  process (the replicas' gradient sums add in another order than one
  process's whole microbatch, so the first step after the first update
  differs in its last bits, as in ``test_torch_dist_mesh.py``).
* A rank that raises while released ends the run non-zero in time.
"""
import json
import os
import time

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from _dist_targets import engine_scenario  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.elastic import _resplit_stage_tree  # noqa: E402
from repro_torch.launch.dist import launch  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from test_torch_elastic_cli import PORT_WIDTHS, _resizes  # noqa: E402
from test_torch_train import _leaves  # noqa: E402
from test_torch_train_cli import PORT_WIDTHS as W256  # noqa: E402
from test_torch_train_cli import REF_WIDTHS as R256  # noqa: E402
from test_torch_train_cli import reference_run  # noqa: E402

torch.set_num_threads(1)
AUTO = ["--layers", "8", "--d-model", "128", "--stages", "4", "--num-micro",
        "4", "--mb-global", "2", "--seq", "32", "--steps", "19",
        "--dynamism", "pruning", "--repack", "--rebalance-every", "5",
        "--log-every", "1000", "--async-controller", "--async-drain",
        "--autoscale", "--autoscale-watermark", "--set",
        "cluster.watermark_clock=logical", "--simulate-recover", "18",
        "--job-manager", "file", "--seed", "0"] + PORT_WIDTHS + [
            "--device", "cpu"]
MESH22 = ["--layers", "8", "--d-model", "64", "--seq", "32", "--num-micro",
          "2", "--mb-global", "4", "--kernel-impl", "reference", "--stages",
          "2", "--seed", "0", "--log-every", "100", "--dynamism", "pruning",
          "--steps", "6", "--rebalance-every", "2", "--repack",
          "--repack-mem-cap", "2.5", "--grow-back", "3", "--set",
          "parallel.data=2", "--set", "parallel.slot_slack=4"]


def _same_trees(a, b, what):
    for (p, x), (q, y) in zip(_leaves(a), _leaves(b), strict=True):
        assert p == q and x.shape == y.shape, (what, p, q)
        assert torch.equal(x, y), (what, p)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engine_runs():
    return launch("_dist_targets:engine_elastic", 4, device="cpu",
                  run_timeout_s=240), engine_scenario()


def test_engine_resizes_equal_one_process_bitwise(engine_runs):
    ranks, one = engine_runs
    got = ranks[0]
    assert got["losses"] == one["losses"]
    assert set(got["trees"]) == {"start", "resize2", "round_trip", "evict",
                                 "grow"}
    for name, tree in got["trees"].items():
        _same_trees(tree, one["trees"][name], name)
    assert got["pool_log"] == one["pool_log"] == ["fail:1", "grant:4"]
    assert got["epoch"] == one["epoch"] == 6
    assert all(r["foreign"] == [] for r in ranks)


def test_engine_resize_keeps_the_loss_and_trains(engine_runs):
    ranks, _ = engine_runs
    ls = ranks[0]["losses"]
    assert abs(ls["l4"] - ls["l2"]) < 3e-3
    assert np.isfinite(ls["step2"]).all() and ls["l2b"] < ls["l2"]
    # resize(2) alone runs on workers 0 and 1: ranks 2 and 3 hold nothing
    assert [r["world"]["resize2"] for r in ranks] == [
        ([0, 1], "active")] * 2 + [([0, 1], "released")] * 2
    assert [r["held"]["resize2"] > 0 for r in ranks] == [True, True,
                                                         False, False]


def test_engine_round_trip_is_bitwise(engine_runs):
    ranks, _ = engine_runs
    trees = ranks[0]["trees"]
    start, back = trees["start"], trees["round_trip"]
    lps = [2, 2, 2, 2]
    L = start["params"]["stages"]["wq"].shape[1]

    def norm(tree):       # PAD slots hold zeros after any re-split
        return _resplit_stage_tree(tree, lps, lps, L)

    _same_trees(back["params"]["stages"], norm(start["params"]["stages"]),
                "params")
    for m in ("m", "v"):
        _same_trees(back["opt"][m]["stages"],
                    norm(start["opt"][m]["stages"]), m)
    _same_trees(back["dyn"], norm(start["dyn"]), "dyn")
    assert torch.equal(back["opt"]["count"], start["opt"]["count"])
    for k in ("embed", "head", "final_norm"):
        assert torch.equal(back["params"][k], start["params"][k]), k


def test_engine_evict_and_a_never_seen_worker(engine_runs):
    ranks, _ = engine_runs
    ev, gr = ranks[0]["evict"], ranks[0]["grow"]
    assert ev == {"stage_workers": [0, 2, 3], "dead": [1], "request": []}
    assert [r["world"]["evict"] for r in ranks] == [
        ([0, 2, 3], "active"), ([0, 2, 3], "dead"), ([0, 2, 3], "active"),
        ([0, 2, 3], "active")]
    assert ranks[1]["held"]["evict"] == 0
    assert all(r["held"]["evict"] > 0 for i, r in enumerate(ranks) if i != 1)
    # the fresh id 4 takes the free column, rank 1's; the ring runs over
    # ranks 0, 2, 3, 1 in stage order
    assert gr == {"stage_workers": [0, 2, 3, 4], "column": 1}
    assert [r["world"]["grow"] for r in ranks] == [([0, 2, 3, 1],
                                                    "active")] * 4
    assert len({r["held"]["grow"] for r in ranks}) == 1


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------
def test_a_released_rank_that_raises_fails_the_run():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 3 fails while released"):
        launch("_dist_targets:fail_released", 4, device="cpu", timeout_s=60,
               run_timeout_s=120)
    assert time.perf_counter() - t0 < 120


# ---------------------------------------------------------------------------
# the autoscaler and the file job manager
# ---------------------------------------------------------------------------
def test_autoscale_over_a_file_manager_equals_one_process(tmp_path):
    d_across, d_one = tmp_path / "across", tmp_path / "one"
    across = run(AUTO + ["--procs", "4", "--job-manager-dir", str(d_across)])
    one = run(AUTO + ["--job-manager-dir", str(d_one)])
    assert _resizes(across["resizes"]) == _resizes(one["resizes"])
    assert [(r[0], r[1], r[4]) for r in _resizes(across["resizes"])] == [
        ("shrink", 14, [2, 3]), ("grow", 18, [2, 3])]
    assert across["pool_log"] == one["pool_log"] == [
        "release:2", "release:3", "grant:2", "grant:3"]
    assert across["autoscale_decisions"] == one["autoscale_decisions"]
    assert across["losses"] == one["losses"]
    assert across["rpc"] == one["rpc"]
    # one client: the journal answered rank 0's calls and its farewell
    (run_dir,) = os.listdir(d_across)
    with open(d_across / run_dir / "state.json") as f:
        journal = json.load(f)
    calls = across["rpc"]["stats"]["calls"]
    assert sorted(map(int, journal["answered"])) == list(range(1, calls + 2))
    assert journal["pool"]["log"] == across["pool_log"]


# ---------------------------------------------------------------------------
# a data x model mesh
# ---------------------------------------------------------------------------
def test_two_by_two_shrinks_to_two_by_one_and_grows(tmp_path):
    want, params = reference_run(MESH22 + R256, tmp_path,
                                 keys=("resizes", "pool_log",
                                       "stages_history"), devices=4)
    port = MESH22 + W256 + ["--device", "cpu"]
    params = convert.to_torch(params, "cpu")
    with pytest.warns(DeprecationWarning):
        across = run(port + ["--procs", "4"], params=params, gather=True)
        one = run(port, params=params)
    assert [(r["kind"], r["step"], r["from_stages"], r["to_stages"],
             r["workers"]) for r in across["resizes"]] == [
        (r["kind"], r["step"], r["from_stages"], r["to_stages"],
         r["workers"]) for r in want["resizes"]] == [
        ("shrink", 1, 2, 1, [1]), ("grow", 4, 1, 2, [1])]
    assert across["pool_log"] == want["pool_log"] == one["pool_log"]
    assert across["stages_history"] == want["stages_history"]
    np.testing.assert_allclose(across["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(across["losses"], one["losses"], rtol=1e-6)
    # the losses before the first update are the same bits
    assert across["losses"][:2] == one["losses"][:2]
    # worker 1's column is ranks 1 and 3 (data-major): both released, both
    # rebound
    shrink, grow = across["resize_memory"]
    assert [(m["rank"], m["role"], m["held_bytes"] == 0)
            for m in shrink["ranks"]] == [
        (0, "active", False), (1, "released", True), (2, "active", False),
        (3, "released", True)]
    assert [m["role"] for m in grow["ranks"]] == ["active"] * 4
    for k, a in across["params"]["stages"].items():
        b = one["params"]["stages"][k]
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-30), k
