"""The port's training CLI with live resizes, against the reference's.

``repro_torch.launch.train --device cpu`` and the reference's train CLI (a
4-device subprocess) run the flags of ``test_elastic_engine.py``'s
training-loop demo — reduced smollm (8 layers, d_model 128, heads 4/2,
d_ff 256, vocab 512), 4 stages, 4 microbatches of 2 x 32 tokens, 26 steps,
``--dynamism pruning --repack --grow-back 6 --rebalance-every 5`` — from
the same params (the reference's init, handed over through ``convert``):

* the controller's repack decision shrinks 4 -> 2 at step 14 and the
  grow-back restores 4 at step 20, with the reference's resizes (kind,
  step, stages, workers, ticks) and pool log;
* the per-step losses agree within 1e-4 through both resizes;
* ``--grow-back`` warns that it is deprecated, as the reference does;
* the same flags over ``--procs 4`` (one rank a stage): the reference's
  resizes and pool log, losses within 1e-4 of the reference and bitwise
  the one-process run (params, both moments, dyn); ranks 2 and 3 hold no
  state between the shrink at step 14 and the grow at step 20; phase 7d
  of ``chip_smoke.py`` accepts the run and refuses wrong ones.

Two shorter runs (16 steps, no grow-back) hold the other repack flags to
the reference CLI's: ``--repack-policy first_fit --repack-target 3`` (at
the default budget the controller would shrink to 2) and
``--repack-mem-cap 1.0`` (below the default 1.1 no two stages fit one
budget, so nothing shrinks).
"""
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from test_torch_train import _leaves  # noqa: E402
from test_torch_train_cli import reference_run  # noqa: E402

torch.set_num_threads(1)
FLAGS = ["--layers", "8", "--d-model", "128", "--stages", "4",
         "--num-micro", "4", "--mb-global", "2", "--seq", "32", "--steps",
         "26", "--dynamism", "pruning", "--repack", "--grow-back", "6",
         "--rebalance-every", "5", "--seed", "0", "--log-every", "100"]
REF_WIDTHS = ["--model.num_heads", "4", "--model.num_kv_heads", "2",
              "--model.d_ff", "256", "--model.vocab_size", "512"]
PORT_WIDTHS = ["--num-heads", "4", "--num-kv-heads", "2", "--d-ff", "256",
               "--vocab-size", "512"]
KEYS = ("resizes", "pool_log", "final_stages", "stages_history")


def _resizes(rz):
    return [(r["kind"], r["step"], r["from_stages"], r["to_stages"],
             r["workers"], r["ticks_before"], r["ticks_after"]) for r in rz]


@pytest.fixture(scope="module")
def grow_back(tmp_path_factory):
    """The reference's grow-back run (4 host devices), its params (numpy:
    a run trains the tensors it is handed in place) and the port's
    one-process run from them."""
    want, params = reference_run(FLAGS + REF_WIDTHS,
                                 tmp_path_factory.mktemp("ref"), keys=KEYS,
                                 devices=4)
    with pytest.warns(DeprecationWarning, match="grow-back"):
        rep = run(FLAGS + PORT_WIDTHS + ["--device", "cpu"],
                  params=convert.to_torch(params, "cpu"))
    return want, params, rep


def test_repack_grow_back_matches_reference(grow_back):
    want, _, rep = grow_back
    assert _resizes(rep["resizes"]) == _resizes(want["resizes"]) == [
        ("shrink", 14, 4, 2, [2, 3], 7, 5), ("grow", 20, 2, 4, [2, 3], 5, 7)]
    assert rep["pool_log"] == want["pool_log"] == [
        "release:2", "release:3", "grant:2", "grant:3"]
    assert rep["final_stages"] == want["final_stages"] == 4
    assert rep["stages_history"] == want["stages_history"]
    np.testing.assert_allclose(rep["losses"], want["losses"], rtol=0,
                               atol=1e-4)
    assert rep["final_lps"] == want["final_lps"]
    assert [[e.iteration, e.moved_layers] for e in rep["events"]] \
        == want["events"]
    # the run holds no memory numbers on the CPU
    assert [(m["kind"], m["allocated_before"]) for m in
            rep["resize_memory"]] == [("shrink", None), ("grow", None)]


SHORT = [f for f in FLAGS if f not in ("--grow-back", "6")]
SHORT[SHORT.index("--steps") + 1] = "16"


@pytest.mark.parametrize("extra,resizes", [
    (["--repack-policy", "first_fit", "--repack-target", "3"],
     [("shrink", 14, 4, 3, [3], 7, 6)]),
    (["--repack-mem-cap", "1.0"], [])], ids=["first_fit-target3", "cap1.0"])
def test_repack_flags_match_reference(tmp_path, extra, resizes):
    want, params = reference_run(SHORT + extra + REF_WIDTHS, tmp_path,
                                 keys=KEYS, devices=4)
    rep = run(SHORT + extra + PORT_WIDTHS + ["--device", "cpu"],
              params=convert.to_torch(params, "cpu"))
    assert _resizes(rep["resizes"]) == _resizes(want["resizes"]) == resizes
    assert rep["pool_log"] == want["pool_log"] == [
        f"release:{w}" for r in resizes for w in r[4]]
    assert rep["final_stages"] == want["final_stages"] == (
        resizes[-1][3] if resizes else 4)
    assert rep["stages_history"] == want["stages_history"]
    np.testing.assert_allclose(rep["losses"], want["losses"], rtol=0,
                               atol=1e-4)
    assert rep["final_lps"] == want["final_lps"]


# ---------------------------------------------------------------------------
# the grow-back flags over four ranks (a released rank holds nothing)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def across(grow_back):
    _, params, _ = grow_back
    with warnings.catch_warnings():
        # --grow-back warns once a process: the fixture above saw it
        warnings.simplefilter("ignore", DeprecationWarning)
        return run(FLAGS + PORT_WIDTHS + ["--device", "cpu", "--procs", "4"],
                   params=convert.to_torch(params, "cpu"), gather=True)


def _same_trees(a, b, what):
    for (p, x), (q, y) in zip(_leaves(a), _leaves(b), strict=True):
        assert p == q and x.shape == y.shape, (what, p, q)
        assert torch.equal(x, y), (what, p)


def test_grow_back_over_four_ranks(grow_back, across):
    want, _, one = grow_back
    assert _resizes(across["resizes"]) == _resizes(want["resizes"]) == [
        ("shrink", 14, 4, 2, [2, 3], 7, 5), ("grow", 20, 2, 4, [2, 3], 5, 7)]
    assert across["pool_log"] == want["pool_log"] == [
        "release:2", "release:3", "grant:2", "grant:3"]
    assert across["stages_history"] == want["stages_history"]
    np.testing.assert_allclose(across["losses"], want["losses"], rtol=0,
                               atol=1e-4)
    assert across["losses"] == one["losses"]
    assert across["gnorms"] == one["gnorms"]
    assert across["final_lps"] == one["final_lps"] == want["final_lps"]
    for tree in ("params", "opt_state", "dyn"):
        _same_trees(across[tree], one[tree], tree)


def test_released_ranks_hold_nothing(across):
    ranks = across["ranks"]
    assert [r["role"] for r in ranks] == ["active"] * 4
    assert all(r["foreign_modules"] == [] for r in ranks)
    for r in ranks:
        held = r["held_bytes"]
        assert len(held) == 26
        if r["rank"] in (2, 3):
            # released after step 14's shrink, bound back at step 20
            assert held[14:20] == [0] * 6 and min(held[:14] + held[20:]) > 0
        else:
            assert min(held) > 0
    shrink, grow = across["resize_memory"]
    assert [(m["rank"], m["role"], m["held_bytes"] == 0)
            for m in shrink["ranks"]] == [
        (0, "active", False), (1, "active", False), (2, "released", True),
        (3, "released", True)]
    # the shrink moves ranks 2 and 3's rows onto ranks 0 and 1, the grow
    # hands them back (and the replicated leaves with their moments)
    assert [m["rows_sent"] for m in shrink["ranks"]][2:] == [6, 6]
    assert sum(m["rows_recv"] for m in grow["ranks"][2:]) == 12
    assert all(m["bytes_recv"] > m["bytes_sent"] == 0
               for m in grow["ranks"][2:])


def test_chip_smoke_7d_checks_refuse_a_wrong_run(grow_back, across):
    """Phase 7d holds the ranks' run to 4h's one process: the grow-back run
    passes; a released rank still holding memory, a pool log or a loss
    that differs, a rank that launched no K3, or forward and backward
    launches trading places across ranks fails it."""
    import copy
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, _, one = grow_back
    ranks = copy.deepcopy(across["ranks"])
    for r in ranks:
        r["launches"]["pruned_matmul"].update(launches=3, bwd=2)
    want = {"losses": list(one["losses"]), "pool_log": one["pool_log"],
            "stages": one["stages_history"],
            "launches": smoke.summed_launches(ranks),
            "launches_bwd": smoke.summed_launches(ranks, "bwd"),
            "resizes": [(r["kind"], r["step"], r["from_stages"],
                         r["to_stages"], list(r["workers"]))
                        for r in one["resizes"]]}
    rep = copy.deepcopy(across)
    for m in rep["resize_memory"][0]["ranks"]:
        m["allocated_after"] = 1 << 20
    got = smoke.check_elastic_across(rep, ranks, want)
    assert got["losses_bitwise"] and got["first_differing_step"] is None
    assert got["bwd"]["pruned_matmul"] == 8
    heavy = copy.deepcopy(rep)
    heavy["resize_memory"][0]["ranks"][3]["allocated_after"] = 65 << 20
    with pytest.raises(AssertionError, match="still hold memory"):
        smoke.check_elastic_across(heavy, ranks, want)
    bad = copy.deepcopy(rep)
    bad["losses"][5] *= 1.001
    with pytest.raises(AssertionError, match="from step 5"):
        smoke.check_elastic_across(bad, ranks, want)
    bad = copy.deepcopy(rep)
    bad["pool_log"] = bad["pool_log"][:2]
    with pytest.raises(AssertionError, match="pool log"):
        smoke.check_elastic_across(bad, ranks, want)
    idle = copy.deepcopy(ranks)
    idle[2]["launches"]["pruned_matmul"]["launches"] = 0
    with pytest.raises(AssertionError):
        smoke.check_elastic_across(rep, idle, want)
    # the same total, one backward launch counted as a forward one
    traded = copy.deepcopy(ranks)
    traded[1]["launches"]["pruned_matmul"]["bwd"] = 1
    with pytest.raises(AssertionError, match="backward launches"):
        smoke.check_elastic_across(rep, traded, want)
