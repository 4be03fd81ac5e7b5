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
* ``--grow-back`` warns that it is deprecated, as the reference does.

Two shorter runs (16 steps, no grow-back) hold the other repack flags to
the reference CLI's: ``--repack-policy first_fit --repack-target 3`` (at
the default budget the controller would shrink to 2) and
``--repack-mem-cap 1.0`` (below the default 1.1 no two stages fit one
budget, so nothing shrinks).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
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


def test_repack_grow_back_matches_reference(tmp_path):
    want, params = reference_run(FLAGS + REF_WIDTHS, tmp_path, keys=KEYS,
                                 devices=4)
    with pytest.warns(DeprecationWarning, match="grow-back"):
        rep = run(FLAGS + PORT_WIDTHS + ["--device", "cpu"],
                  params=convert.to_torch(params, "cpu"))
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
