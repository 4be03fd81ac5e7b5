"""Short training runs of the port's other dynamism kinds and remat modes.

* ``--dynamism freezing``: 12 steps against the reference's CLI from the
  same params (losses within 1e-4); the freeze at step 10 stops every
  update of the frozen layers, weight decay included.
* ``--remat block`` and ``--remat full`` recompute in the backward
  (``torch.utils.checkpoint``) and change no value: their losses equal the
  run without remat.
* ``--dynamism sparse_attention`` trains (the hash mask itself is held to
  the reference in ``test_torch_train.py``).
* ``ElasticEngine.eval_loss`` gives the first step's loss.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from test_torch_train_cli import (COMMON, PORT_WIDTHS, REF_WIDTHS,  # noqa: E402
                                  reference_run)

torch.set_num_threads(1)


def test_freezing_matches_reference_and_stops_updates(tmp_path):
    flags = COMMON + ["--dynamism", "freezing", "--steps", "12",
                      "--rebalance-every", "5"]
    want, params = reference_run(flags + REF_WIDTHS, tmp_path)
    tp = convert.to_torch(params, "cpu")
    rep = run(flags + PORT_WIDTHS + ["--device", "cpu"], params=tp)
    np.testing.assert_allclose(rep["losses"], want["losses"], rtol=0,
                               atol=1e-4)
    assert rep["final_lps"] == want["final_lps"]
    frozen = rep["dyn"]["frozen"] > 0
    assert int(frozen.sum()) == 4                  # int(8 * min(0.6, 10/12))
    # one step less: the frozen layers' params are already final
    short = run([a if a != "12" else "11" for a in flags] + PORT_WIDTHS
                + ["--device", "cpu"], params=convert.to_torch(params, "cpu"))
    for name, v in rep["params"]["stages"].items():
        assert torch.equal(v[frozen], short["params"]["stages"][name][frozen])
        assert not torch.equal(v[~frozen], short["params"]["stages"][name]
                               [~frozen]), name


def test_remat_changes_no_value():
    flags = COMMON + PORT_WIDTHS + ["--dynamism", "pruning", "--steps", "3",
                                    "--device", "cpu"]
    base = run(flags)["losses"]
    for mode in ("block", "full"):
        got = run(flags + ["--remat", mode])["losses"]
        np.testing.assert_allclose(got, base, rtol=1e-6, err_msg=mode)


def test_sparse_attention_trains():
    rep = run(COMMON + PORT_WIDTHS + ["--dynamism", "sparse_attention",
                                      "--steps", "3", "--device", "cpu"])
    assert len(rep["losses"]) == 3
    assert all(np.isfinite(rep["losses"]))
    assert rep["losses"][0] == pytest.approx(np.log(256), abs=1.0)


def test_engine_eval_loss_is_the_first_step_loss():
    """``ElasticEngine.eval_loss`` (no update) on the initial state and the
    first batch gives the loss the trainer reports for step 0."""
    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.data.loader import DataConfig, make_loader
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.pipeline.pipeline import PipelineShapes
    flags = COMMON + PORT_WIDTHS + ["--dynamism", "pruning", "--steps", "1",
                                    "--device", "cpu"]
    first = run(flags)["losses"][0]
    cfg = reduced_config(get_config("smollm-360m"), num_layers=8,
                         d_model=64, num_heads=4, num_kv_heads=2, d_ff=256,
                         vocab_size=256)
    eng = ElasticEngine(cfg, DistConfig(num_stages=2, slot_slack=2,
                                        param_dtype="float32",
                                        kernel_impl="pallas"),
                        DynamicsConfig(kind="pruning"),
                        PipelineShapes(2, 2, 32), device="cpu")
    state = eng.init_state(0, with_opt=True)
    batch = next(make_loader(cfg, DataConfig(2, 2, 32, seed=0)))
    assert float(eng.eval_loss(state, batch)) == pytest.approx(first,
                                                               rel=1e-6)
