"""Training as four ranks (``--procs 4 --stages 4``, data 1) on the CPU,
against the reference's Session on four host devices and against the
port's own one-process run.

Reduced smollm (8 layers — two a stage, so a layer can move —, d_model
64, heads 4/2, d_ff 256, vocab 256),
four microbatches of two lanes, three steps with ``--dynamism pruning``,
a rebalance cadence every two steps under a 4x straggler on worker 1 (4,
not 3, keeps the balancer off a tie the wall clock's last bits break
either way: the decision is robust run to run): the
cadence after step 1 migrates layers between stages, so step 2 runs on
rows that crossed ranks (params, both Adam moments and dyn state).

* against the reference: the losses within rtol 1e-5, the same rebalance
  (iteration, layers moved) and the same final split;
* against one process with four stage buffers: losses, gradient norms,
  final params, Adam moments and dyn state bitwise equal;
* the migration moved rows across ranks, and each rank launched only its
  own stage's work (the launch counters are per process);
* a rank that raises mid-run ends the whole run non-zero in time.
"""
import time

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from _dist_targets import FailAt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from test_torch_train_cli import (PORT_WIDTHS, REF_WIDTHS,  # noqa: E402
                                  reference_run)

torch.set_num_threads(1)
FLAGS = ["--layers", "8", "--d-model", "64", "--seq", "32", "--num-micro",
         "4", "--mb-global", "2", "--kernel-impl", "pallas", "--stages",
         "4", "--straggler", "1:4.0", "--seed", "0", "--log-every", "100",
         "--dynamism", "pruning", "--steps", "3", "--rebalance-every", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    want, params = reference_run(FLAGS + REF_WIDTHS,
                                 tmp_path_factory.mktemp("ref"),
                                 devices=4)
    port = FLAGS + PORT_WIDTHS + ["--device", "cpu"]
    across = run(port + ["--procs", "4"],
                 params=convert.to_torch(params, "cpu"), gather=True)
    one = run(port, params=convert.to_torch(params, "cpu"))
    return want, across, one


def test_four_ranks_match_the_reference(runs):
    want, across, _ = runs
    np.testing.assert_allclose(across["losses"], want["losses"], rtol=1e-5)
    got = [[e.iteration, e.moved_layers] for e in across["events"]]
    assert got == want["events"] and got and got[0] == [2, got[0][1]]
    assert got[0][1] > 0
    assert across["final_lps"] == want["final_lps"] != [2, 2, 2, 2]


def _walk(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _walk(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def test_four_ranks_equal_one_process_bitwise(runs):
    _, across, one = runs
    assert across["losses"] == one["losses"]
    assert across["gnorms"] == one["gnorms"]
    assert across["final_lps"] == one["final_lps"]
    for tree in ("params", "opt_state", "dyn"):
        for path, a, b in _walk(across[tree], one[tree]):
            assert a.shape == b.shape and torch.equal(a, b), (tree, path)
    for k in ("tags", "depth_base", "num_active"):
        assert torch.equal(across["assignment"][k], one["assignment"][k])


def test_the_migration_crossed_ranks(runs):
    _, across, _ = runs
    ranks = across["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert [r["stage"] for r in ranks] == [0, 1, 2, 3]
    assert sum(r["comm"]["rows_sent"] for r in ranks) == \
        sum(r["comm"]["rows_recv"] for r in ranks) > 0
    assert {r["backend"] for r in ranks} == {"gloo"}
    assert all(r["foreign_modules"] == [] for r in ranks)
    # forward carries (3 steps x 4 micro) to the next stage, and the
    # backward's gradients to the previous one
    assert [r["comm"]["handoffs"] for r in ranks] == [12, 24, 24, 12]


def test_a_rank_that_raises_mid_run_fails_the_run():
    from repro_torch.api.cli import (TRAIN_ALIASES, TRAIN_CLI_DEFAULTS,
                                     build_spec)
    from repro_torch.api.session import Session
    from repro_torch.launch.train import build_parser
    args = build_parser().parse_args(FLAGS + PORT_WIDTHS)
    spec = build_spec(args, TRAIN_ALIASES, cli_defaults=TRAIN_CLI_DEFAULTS)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="fails after step 1"):
        with Session(spec, device="cpu", procs=4) as s:
            s.train(on_step=FailAt(2, 1))
    assert time.perf_counter() - t0 < 120
