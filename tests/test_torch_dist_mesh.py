"""A 2 x 2 (data x model) mesh of ranks and the one-shot serve over four
ranks, on the CPU, against the reference on four host devices.

* training on ``--procs 4 --stages 2 --set parallel.data=2``: each data
  replica takes half of every microbatch's lanes; the losses are held to
  the reference's ``data=2`` Session within rtol 1e-5, the rebalance and
  the final split are the same, and the final params are within 1e-5 of
  the port's one-process run (the replicas' sums add in another order);
  in one process ``parallel.data=2`` runs as one replica, numerically the
  same run;
* the one-shot ``run_serving`` over four ranks (one stage each, the KV
  cache of a stage on its rank), with and without the serving-time
  rebalance cadence (its survival-curve costs keep this split; moving a
  cache's rows across ranks is ``test_torch_dist.py``'s): the tokens are
  identical to the reference's at temperature 0, on every rank;
* ``procs`` that is not ``data x stages`` raises, naming both numbers;
  the elastic server across ranks runs one rank per stage, so a 2 x 2
  mesh of ranks refuses it;
* an arch above 8e9 parameters (full-size Command R+) at data 2 reaches
  the launch, in training and in the one-shot serve: its stage rows are
  replicated over ``data`` as the reference's runtime places them (the
  reference's FSDP sharding is its AOT dry-run's alone).
"""
import json

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from conftest import run_in_subprocess  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.serve import run_serving  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from test_torch_api_session import _tree  # noqa: E402
from test_torch_train_cli import (PORT_WIDTHS, REF_WIDTHS,  # noqa: E402
                                  reference_run)

torch.set_num_threads(1)
FLAGS = ["--layers", "8", "--d-model", "64", "--seq", "32", "--num-micro",
         "2", "--mb-global", "4", "--kernel-impl", "pallas", "--stages",
         "2", "--straggler", "1:4.0", "--seed", "0", "--log-every", "100",
         "--dynamism", "pruning", "--steps", "3", "--rebalance-every", "2",
         "--set", "parallel.data=2"]
ONE_SHOT = dict(stages=4, micro=2, mb_global=2, prompt_len=8, gen=5,
                layers=4, d_model=64, seed=0)


@pytest.fixture(scope="module")
def serve_reference(tmp_path_factory):
    npz = str(tmp_path_factory.mktemp("serve") / "params.npz")
    out = run_in_subprocess(f"""
import json
import numpy as np
import jax
from repro.configs import DistConfig, get_config, reduced_config
from repro.launch.serve import run_serving
from repro.models import model as JM

kw = {ONE_SHOT!r}
cfg = reduced_config(get_config("smollm-360m"), num_layers=kw["layers"],
                     d_model=kw["d_model"], num_heads=4, num_kv_heads=2,
                     d_ff=2 * kw["d_model"], vocab_size=512)
dcfg = DistConfig(num_stages=kw["stages"], slot_slack=2, remat="none",
                  param_dtype="float32")
flat = {{}}

def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        flat[prefix] = np.asarray(jax.device_get(tree))

put("p", JM.init_params(jax.random.PRNGKey(kw["seed"]), cfg, dcfg))
np.savez({npz!r}, **flat)
out = {{}}
for every in (0, 2):
    r = run_serving("smollm-360m", rebalance_every=every, **kw)
    out[every] = {{"tokens": r["tokens"].tolist(),
                  "final_lps": list(r["final_lps"])}}
print("REPORT " + json.dumps(out))
""", devices=4)
    want = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("REPORT ")][-1][7:])
    with np.load(npz) as z:
        return want, _tree(z, "p")


def test_data_by_model_mesh_matches_reference(tmp_path):
    want, params = reference_run(FLAGS + REF_WIDTHS, tmp_path, devices=4)
    port = FLAGS + PORT_WIDTHS + ["--device", "cpu"]
    mesh = run(port + ["--procs", "4"],
               params=convert.to_torch(params, "cpu"), gather=True)
    one = run(port, params=convert.to_torch(params, "cpu"))
    np.testing.assert_allclose(mesh["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(one["losses"], want["losses"], rtol=1e-5)
    got = [[e.iteration, e.moved_layers] for e in mesh["events"]]
    assert got == want["events"] and got and got[0][1] > 0
    assert mesh["final_lps"] == want["final_lps"] == one["final_lps"]
    assert [(r["stage"], r["replica"]) for r in mesh["ranks"]] == [
        (0, 0), (1, 0), (0, 1), (1, 1)]
    for k, a in mesh["params"]["stages"].items():
        b = one["params"]["stages"][k]
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-30), k
    assert torch.equal(mesh["dyn"]["ff_mask"], one["dyn"]["ff_mask"])


@pytest.mark.parametrize("every", [0, 2])
def test_one_shot_serve_over_four_ranks_matches_reference(serve_reference,
                                                          every):
    want, params = serve_reference
    got = run_serving("smollm-360m", rebalance_every=every, device="cpu",
                      params=convert.to_torch(params, "cpu"), procs=4,
                      **ONE_SHOT)
    assert got["tokens"].tolist() == want[str(every)]["tokens"]
    assert list(got["final_lps"]) == want[str(every)]["final_lps"]
    assert [r["stage"] for r in got["ranks"]] == [0, 1, 2, 3]
    assert all(r["foreign_modules"] == [] for r in got["ranks"])


def test_procs_must_be_data_times_stages():
    from repro_torch.api.cli import (TRAIN_ALIASES, TRAIN_CLI_DEFAULTS,
                                     build_spec)
    from repro_torch.api.session import Session
    from repro_torch.launch.train import build_parser
    spec = build_spec(build_parser().parse_args(FLAGS + PORT_WIDTHS),
                      TRAIN_ALIASES, cli_defaults=TRAIN_CLI_DEFAULTS)
    with pytest.raises(ValueError, match=r"2 x 2 = 4 ranks, but procs=2"):
        Session(spec, device="cpu", procs=2)
    with pytest.raises(ValueError, match=r"2 x 4 = 8 ranks, but procs=4"):
        run_serving("smollm-360m", device="cpu", procs=4, data=2,
                    **ONE_SHOT)


def test_elastic_server_across_ranks_needs_one_rank_per_stage():
    """The elastic server across ranks runs one rank per stage (data 1):
    a 2 x 2 mesh of ranks refuses it."""
    from repro_torch.api.cli import (TRAIN_ALIASES, TRAIN_CLI_DEFAULTS,
                                     build_spec)
    from repro_torch.api.session import Session
    from repro_torch.launch.train import build_parser
    spec = build_spec(build_parser().parse_args(FLAGS + PORT_WIDTHS),
                      TRAIN_ALIASES, cli_defaults=TRAIN_CLI_DEFAULTS)
    with pytest.raises(ValueError, match=r"stages=2 must equal procs=4"):
        with Session(spec, device="cpu", procs=4) as s:
            s.serve()


class Launched(Exception):
    """Raised by a stand-in for ``launch.dist.launch``."""


@pytest.mark.parametrize("path", ["train", "serve"])
def test_arch_above_8b_at_data_2_reaches_the_launch(path, monkeypatch):
    """Full-size Command R+ (above 8e9 parameters by the port's own
    count) at data 2 x model 2: nothing refuses it before the ranks
    start (the launch is stood in for: the arch does not fit the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dist

    seen = {}

    def launch(target, nprocs, **kw):
        seen.update(target=target, nprocs=nprocs, data=kw["data"])
        raise Launched
    monkeypatch.setattr(dist, "launch", launch)
    assert get_config("command-r-plus-104b").param_count() > 8e9
    with pytest.raises(Launched):
        if path == "train":
            run(FLAGS + PORT_WIDTHS + [
                "--arch", "command-r-plus-104b", "--set", "model.layers=null",
                "--device", "cpu", "--procs", "4"])
        else:
            run_serving("command-r-plus-104b", device="cpu", procs=4,
                        data=2, **dict(ONE_SHOT, stages=2, layers=None))
    assert seen["nprocs"] == 4 and seen["data"] == 2
