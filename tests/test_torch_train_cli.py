"""The port's training CLI against the reference's, end to end.

``repro_torch.launch.train --device cpu`` and ``repro.launch.train`` (in a
2-device subprocess) run the same flags — reduced smollm (8 layers, d_model
64, heads 4/2, d_ff 256, vocab 256), two stages, ``--dynamism pruning
--kernel-impl pallas --steps 15 --straggler 1:2.0`` — from the same params
(the reference's init, handed over through ``convert``) on the same
batches.  The per-step losses agree within 1e-4, and the controller makes
the same decisions: the same rebalance events (iteration, layers moved)
and the same final split.  With ``--rebalance-every 5`` the first move
comes at the cadence that sees the pruned stats (iteration 15); with
``--rebalance-every 4`` it comes at iteration 12, so three steps also run
on the migrated params and moments.
"""
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from conftest import run_in_subprocess  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402

torch.set_num_threads(1)
COMMON = ["--layers", "8", "--d-model", "64", "--seq", "32", "--num-micro",
          "2", "--mb-global", "2", "--kernel-impl", "pallas", "--stages",
          "2", "--straggler", "1:2.0", "--seed", "0", "--log-every", "100"]
REF_WIDTHS = ["--model.num_heads", "4", "--model.num_kv_heads", "2",
              "--model.d_ff", "256", "--model.vocab_size", "256"]
PORT_WIDTHS = ["--num-heads", "4", "--num-kv-heads", "2", "--d-ff", "256",
               "--vocab-size", "256"]


def reference_run(argv, tmp_path, keys=()):
    """Run the reference CLI's Session on ``argv``; returns (report
    summary — losses, final split, events and the report's ``keys`` —,
    initial params as a numpy tree)."""
    npz = os.path.join(str(tmp_path), "init.npz")
    out = run_in_subprocess(f"""
import argparse, json
import numpy as np
import jax
from repro.api.cli import (TRAIN_ALIASES, TRAIN_CLI_DEFAULTS,
                           add_alias_flags, add_config_args, add_spec_flags,
                           build_spec)
from repro.api.session import Session
from repro.models import model as JM

ap = argparse.ArgumentParser()
add_config_args(ap)
add_alias_flags(ap, TRAIN_ALIASES)
add_spec_flags(ap)
spec = build_spec(ap.parse_args({argv!r}), TRAIN_ALIASES,
                  cli_defaults=TRAIN_CLI_DEFAULTS)
with Session(spec) as s:
    params = JM.init_params(jax.random.PRNGKey(spec.seed),
                            s._model_config(), s._dist_config())
    rep = s.train()
flat = {{}}

def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        flat[prefix] = np.asarray(jax.device_get(tree))

put("params", params)
np.savez({npz!r}, **flat)
print("REPORT " + json.dumps({{
    "losses": rep["losses"], "final_lps": rep["final_lps"],
    "events": [[e.iteration, e.moved_layers] for e in rep["events"]],
    **{{k: rep[k] for k in {tuple(keys)!r}}}}}))
""", devices=2)
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


@pytest.mark.parametrize("every,first_move", [(5, 15), (4, 12)])
def test_train_cli_matches_reference(tmp_path, every, first_move):
    flags = COMMON + ["--dynamism", "pruning", "--steps", "15",
                      "--rebalance-every", str(every)]
    want, params = reference_run(flags + REF_WIDTHS, tmp_path)
    rep = run(flags + PORT_WIDTHS + ["--device", "cpu"],
              params=convert.to_torch(params, "cpu"))
    np.testing.assert_allclose(rep["losses"], want["losses"], rtol=0,
                               atol=1e-4)
    got_events = [[e.iteration, e.moved_layers] for e in rep["events"]]
    assert got_events == want["events"]
    assert want["events"] and want["events"][0][0] == first_move
    assert want["events"][0][1] > 0
    assert rep["final_lps"] == want["final_lps"] != [4, 4]
    # the prune at step 10 kept the scheduled share of FFN blocks
    ff = rep["dyn"]["ff_mask"]
    active = rep["assignment"]["tags"] != 0
    assert abs(float(ff[active].mean()) - 8 / 16) < 1e-6
    assert not ff[~active].any()
