"""The port's MoE slice end to end, through its CLIs, against the JAX
package's.

* Train: ``repro_torch.launch.train --device cpu`` and the reference's
  train CLI (its ``Session`` in a 2-device subprocess) run the same flags —
  reduced Mixtral-8x7B (4 layers, d_model 64, heads 4/2, d_ff 128, 4
  experts top-2, vocab 256), two stages, ``--dynamism moe --kernel-impl
  pallas``, 12 steps, a controller cadence of 3 — from the same params
  (the reference's init, handed over through ``convert``) on the same
  batches, with re-layout off on both sides (the reference's re-layout
  path crashes at its first re-layout: ROADMAP Queue 3).  The losses agree
  within 1e-4 and the measured skew and drop fraction match.  Inside the
  port, the same run with ``--dynamics.expert_relayout`` (watermark 1.01,
  min tokens 1, as ``test_moe_grouped.py`` sets them) fires re-layouts
  that move experts and gives the SAME losses, bit for bit.
* Serve: reduced Mixtral, one stage, contiguous (dense) KV, temperature 0:
  the port's serve CLI is token-identical to the reference's
  ``serve_spec("mixtral-8x7b", ...)`` Session, and its
  ``moe_dropped_mean`` agrees within 1e-6.
Both sides use ``kernel_impl="pallas"`` (the reference's Pallas kernels in
interpret mode, the port's kernels' plain versions on the CPU).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from test_torch_train_cli import reference_run  # noqa: E402

torch.set_num_threads(1)
FLAGS = ["--arch", "mixtral-8x7b", "--layers", "4", "--d-model", "64",
         "--seq", "32", "--num-micro", "2", "--mb-global", "2",
         "--kernel-impl", "pallas", "--stages", "2", "--seed", "0",
         "--log-every", "100", "--dynamism", "moe", "--steps", "12",
         "--rebalance-every", "3"]
REF_WIDTHS = ["--model.num_heads", "4", "--model.num_kv_heads", "2",
              "--model.d_ff", "128", "--model.vocab_size", "256"]
PORT_WIDTHS = ["--num-heads", "4", "--num-kv-heads", "2", "--d-ff", "128",
               "--vocab-size", "256", "--device", "cpu"]
RELAYOUT = ["--dynamics.expert_watermark", "1.01",
            "--dynamics.expert_min_tokens", "1"]


def test_moe_train_cli_matches_reference(tmp_path):
    from repro_torch.launch.train import run
    want, params = reference_run(
        FLAGS + REF_WIDTHS, tmp_path,
        keys=("expert_skew_last", "moe_dropped_last", "relayouts"))
    off = run(FLAGS + PORT_WIDTHS + RELAYOUT,
              params=convert.to_torch(params, "cpu"))
    np.testing.assert_allclose(off["losses"], want["losses"], rtol=0,
                               atol=1e-4)
    assert want["relayouts"] == [] and off["relayouts"] == []
    assert abs(off["expert_skew_last"] - want["expert_skew_last"]) < 1e-6
    assert abs(off["moe_dropped_last"] - want["moe_dropped_last"]) < 1e-6
    assert off["expert_skew_last"] >= 1.0
    assert off["expert_layout"] == [0, 1, 2, 3]
    assert "expert_map" not in off["dyn"]

    on = run(FLAGS + PORT_WIDTHS + RELAYOUT + ["--dynamics.expert_relayout"],
             params=convert.to_torch(params, "cpu"))
    assert on["losses"] == off["losses"]          # placement is bit-neutral
    assert len(on["relayouts"]) >= 1, on["relayouts"]
    assert on["relayouts"][0]["moved_experts"] > 0
    assert on["expert_skew_last"] >= 1.0
    layout = on["expert_layout"]
    assert layout == on["relayouts"][-1]["placement"] != [0, 1, 2, 3]
    em = on["dyn"]["expert_map"]
    active = on["assignment"]["tags"] != 0
    assert torch.equal(em[active], torch.tensor(
        [layout] * int(active.sum()), dtype=torch.float32))


def test_moe_serve_cli_matches_reference():
    from repro.api.session import Session
    from repro.launch.serve import serve_spec
    from repro_torch.launch.serve import run
    spec = serve_spec("mixtral-8x7b", stages=1, micro=2, mb_global=2,
                      prompt_len=8, gen=6, layers=4, d_model=64, requests=6,
                      kernel_impl="pallas")
    with Session(spec) as s:
        rep = s.serve()
        params = jax.tree.map(np.asarray, s._server.state.params)
    want = {c["rid"]: c["tokens"] for c in rep["completions"]}
    got_rep = run(["--elastic", "--arch", "mixtral-8x7b", "--layers", "4",
                   "--d-model", "64", "--stages", "1", "--micro", "2",
                   "--mb-global", "2", "--prompt-len", "8", "--gen", "6",
                   "--requests", "6", "--kernel-impl", "pallas", "--device",
                   "cpu"], params=convert.to_torch(params, "cpu"))
    got = {c["rid"]: c["tokens"] for c in got_rep["completions"]}
    assert got == want and len(got) == 6
    assert sum(len(v) for v in got.values()) > 6      # decode steps ran
    assert got_rep["kv_page_size"] == 0               # contiguous KV
    assert 0.0 <= got_rep["moe_dropped_mean"] < 1.0
    assert abs(got_rep["moe_dropped_mean"] - rep["moe_dropped_mean"]) < 1e-6
