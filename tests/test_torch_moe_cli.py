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
* Across ranks (one process per stage, gloo): the same training over 2
  ranks, re-layout off, within 1e-5 of the reference's losses; with
  re-layout on, bitwise the one-process run (losses, re-layouts,
  placements, params, both moments, ``expert_map``).  At data 2 x model 2
  against the reference's ``data=2`` Session within 1e-5: the auxiliary
  loss and the per-expert counts are the whole microbatch's (a
  re-layout's token count is the one process's).  ``--repack
  --grow-back`` over 4 ranks with a re-layout decided while ranks 2 and 3
  are released: bitwise one process, every rank's committed layout the
  same.  The one-shot and the elastic serve over 2 ranks, on a config
  whose capacity drops tokens: tokens and drop sums equal one process's.
Both sides use ``kernel_impl="pallas"`` (the reference's Pallas kernels in
interpret mode, the port's kernels' plain versions on the CPU); the data-2
run takes ``scan`` on both sides (the aux loss is the same either way).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, reduced_config, register  # noqa
from repro_torch.launch.sharding import leaves  # noqa: E402
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
# reduced Mixtral whose capacity drops tokens (the reduced config's
# capacity factor of 4 drops none); registered only while the runs that
# name it run (``moe_two_ranks``: a worker runs other files after this one)
DROPS = dataclasses.replace(
    reduced_config(get_config("mixtral-8x7b"), num_layers=4, d_model=64,
                   d_ff=128, vocab_size=256),
    name="mixtral-8x7b-drops", moe_capacity_factor=1.0)


@pytest.fixture(scope="module")
def moe_reference(tmp_path_factory):
    """The reference CLI's 12-step run (2 devices) and its init."""
    return reference_run(
        FLAGS + REF_WIDTHS, tmp_path_factory.mktemp("moe"),
        keys=("expert_skew_last", "moe_dropped_last", "relayouts"))


def _spec(cli, argv):
    from repro_torch.api.cli import (SERVE_ALIASES, SERVE_CLI_DEFAULTS,
                                     TRAIN_ALIASES, TRAIN_CLI_DEFAULTS,
                                     build_spec)
    if cli == "train":
        from repro_torch.launch.train import build_parser
        return build_spec(build_parser().parse_args(argv), TRAIN_ALIASES,
                          cli_defaults=TRAIN_CLI_DEFAULTS)
    from repro_torch.launch.serve import build_parser
    return build_spec(build_parser().parse_args(argv), SERVE_ALIASES,
                      cli_defaults=SERVE_CLI_DEFAULTS)


def _ranks(n, parts, data=1):
    """``_dist_targets.runs`` over ``n`` ranks: per part, (rank 0's
    result, every rank's counters)."""
    from repro_torch.launch.dist import launch
    res = launch("_dist_targets:runs", n, data=data, device="cpu",
                 kwargs=dict(parts=parts, archs=[DROPS]))
    return [(res[0][i], [r[i]["rank"] for r in res])
            for i in range(len(parts))]


def _bitwise(a, b):
    got, want = dict(leaves(a)), dict(leaves(b))
    assert sorted(got) == sorted(want)
    for path, t in want.items():
        assert torch.equal(got[path], t), path


def test_moe_train_cli_matches_reference(moe_reference):
    from repro_torch.launch.train import run
    want, params = moe_reference
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


@pytest.fixture(scope="module")
def moe_two_ranks(moe_reference):
    """The 2-rank runs of one launch — training with re-layout off and on
    (gathered, digested), the one-shot and the elastic serve of a
    config that drops tokens, re-layout with the asynchronous controller
    — and the one-process runs they are held to."""
    from repro_torch.launch.serve import run as serve_run
    from repro_torch.launch.serve import run_serving
    from repro_torch.launch.train import run
    _, params = moe_reference
    on_argv = FLAGS + PORT_WIDTHS + RELAYOUT + ["--dynamics.expert_relayout"]
    one_shot = dict(arch=DROPS.name, stages=2, micro=2, mb_global=2,
                    prompt_len=16, gen=5, layers=None, seed=0,
                    kernel_impl="pallas")
    serve_argv = ["--elastic", "--arch", DROPS.name, "--set",
                  "model.layers=null", "--stages", "2", "--micro", "2",
                  "--mb-global", "2", "--prompt-len", "16", "--gen", "6",
                  "--requests", "6", "--kernel-impl", "pallas"]
    from repro_torch.configs import base
    register(DROPS)
    try:
        off, on, shot, srv, asy = _ranks(2, [
            ("train", _spec("train", FLAGS + PORT_WIDTHS + RELAYOUT),
             dict(params=convert.to_torch(params, "cpu"))),
            ("train", _spec("train", on_argv),
             dict(params=convert.to_torch(params, "cpu"), gather=True,
                  digest=True)),
            ("one_shot", None, dict(one_shot, arch_config=DROPS)),
            ("serve", _spec("serve", serve_argv), {}),
            ("train", _spec("train", on_argv + ["--async-controller"]),
             dict(params=convert.to_torch(params, "cpu")))])
        return {"off": off, "on": on, "shot": shot, "srv": srv, "async": asy,
                "one": run(on_argv, params=convert.to_torch(params, "cpu")),
                "one_shot": run_serving(device="cpu", **one_shot),
                "one_srv": serve_run(serve_argv + ["--device", "cpu"])}
    finally:
        base._REGISTRY.pop(DROPS.name, None)


def test_moe_over_two_ranks_matches_reference_and_one_process(
        moe_reference, moe_two_ranks):
    """2 ranks, re-layout off, within 1e-5 of the reference; re-layout on,
    bitwise the one-process run (and with the undrained asynchronous
    controller, the same re-layouts on both ranks); the one-shot and the
    elastic serve over 2 ranks report the one-process tokens and drop
    sums."""
    want, _ = moe_reference
    r = moe_two_ranks
    one = r["one"]
    off = r["off"][0]["report"]
    np.testing.assert_allclose(off["losses"], want["losses"], rtol=1e-5)
    assert off["losses"] == one["losses"] and off["relayouts"] == []
    assert abs(off["expert_skew_last"] - want["expert_skew_last"]) < 1e-6
    on, on_ranks = r["on"][0]["report"], r["on"][1]
    assert on["losses"] == one["losses"]
    assert on["relayouts"] == one["relayouts"] and len(on["relayouts"]) >= 1
    assert on["moe_history"] == one["moe_history"]
    assert on["expert_layout"] == one["expert_layout"] != [0, 1, 2, 3]
    assert [x["expert_layout"] for x in on_ranks] == \
        [on["expert_layout"]] * 2
    _bitwise(on["params"], one["params"])
    _bitwise(on["opt_state"], one["opt_state"])
    assert torch.equal(on["dyn"]["expert_map"], one["dyn"]["expert_map"])
    # the serves: tokens and drop sums (nonzero) of one process
    shot, base = r["shot"][0], r["one_shot"]
    assert np.array_equal(shot["tokens"], base["tokens"])
    assert shot["moe_drop_sum"] == base["moe_drop_sum"] > 0
    got, base = r["srv"][0]["report"], r["one_srv"]
    assert {c["rid"]: c["tokens"] for c in got["completions"]} == {
        c["rid"]: c["tokens"] for c in base["completions"]}
    assert got["moe_dropped_mean"] == base["moe_dropped_mean"] > 0
    # the asynchronous controller without the drain: each rank's thread
    # decides the same re-layouts, applied at the same steps
    asy, asy_ranks = r["async"][0]["report"], r["async"][1]
    assert asy["relayouts"] and asy["losses"] == one["losses"]
    assert [x["relayouts"] for x in asy_ranks] == [asy["relayouts"]] * 2
    assert [x["applied"] for x in asy_ranks] == \
        [asy["controller"]["applied"]] * 2


def _smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def launched(ranks, per_step, steps, tc=True):
    """``ranks`` with kernel counters as the card's would read: the
    per-step counts, split evenly over the ranks (the CPU launches
    none)."""
    n = len(ranks)
    return [dict(r, launches={k: {"launches": v * steps // n,
                                  "tc": v * steps // n if tc else 0,
                                  "bwd": 0, "split": 0}
                              for k, v in per_step.items()})
            for r in ranks]


def test_chip_smoke_7h_7j_checks_refuse_a_wrong_run(moe_two_ranks):
    """7h and 7j take these runs (with the card's counters): a trade of
    K4's and K5's counts, a re-layout placement off by one, another
    rank's committed layout, a final state that differs, a rank without
    K5, other tokens or drops each fail."""
    import copy
    smoke = _smoke()
    r = moe_two_ranks
    one = r["one"]
    rep, ranks = r["on"][0]["report"], r["on"][1]
    per_step = smoke.MOE_TRAIN_LAUNCHES_PER_STEP
    steps = len(rep["losses"])
    good = launched(ranks, per_step, steps)
    want = {"losses": one["losses"], "relayouts": one["relayouts"],
            "moe_history": one["moe_history"],
            "expert_layout": one["expert_layout"],
            "digests": smoke.state_digests(one["params"], one["opt_state"])}
    got, tc = smoke.check_moe_across(rep, good, want)
    assert got["grouped_matmul"] == per_step["grouped_matmul"] * steps
    traded = launched(ranks, dict(per_step, grouped_matmul=per_step[
        "grouped_matmul_dw"], grouped_matmul_dw=per_step["grouped_matmul"]),
        steps)
    with pytest.raises(AssertionError, match="grouped_matmul launched"):
        smoke.check_moe_across(rep, traded, want)
    with pytest.raises(AssertionError, match="tensor cores|grouped"):
        smoke.check_moe_across(rep, launched(ranks, per_step, steps,
                                             tc=False), want)
    lopsided = copy.deepcopy(good)
    k5 = lopsided[0]["launches"]["grouped_matmul_dw"]["launches"]
    for key in ("launches", "tc"):
        lopsided[0]["launches"]["grouped_matmul_dw"][key] = 0
        lopsided[1]["launches"]["grouped_matmul_dw"][key] += k5
    with pytest.raises(AssertionError, match="launched nothing"):
        smoke.check_moe_across(rep, lopsided, want)
    off = copy.deepcopy(rep)
    place = off["relayouts"][-1]["placement"]
    off["relayouts"][-1]["placement"] = place[1:] + place[:1]
    with pytest.raises(AssertionError, match="re-layouts"):
        smoke.check_moe_across(off, good, want)
    drifted = copy.deepcopy(good)
    drifted[1]["expert_layout"] = [0, 1, 2, 3]
    with pytest.raises(AssertionError, match="committed layouts"):
        smoke.check_moe_across(rep, drifted, want)
    stale = copy.deepcopy(good)
    stale[1]["digest"]["rows"] = stale[0]["digest"]["rows"]
    with pytest.raises(AssertionError, match="final rows"):
        smoke.check_moe_across(rep, stale, want)
    # 7j: the elastic serve over 2 ranks against the one-process serve
    srv, srv_ranks = r["srv"][0]["report"], r["srv"][1]
    base = r["one_srv"]
    want = {"tokens": {c["rid"]: c["tokens"] for c in base["completions"]},
            "drop": base["moe_dropped_mean"], "tick_p50": 0.0}
    good = launched(srv_ranks, {"grouped_matmul": 2}, 1)
    smoke.check_moe_serve_across(srv, good, want)
    with pytest.raises(AssertionError, match="launched no K4"):
        smoke.check_moe_serve_across(srv, srv_ranks, want)
    with pytest.raises(AssertionError, match="drop"):
        smoke.check_moe_serve_across(srv, good, dict(
            want, drop=want["drop"] + 2 ** -20))
    other = copy.deepcopy(want)
    rid = sorted(other["tokens"])[0]
    other["tokens"][rid] = other["tokens"][rid][:-1]
    with pytest.raises(AssertionError, match="tokens differ"):
        smoke.check_moe_serve_across(srv, good, other)


DATA2 = [f if f != "pallas" else "scan" for f in FLAGS]
DATA2[DATA2.index("--steps") + 1] = "3"
DATA2 += ["--mb-global", "4", "--set", "parallel.data=2"]
# 4 stages of one layer; the repack shrinks 4 -> 2 after step 2, a
# re-layout is decided after step 5 while ranks 2 and 3 are released, the
# grow binds them back after step 8
GROW = ["--arch", "mixtral-8x7b", "--layers", "4", "--d-model", "64",
        "--seq", "32", "--num-micro", "4", "--mb-global", "2",
        "--kernel-impl", "pallas", "--stages", "4", "--seed", "0",
        "--log-every", "100", "--dynamism", "moe", "--steps", "9",
        "--rebalance-every", "3", "--repack", "--repack-mem-cap", "4.0",
        "--grow-back", "6", "--dynamics.expert_relayout"] + RELAYOUT


def test_moe_data_by_model_mesh_matches_reference(tmp_path):
    """data 2 x model 2 within 1e-5 of the reference's data-2 Session: the
    aux loss is the whole microbatch's; the re-layouts (their token
    counts among them) are the one process's."""
    from repro_torch.launch.train import run
    want, params = reference_run(DATA2 + REF_WIDTHS, tmp_path, devices=4)
    d2 = DATA2 + PORT_WIDTHS + RELAYOUT + ["--dynamics.expert_relayout"]
    one = run(d2, params=convert.to_torch(params, "cpu"))
    ((got, ranks),) = _ranks(4, [
        ("train", _spec("train", d2),
         dict(params=convert.to_torch(params, "cpu")))], data=2)
    mesh = got["report"]
    np.testing.assert_allclose(mesh["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(one["losses"], want["losses"], rtol=1e-5)
    assert mesh["relayouts"] == one["relayouts"] and mesh["relayouts"]
    assert mesh["moe_history"] == one["moe_history"]
    assert [(r["stage"], r["replica"]) for r in ranks] == [
        (0, 0), (1, 0), (0, 1), (1, 1)]


def test_moe_grow_back_relayout_while_released_across_ranks():
    """A re-layout decided while ranks 2 and 3 are released: every rank
    commits and records it, the run is bitwise one process's, every
    rank's committed layout is the same."""
    from repro_torch.launch.train import run
    grow = run(GROW + PORT_WIDTHS)
    ((got, ranks),) = _ranks(4, [
        ("train", _spec("train", GROW + PORT_WIDTHS), dict(gather=True))])
    rep = got["report"]
    kinds = [(r["kind"], r["step"]) for r in rep["resizes"]]
    assert kinds == [(r["kind"], r["step"]) for r in grow["resizes"]]
    assert [k for k, _ in kinds] == ["shrink", "grow"]
    (_, shrink), (_, back) = kinds
    assert any(shrink < r["step"] < back for r in rep["relayouts"]), kinds
    assert rep["losses"] == grow["losses"]
    assert rep["relayouts"] == grow["relayouts"]
    assert [r["role"] for r in ranks] == ["active"] * 4
    assert [r["expert_layout"] for r in ranks] == \
        [grow["expert_layout"]] * 4
    assert [r["relayouts"] for r in ranks] == [grow["relayouts"]] * 4
    _bitwise(rep["params"], grow["params"])
    _bitwise(rep["opt_state"], grow["opt_state"])
    _bitwise(rep["dyn"], grow["dyn"])
