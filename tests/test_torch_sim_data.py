"""The port's simulator (``repro_torch.core.simulator``) and byte tokenizer
(``repro_torch.data.tokenizer``) against the reference's.

* ``simulate_pipeline`` (GPipe and 1F1B) gives the reference's makespan,
  bubble ratio and per-stage busy times exactly on random stage times, and
  ``stage_times_from_layers`` the same per-stage sums.
* ``simulate_training`` on ``tests/test_simulator.py``'s scenarios (the
  reference's cost-model layer times of each dynamism kind, static uniform
  and DynMo partition / diffusion by time, with and without re-packing)
  gives the reference's results exactly: total time, throughput, bubbles,
  imbalance history, active workers and the overhead breakdown, with the
  algorithm's wall-clock time pinned to 0 in both (it is the one input the
  two runs cannot share), so the speedups are the reference's too (the
  re-packing case with the reference's module name repaired in the test:
  its own raises, ROADMAP Queue 3).
* ``ByteTokenizer`` learns the reference's merges from the same corpus and
  gives its encodings and decodings.
"""
import types

import numpy as np
import pytest

pytest.importorskip("jax")
from repro.configs import get_config  # noqa: E402
from repro.core import simulator as ref_sim  # noqa: E402
from repro.core.cost_model import cost_vector  # noqa: E402
from repro.dynamics.config import DynamicsConfig  # noqa: E402
from repro.dynamics.trajectories import make_trajectory  # noqa: E402

from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.data import ByteTokenizer  # noqa: E402
from repro_torch.data.synthetic import synthetic_corpus  # noqa: E402


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_makespans_equal_the_references(schedule):
    rng = np.random.RandomState(0)
    for _ in range(20):
        S, m = rng.randint(1, 9), rng.randint(1, 17)
        f = rng.rand(S) + 0.1
        b = 2 * (rng.rand(S) + 0.1)
        comm = float(rng.choice([0.0, 0.05]))
        got = sim.simulate_pipeline(f, b, m, comm, schedule)
        want = ref_sim.simulate_pipeline(f, b, m, comm, schedule)
        assert got.makespan == want.makespan
        assert got.bubble_ratio == want.bubble_ratio
        np.testing.assert_array_equal(got.stage_busy, want.stage_busy)
    # the closed form the reference test pins
    r = sim.simulate_pipeline([1.0] * 4, [2.0] * 4, 8, schedule="gpipe")
    assert abs(r.makespan - 11 * 3.0) < 1e-9
    layer_f, layer_b = rng.rand(12), rng.rand(12)
    for lps in ([3, 3, 3, 3], [5, 1, 4, 2]):
        for a, w in zip(sim.stage_times_from_layers(layer_f, layer_b, lps),
                        ref_sim.stage_times_from_layers(layer_f, layer_b,
                                                        lps)):
            np.testing.assert_array_equal(a, w)


def _no_clock(monkeypatch):
    """Pin the balancer's wall-clock seconds (an overhead term) to 0."""
    frozen = types.SimpleNamespace(perf_counter=lambda: 0.0)
    monkeypatch.setattr(sim, "_time", frozen)
    monkeypatch.setattr(ref_sim, "_time", frozen)


def _scenario(kind, arch, seq):
    cfg = get_config(arch)
    dyncfg = DynamicsConfig(kind=kind, prune_start_iter=1000,
                            prune_end_iter=6000)
    traj = make_trajectory(kind, cfg, dyncfg, total_iters=8000, seed=0)
    tokens = 64 * seq
    cache = {}

    def layer_time_fn(k):
        if k not in cache:
            t = cost_vector(cfg, tokens // 8, seq, traj(k), by="time")
            cache[k] = (t / 3.0, 2 * t / 3.0)
        return cache[k]

    pbytes = cost_vector(cfg, tokens, seq, None, by="param") * 2
    return layer_time_fn, pbytes, tokens


def _same(got, want):
    for f in ("total_time", "throughput", "avg_bubble",
              "avg_active_workers", "overhead_frac", "overhead_breakdown",
              "bubble_history", "imbalance_history"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("kind,arch,seq", [
    ("early_exit", "gpt-paper-32l", 2048),
    ("freezing", "gpt-paper-32l", 2048),
    ("pruning", "gpt-paper-32l", 2048),
    ("moe", "mixtral-8x7b", 2048)])
def test_training_simulation_equals_the_references(monkeypatch, kind, arch,
                                                   seq):
    _no_clock(monkeypatch)
    layer_time_fn, pbytes, tokens = _scenario(kind, arch, seq)
    common = dict(num_stages=8, num_micro=32, tokens_per_iter=tokens,
                  iters=8000, sample_every=200)
    runs = {}
    for label, kw in (("static", dict(rebalance_every=0,
                                      balancer="uniform")),
                      ("partition", dict(rebalance_every=200,
                                         balancer="partition",
                                         max_slots=16)),
                      ("diffusion", dict(rebalance_every=200,
                                         balancer="diffusion",
                                         max_slots=16))):
        got = sim.simulate_training(layer_time_fn, pbytes,
                                    sim.TrainSimConfig(**common, **kw))
        want = ref_sim.simulate_training(
            layer_time_fn, pbytes, ref_sim.TrainSimConfig(**common, **kw))
        _same(got, want)
        runs[label] = got.throughput
    speedup = max(runs["partition"], runs["diffusion"]) / runs["static"]
    assert speedup > 1.0, (kind, speedup)


def test_repacking_simulation_equals_the_references(monkeypatch):
    """The reference's ``simulator.rp`` is the ``repro.core.repack``
    *function* (the package's ``__init__`` exports it over the module), so
    its ``repack=True`` path raises AttributeError (ROADMAP Queue 3).  The
    port's imports the module; the reference runs here with its name
    pointed at the module."""
    import importlib
    assert callable(ref_sim.rp) and not hasattr(ref_sim.rp,
                                                "repack_adjacent")
    monkeypatch.setattr(ref_sim, "rp",
                        importlib.import_module("repro.core.repack"))
    _no_clock(monkeypatch)
    layer_time_fn, pbytes, tokens = _scenario("pruning", "gpt-paper-32l",
                                              2048)
    mem = pbytes * 4.0
    kw = dict(num_stages=8, num_micro=32, tokens_per_iter=tokens,
              iters=4000, sample_every=200, rebalance_every=400,
              balancer="diffusion", max_slots=16, repack=True,
              repack_mem_cap=float(mem.sum()) / 3, layer_mem=mem,
              schedule="gpipe", comm=1e-4)
    got = sim.simulate_training(layer_time_fn, pbytes,
                                sim.TrainSimConfig(**kw))
    want = ref_sim.simulate_training(layer_time_fn, pbytes,
                                     ref_sim.TrainSimConfig(**kw))
    _same(got, want)
    assert got.avg_active_workers < 8


def test_tokenizer_equals_the_references():
    from repro.data.synthetic import synthetic_corpus as ref_corpus
    from repro.data.tokenizer import ByteTokenizer as RefTok
    text = synthetic_corpus()
    assert text == ref_corpus()
    for merges in (0, 64, 256):
        got = ByteTokenizer.train([text], num_merges=merges)
        want = RefTok.train([text], num_merges=merges)
        assert got.merges == want.merges
        assert got.vocab_size == want.vocab_size
        for s in (text[:500], "héllo wörld ✓", ""):
            for bos, eos in ((True, False), (False, True)):
                ids = got.encode(s, bos=bos, eos=eos)
                assert ids == want.encode(s, bos=bos, eos=eos)
                assert got.decode(ids) == want.decode(ids) == s
    assert ByteTokenizer().encode("ab") == [256, 97, 98]
