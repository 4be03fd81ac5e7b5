"""The port's fault-tolerance layer against the reference's, on the CPU.

* Fault plans: ``resolve_plan`` gives the reference's plan (``to_dict``)
  for pinned specs and, in ``auto`` mode, over drawn seeds, horizons,
  worker counts and manager kinds — both draw from the stdlib's
  ``random.Random(faults.seed)`` in the same order.
* The injector fires once, filters heartbeats, resolves spikes and keeps
  the resume semantics (the port's counterparts of the reference's
  ``test_faults.py`` unit tests), with the reference injector's records.
* The chaos RPC transport: total loss is recovered by same-seq retries,
  duplicates are deduplicated by the server, and at loss / dup 0.3 the
  port's client and the reference's, each against a port file manager,
  log the same fault records and get the same answers for the same seed
  (``random.Random(seed ^ 0x5EED)``); the manager's journal survives a
  ``kill -9`` exactly once.
* A chaos serve at the reference soak's spec (a worker crash at tick 4)
  is token-identical to the port's fault-free serve and to the
  reference's chaos serve from the same params, with the same requeues
  and resizes.
* A chaos train at the reference soak's ``TRAIN_BASE`` with a pinned plan
  (a worker crash at step 4, a 2.5x straggler spike at 14: the plan of
  ``chip_smoke.py`` phase 4r) stays within the soak's ``LOSS_TOL`` of the
  fault-free run and within 1e-4 of the reference's chaos run, with the
  same fault records and resizes.
* A trainer SIGKILLed by ``faults.kill_at`` in a child process resumes
  through ``Session.resume`` bitwise the uninterrupted run.
* Across 4 ranks (one per stage): the chaos train is bitwise the one
  process's and matches the reference as it does (the evict runs across
  the ranks, every rank's fault log is the same); the chaos serve is
  token-identical to the reference with its requeues and evict; a
  ``kill_at`` kills every rank of a launch in a child process, leaves no
  rank and no rendezvous directory, and ``Session.resume(procs=4)``
  continues bitwise.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from conftest import SRC, run_in_subprocess  # noqa: E402
from repro.api import specs as j_specs  # noqa: E402
from repro.faults import injector as j_inj  # noqa: E402
from repro.faults import plan as j_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import RunSpec, Session  # noqa: E402
from repro_torch.api import specs as t_specs  # noqa: E402
from repro_torch.cluster.rpc import (CircuitBreaker,  # noqa: E402
                                     FileJobManager, spawn_file_manager)
from repro_torch.faults import (ChaosFileJobManager,  # noqa: E402
                                ChaosInjector, FaultEvent, FaultPlan,
                                resolve_plan)
from repro_torch.runtime.fault_tolerance import WorkerPool  # noqa: E402

torch.set_num_threads(1)
LOSS_TOL = 3e-3          # the reference soak's (scripts/chaos_soak.py)


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------
def _plans(**fs):
    got = resolve_plan(t_specs.FaultSpec(**fs["spec"]), **fs["shape"])
    want = j_plan.resolve_plan(j_specs.FaultSpec(**fs["spec"]),
                               **fs["shape"])
    return got, want


PINNED = [
    dict(enabled=True, seed=3, worker_crash={5: 2}, manager_kill=4,
         manager_respawn=9, rpc_loss=0.2),
    dict(enabled=True, seed=1, worker_crash={4: 2},
         straggler_spike={14: 2.5}),
    dict(enabled=True, seed=0, kill_at=9),
    dict(enabled=True, seed=7, auto=True, worker_crash={3: 1},
         rpc_dup=0.5, rpc_delay_s=0.01),
]


@pytest.mark.parametrize("spec", PINNED, ids=range(len(PINNED)))
def test_resolve_plan_pinned_matches_reference(spec):
    got, want = _plans(spec=spec, shape=dict(horizon=20, workers=4,
                                             file_manager=True))
    assert got.to_dict() == want.to_dict()
    kinds = {(e.kind, e.at) for e in got.events}
    for at, _ in (spec.get("worker_crash") or {}).items():
        assert ("worker_crash", at) in kinds
    assert [e.at for e in got.events] == sorted(e.at for e in got.events)


@pytest.mark.parametrize("horizon,workers,file_manager", [
    (40, 4, True), (40, 4, False), (16, 4, True), (8, 2, True),
    (7, 4, True), (100, 8, True), (12, 1, True)])
def test_resolve_plan_auto_matches_reference_over_seeds(horizon, workers,
                                                        file_manager):
    seen = set()
    for seed in range(12):
        got, want = _plans(spec=dict(enabled=True, seed=seed, auto=True),
                           shape=dict(horizon=horizon, workers=workers,
                                      file_manager=file_manager))
        assert got.to_dict() == want.to_dict(), seed
        assert got.any_rpc == want.any_rpc
        seen.add(json.dumps(got.to_dict()["events"]))
    if horizon >= 8 and workers > 1:
        assert len(seen) > 1, "a new seed must move the events"


def test_injector_fires_once_and_filters_heartbeats():
    def drive(mod_plan, mod_inj):
        plan = mod_plan.FaultPlan(events=[
            mod_plan.FaultEvent(at=3, kind="worker_crash", target=2),
            mod_plan.FaultEvent(at=5, kind="straggler_spike", target=-1,
                                value=2.0),
            mod_plan.FaultEvent(at=7, kind="manager_kill")])
        inj = mod_inj.ChaosInjector(plan)
        calls = []
        inj.bind(kill_manager=lambda: calls.append("kill"))
        assert inj.on_step(0, workers=[0, 1, 2, 3]) == []
        fired = inj.on_step(3, workers=[0, 1, 2, 3])
        assert [e.kind for e in fired] == ["worker_crash"]
        assert inj.heartbeat_workers([0, 1, 2, 3]) == [0, 1, 3]
        assert inj.on_step(3, workers=[0, 1, 2, 3]) == []   # never refires
        assert inj.spike_for([0, 1, 3]) is None
        inj.on_step(5, workers=[0, 1, 3])
        assert inj.spike_for([0, 1, 3]) == [1.0, 1.0, 2.0]  # last stage
        inj.on_step(7)
        assert calls == ["kill"]
        return [(r["step"], r["kind"], r["detail"], r["schema"],
                 r["source"]) for r in inj.report()]

    got = drive(sys.modules["repro_torch.faults.plan"],
                sys.modules["repro_torch.faults.injector"])
    assert got == drive(j_plan, j_inj)
    assert [k for _, k, _, _, _ in got] == [
        "worker_crash", "straggler_spike", "manager_kill"]


def test_injector_crash_skipped_when_worker_not_active():
    inj = ChaosInjector(FaultPlan(events=[
        FaultEvent(at=1, kind="worker_crash", target=9)]))
    inj.on_step(1, workers=[0, 1, 2])
    assert [r.kind for r in inj.records] == ["worker_crash_skipped"]
    assert 9 not in inj.crashed


def test_injector_resume_semantics():
    plan = FaultPlan(events=[
        FaultEvent(at=2, kind="worker_crash", target=1),
        FaultEvent(at=6, kind="trainer_kill"),
        FaultEvent(at=8, kind="worker_crash", target=3)])
    inj = ChaosInjector(plan, start_step=7, resumed=True)
    assert inj.heartbeat_workers([0, 1, 2, 3]) == [0, 2, 3]
    died = []
    inj.bind(kill_self=lambda: died.append(1))
    assert inj.on_step(6) == [] and died == []
    assert [e.kind for e in inj.on_step(8, workers=[0, 2, 3])] \
        == ["worker_crash"]


def test_circuit_breaker_trips_probes_and_closes():
    br = CircuitBreaker(trip_after=2, probe_every=3)
    assert br.allow() and not br.open
    br.failure()
    assert br.allow() and not br.open
    br.failure()
    assert br.open and br.trips == 1
    assert [br.allow() for _ in range(6)] == [False, False, True,
                                              False, False, True]
    assert br.fast_fails == 4
    br.success()
    assert not br.open and br.allow()


# ---------------------------------------------------------------------------
# the chaos RPC transport against a port file manager
# ---------------------------------------------------------------------------
def _manager(root):
    """A port file manager, up and answering before the test's client
    sends (its probe takes sequence numbers past the test's requests)."""
    proc = spawn_file_manager(root, workers=4, idle_timeout_s=120.0)
    probe = FileJobManager(root, timeout_s=60.0)
    probe._seq = 10 ** 5
    probe._call("status")
    return proc


def _finish(jm, proc):
    jm.close()
    assert proc.wait(timeout=60) == 0


def test_rpc_retry_same_seq_recovers_total_loss(tmp_path):
    """rpc_loss 1.0 drops every FIRST delivery; the retry re-publishes the
    same sequence number and every op still succeeds exactly once."""
    root = str(tmp_path)
    proc = _manager(root)
    try:
        jm = ChaosFileJobManager(root, FaultPlan(rpc_loss=1.0, seed=0),
                                 timeout_s=30.0, poll_s=0.005, retries=60,
                                 backoff_s=0.01)
        assert jm.release([3]) == [3]
        assert jm.request(1) == [3]
        assert jm.num_active == 4
        assert jm.rpc_stats["retries"] >= 2      # one per op so far
        assert jm.breaker.trips == 0             # retries absorbed it
        _finish(jm, proc)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_rpc_dup_delivery_deduped_by_server(tmp_path):
    """rpc_dup 1.0 re-publishes every answered request; the server's seq
    journal must re-serve, never re-execute (active counts stay exact)."""
    root = str(tmp_path)
    proc = _manager(root)
    try:
        inj = ChaosInjector(FaultPlan())
        jm = ChaosFileJobManager(root, FaultPlan(rpc_dup=1.0, seed=0), inj,
                                 timeout_s=30.0, poll_s=0.005)
        assert jm.release([2]) == [2]
        assert jm.num_active == 3                # released once, not twice
        assert jm.request(4) == [2]              # only one worker to grant
        assert jm.num_active == 4
        assert [r.kind for r in inj.records] == ["rpc_dup"] * 2
        _finish(jm, proc)
        with open(os.path.join(root, "state.json")) as f:
            log = json.load(f)["pool"]["log"]
        assert log == ["release:2", "grant:2"]   # no worker twice
    finally:
        if proc.poll() is None:
            proc.kill()


def _chaos_ops(mod_faults, root, seed):
    inj = mod_faults.ChaosInjector(mod_faults.FaultPlan())
    jm = mod_faults.ChaosFileJobManager(
        root, mod_faults.FaultPlan(rpc_loss=0.3, rpc_dup=0.3, seed=seed),
        inj, timeout_s=30.0, poll_s=0.005, retries=60, backoff_s=0.01)
    answers = [jm.release([3]), jm.release([2]), jm.request(1),
               jm.num_active, jm.request(3), jm.release([1])]
    for _ in range(6):
        answers.append(jm.num_active)
    stats = dict(jm.rpc_stats)
    served = len(inj.records)           # the shutdown on close rolls too
    jm.close()
    recs = [(r.step, r.kind, r.detail) for r in inj.records]
    return answers, recs, stats, recs[:served]


@pytest.mark.parametrize("seed", [1, 2])
def test_chaos_transport_fault_records_match_reference(tmp_path, seed):
    import repro.faults as j_faults
    import repro_torch.faults as t_faults
    got = want = None
    for name, mod in (("port", t_faults), ("ref", j_faults)):
        root = str(tmp_path / name)
        os.makedirs(root)
        proc = _manager(root)
        try:
            out = _chaos_ops(mod, root, seed)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
        with open(os.path.join(root, "state.json")) as f:
            log = json.load(f)["pool"]["log"]
        assert log == ["release:3", "release:2", "grant:2", "grant:3",
                       "release:1"], log                  # exactly once
        if name == "port":
            got = out
        else:
            want = out
    assert got[0] == want[0] == [[3], [2], [2], 3, [3], [1]] + [3] * 6
    assert got[1] == want[1]
    kinds = [k for _, k, _ in got[1]]
    assert "rpc_loss" in kinds and "rpc_dup" in kinds
    # each lost request was retried under its own sequence number
    lost = [d["seq"] for _, k, d in got[3] if k == "rpc_loss"]
    assert got[2]["retries"] >= len(lost) and len(set(lost)) == len(lost)


def test_server_journal_survives_kill9_exactly_once(tmp_path):
    """Journal-before-publish: after the server is SIGKILLed and its
    response deleted (the answer lost in flight), a respawned server
    re-serves the journaled answer for the same seq without re-executing
    the op."""
    root = str(tmp_path)
    proc = spawn_file_manager(root, workers=4, idle_timeout_s=120.0)
    try:
        jm = FileJobManager(root, timeout_s=60.0, poll_s=0.005)
        assert jm.release([1]) == [1]
        proc.kill()
        proc.wait()
        os.unlink(os.path.join(root, "resp-000001.json"))
        with open(os.path.join(root, "req-000001.json"), "w") as f:
            json.dump({"op": "release", "seq": 1, "workers": [1]}, f)
        proc = spawn_file_manager(root, workers=4, idle_timeout_s=120.0)
        out = jm._await(os.path.join(root, "resp-000001.json"),
                        deadline=os.times()[4] + 1e9, attempt=1)
        assert out["released"] == [1]            # the journaled answer:
        assert out["active"] == 3                # the op ran exactly once
        assert jm.num_active == 3
        jm.close()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_worker_pool_spares_mint_fresh_ids():
    pool = WorkerPool(4, spares=2)
    pool.fail(2)
    assert pool.request(1) == [4]                # never-seen id, not 2
    assert pool.request(2) == [5]                # spare budget caps at 2
    assert pool.request(1) == []
    pool.release([4])
    assert pool.request(1) == [4]                # released beats minting
    sd = pool.state_dict()
    back = WorkerPool.from_state(sd)
    assert back.state_dict() == sd
    assert back.request(1) == []


# ---------------------------------------------------------------------------
# chaos serve and chaos train: the port against the reference
# ---------------------------------------------------------------------------
MODEL = {"arch": "smollm-360m", "layers": 8, "d_model": 64, "num_heads": 4,
         "num_kv_heads": 2, "d_ff": 256, "vocab_size": 512}
SERVE_BASE = {
    "seed": 3, "model": MODEL,
    "parallel": {"stages": 4, "num_micro": 2, "mb_global": 2, "seq": 16,
                 "remat": "none", "param_dtype": "float32"},
    "serve": {"requests": 10, "prompt_len": 16, "gen": 12, "min_prompt": 4,
              "burst_period": 6, "burst_len": 2, "burst_rate": 3,
              "lull_rate": 1},
    "cluster": {"job_manager": "inproc", "autoscale": False, "spares": 1},
}
SERVE_FAULTS = {"enabled": True, "seed": 7, "worker_crash": {4: 2}}
TRAIN_BASE = {
    "steps": 16, "seed": 5, "log_every": 4, "model": MODEL,
    "parallel": {"stages": 4, "num_micro": 2, "mb_global": 2, "seq": 32,
                 "remat": "none", "param_dtype": "float32"},
    "cluster": {"job_manager": "file", "autoscale": True,
                "heartbeat_timeout": 3.0, "rpc_timeout_s": 2.0,
                "spares": 1},
}
# chip_smoke.py phase 4r's plan: a non-zero worker crashes in the first
# third, a 2.5x straggler spike lands in the last third
TRAIN_FAULTS = {"enabled": True, "seed": 1, "worker_crash": {4: 2},
                "straggler_spike": {14: 2.5}}

REF = """
import json
import numpy as np
import jax
from repro.api import RunSpec, Session
from repro.models import model as JM

flat, out = {}, {}

def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        flat[prefix] = np.asarray(jax.device_get(tree))

spec = RunSpec.from_dict({**SERVE_BASE, "faults": SERVE_FAULTS})
with Session(spec) as s:
    put("serve", JM.init_params(jax.random.PRNGKey(spec.seed),
                                s._model_config(), s._dist_config()))
    rep = s.serve()
out["serve"] = {"tokens": {str(c["rid"]): c["tokens"]
                           for c in rep["completions"]},
                "requeues": {str(c["rid"]): c["requeues"]
                             for c in rep["completions"]},
                "requeued_total": rep["requeued_total"],
                "resizes": [[r["kind"], r["step"], r["workers"]]
                            for r in rep["resizes"]],
                "faults": [[f["step"], f["kind"], f["detail"]]
                           for f in rep["faults"]],
                "fault_plan": rep["fault_plan"]}
spec = RunSpec.from_dict({**TRAIN_BASE, "faults": TRAIN_FAULTS})
with Session(spec) as s:
    put("train", JM.init_params(jax.random.PRNGKey(spec.seed),
                                s._model_config(), s._dist_config()))
    rep = s.train()
out["train"] = {"losses": rep["losses"],
                "resizes": [[r["kind"], r["step"], r["from_stages"],
                             r["to_stages"], r["workers"]]
                            for r in rep["resizes"]],
                "faults": [[f["step"], f["kind"], f["detail"]]
                           for f in rep["faults"]],
                "fault_plan": rep["fault_plan"],
                "pool_log": rep["pool_log"],
                "decisions": rep["autoscale_decisions"]}
np.savez(NPZ, **flat)
print("REPORT " + json.dumps(out))
"""


def _tree(z, prefix):
    tree = {"shared": {}}
    for key in z.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *path, leaf = key.split("/")[1:]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = z[key]
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    npz = str(tmp_path_factory.mktemp("ref") / "params.npz")
    code = (f"NPZ = {npz!r}\nSERVE_BASE = {SERVE_BASE!r}\n"
            f"SERVE_FAULTS = {SERVE_FAULTS!r}\nTRAIN_BASE = {TRAIN_BASE!r}\n"
            f"TRAIN_FAULTS = {TRAIN_FAULTS!r}\n" + REF)
    out = run_in_subprocess(code, devices=4)
    want = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("REPORT ")][-1][7:])
    with np.load(npz) as z:
        params = {"serve": _tree(z, "serve"), "train": _tree(z, "train")}
    return want, params


def _serve(params, faults=None):
    d = dict(SERVE_BASE, **({"faults": faults} if faults else {}))
    with Session(RunSpec.from_dict(d), device="cpu",
                 params=convert.to_torch(params, "cpu")) as s:
        return s.serve()


def test_chaos_serve_token_identical_to_fault_free_and_reference(reference):
    want, params = reference
    base = _serve(params["serve"])
    chaos = _serve(params["serve"], SERVE_FAULTS)
    tok_a = {c["rid"]: c["tokens"] for c in base["completions"]}
    tok_b = {c["rid"]: c["tokens"] for c in chaos["completions"]}
    assert set(tok_b) == set(tok_a), "lost requests"
    assert tok_b == tok_a
    assert {str(k): v for k, v in tok_b.items()} == want["serve"]["tokens"]
    assert chaos["requeued_total"] == want["serve"]["requeued_total"] > 0
    assert {str(c["rid"]): c["requeues"] for c in chaos["completions"]} \
        == want["serve"]["requeues"]
    assert [[r["kind"], r["step"], r["workers"]]
            for r in chaos["resizes"]] == want["serve"]["resizes"] \
        == [["evict", 4, [2]]]
    assert [[f["step"], f["kind"], f["detail"]]
            for f in chaos["faults"]] == want["serve"]["faults"]
    assert chaos["fault_plan"] == want["serve"]["fault_plan"]
    # the emitted positions count the requeued lanes' replays as well
    assert sum(chaos["tick_tokens"]) > chaos["total_tokens"]
    assert sum(base["tick_tokens"]) == base["total_tokens"]


@pytest.fixture(scope="module")
def train_runs(reference, tmp_path_factory):
    """The port's fault-free and chaos trains at ``TRAIN_BASE`` from the
    reference's params, in one process."""
    _, params = reference
    tmp_path = tmp_path_factory.mktemp("jm")
    runs = {}
    for name, faults in (("base", None), ("chaos", TRAIN_FAULTS)):
        d = dict(TRAIN_BASE, **({"faults": faults} if faults else {}))
        d["cluster"] = dict(d["cluster"], job_manager_dir=str(tmp_path))
        with Session(RunSpec.from_dict(d), device="cpu",
                     params=convert.to_torch(params["train"], "cpu")) as s:
            runs[name] = s.train()
            runs[name + "_injector"] = s.injector
    return runs


def test_chaos_train_within_tolerance_and_matches_reference(reference,
                                                            train_runs):
    want, _ = reference
    base, chaos = train_runs["base"], train_runs["chaos"]
    assert train_runs["base_injector"] is None
    assert train_runs["chaos_injector"] is not None
    w = want["train"]
    assert len(chaos["losses"]) == TRAIN_BASE["steps"]
    diffs = [abs(a - b) for a, b in zip(base["losses"], chaos["losses"])]
    assert max(diffs) < LOSS_TOL
    np.testing.assert_allclose(chaos["losses"], w["losses"], rtol=0,
                               atol=1e-4)
    assert [[r["kind"], r["step"], r["from_stages"], r["to_stages"],
             r["workers"]] for r in chaos["resizes"]] == w["resizes"]
    assert chaos["resizes"][0]["kind"] == "evict"
    assert [[f["step"], f["kind"], f["detail"]]
            for f in chaos["faults"]] == w["faults"]
    assert [f["kind"] for f in chaos["faults"]] == ["worker_crash",
                                                    "straggler_spike"]
    assert chaos["fault_plan"] == w["fault_plan"]
    assert chaos["pool_log"] == w["pool_log"] and "fail:2" in w["pool_log"]
    assert chaos["autoscale_decisions"] == w["decisions"]
    assert base["faults"] == [] and base["fault_plan"] is None


KILL_BASE = {
    "steps": 12, "seed": 9, "log_every": 1000, "ckpt_every": 4,
    "model": MODEL,
    "parallel": {"stages": 4, "num_micro": 2, "mb_global": 2, "seq": 32,
                 "remat": "none", "param_dtype": "float32"},
}


def test_trainer_kill9_in_a_child_then_resume_bitwise(tmp_path):
    """``faults.kill_at`` SIGKILLs the trainer (a child process) two steps
    after the step-7 safe point; ``Session.resume`` continues from it and
    its losses equal the uninterrupted run's bit for bit."""
    full = dict(KILL_BASE, ckpt_dir=str(tmp_path / "full"))
    with Session(RunSpec.from_dict(full), device="cpu") as s:
        rep_full = s.train()
    doomed = dict(KILL_BASE, ckpt_dir=str(tmp_path / "killed"),
                  faults={"enabled": True, "kill_at": 9})
    code = ("import torch\n"
            "torch.set_num_threads(1)\n"
            "from repro_torch.api import RunSpec, Session\n"
            f"with Session(RunSpec.from_dict({doomed!r}), device='cpu') "
            "as s:\n"
            "    s.train()\n"
            "raise SystemExit('unreachable: kill_at did not fire')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode == -9, (proc.returncode, proc.stderr[-3000:])
    with Session.resume(str(tmp_path / "killed"), device="cpu") as s:
        rep = s.train()
    assert rep["start_step"] == 8                # the newest safe point: 7
    assert rep["losses"] == rep_full["losses"][8:]
    assert rep["fault_plan"]["events"] == [
        {"at": 9, "kind": "trainer_kill", "target": -1, "value": 0.0}]
    assert rep["faults"] == []                   # the kill never refires


@pytest.mark.parametrize("mode", ["serve", "train"])
def test_torch_chaos_soak_script_passes(tmp_path, mode):
    """``scripts/torch_chaos_soak.py`` at fault seed 1 (auto-derived
    faults) passes and writes the fault-event log."""
    out_json = tmp_path / f"chaos_{mode}.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(SRC, "..", "scripts",
                                      "torch_chaos_soak.py"),
         "--mode", mode, "--fault-seed", "1", "--device", "cpu",
         "--out", str(out_json)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1",
             "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "PASS" in proc.stdout
    log = json.loads(out_json.read_text())
    assert log["verdict"]["ok"] and log["events"]
    kinds = {e["kind"] for e in log["events"]}
    if mode == "serve":
        assert "worker_crash" in kinds
        assert log["verdict"]["requeued_total"] > 0
    else:
        assert {"worker_crash", "manager_kill", "manager_respawn"} <= kinds
        assert log["fault_plan"]["rpc_loss"] == 0.3



# ---------------------------------------------------------------------------
# across ranks
# ---------------------------------------------------------------------------
def test_chaos_train_across_ranks_is_the_one_process_run(reference,
                                                         train_runs,
                                                         tmp_path):
    want, params = reference
    d = dict(TRAIN_BASE, faults=TRAIN_FAULTS)
    d["cluster"] = dict(d["cluster"], job_manager_dir=str(tmp_path))
    with Session(RunSpec.from_dict(d), device="cpu", procs=4, gather=True,
                 params=convert.to_torch(params["train"], "cpu")) as s:
        ranks = s.train()
    one = train_runs["chaos"]
    w = want["train"]
    assert ranks["losses"] == one["losses"]
    np.testing.assert_allclose(ranks["losses"], w["losses"], rtol=0,
                               atol=1e-4)
    assert [[r["kind"], r["step"], r["from_stages"], r["to_stages"],
             r["workers"]] for r in ranks["resizes"]] == w["resizes"]
    assert [[f["step"], f["kind"], f["detail"]]
            for f in ranks["faults"]] == w["faults"]
    assert ranks["pool_log"] == w["pool_log"] == one["pool_log"]
    assert ranks["autoscale_decisions"] == w["decisions"]
    # the evict released worker 2's rank: it ends dead, holding nothing
    assert [r["role"] for r in ranks["ranks"]] == ["active", "active",
                                                   "dead", "active"]
    assert ranks["ranks"][2]["held_bytes"][-1] == 0
    # chip_smoke.py 7g's check takes this run against the one process's,
    # and refuses another fault log, pool log or final state
    smoke = _smoke()
    want = {"losses": one["losses"],
            "digests": smoke.state_digests(one["params"], one["opt_state"]),
            "chaos": {"faults": smoke.fault_log(one),
                      "pool_log": one["pool_log"],
                      "resizes": [(r["kind"], r["step"], r["from_stages"],
                                   r["to_stages"], r["workers"])
                                  for r in one["resizes"]],
                      "degraded_events": one["degraded_events"]}}
    got = smoke.state_digests(ranks["params"], ranks["opt_state"])
    kinds = ("worker_crash", "straggler_spike")
    assert smoke.check_chaos_across(ranks, ranks["ranks"], want, got,
                                    kinds)["faults"] == 2
    with pytest.raises(AssertionError, match="fault log"):
        smoke.check_chaos_across(dict(ranks, faults=ranks["faults"][:1]),
                                 ranks["ranks"], want, got, kinds)
    with pytest.raises(AssertionError, match="pool log"):
        smoke.check_chaos_across(dict(ranks, pool_log=[]), ranks["ranks"],
                                 want, got, kinds)
    with pytest.raises(AssertionError, match="final state"):
        smoke.check_chaos_across(ranks, ranks["ranks"], want,
                                 dict(got, rest="0"), kinds)
    with pytest.raises(AssertionError, match="fault kinds"):
        smoke.check_chaos_across(ranks, ranks["ranks"], want, got)


def test_chaos_serve_across_ranks_matches_reference(reference):
    want, params = reference
    d = dict(SERVE_BASE, faults=SERVE_FAULTS)
    with Session(RunSpec.from_dict(d), device="cpu", procs=4,
                 params=convert.to_torch(params["serve"], "cpu")) as s:
        rep = s.serve()
    w = want["serve"]
    assert {str(c["rid"]): c["tokens"] for c in rep["completions"]} == \
        w["tokens"]
    assert rep["requeued_total"] == w["requeued_total"] > 0
    assert {str(c["rid"]): c["requeues"] for c in rep["completions"]} == \
        w["requeues"]
    assert [[r["kind"], r["step"], r["workers"]]
            for r in rep["resizes"]] == w["resizes"] == [["evict", 4, [2]]]
    assert [[f["step"], f["kind"], f["detail"]]
            for f in rep["faults"]] == w["faults"]
    assert [r["role"] for r in rep["ranks"]] == ["active", "active",
                                                 "dead", "active"]
    # chip_smoke.py 7g's check of the crashed serve takes this run (the
    # CPU launches no K6: every rank is given launches here), and refuses
    # other tokens or a rank that launched no K6
    import copy
    smoke = _smoke()
    want = {"tokens": {c["rid"]: c["tokens"] for c in rep["completions"]},
            "requeues": {c["rid"]: c["requeues"]
                         for c in rep["completions"]},
            "requeued_total": w["requeued_total"],
            "resizes": [tuple(r) for r in w["resizes"]]}
    ranks = copy.deepcopy(rep["ranks"])
    for r in ranks:
        r["launches"]["paged_attention"].update(launches=3, split=3)
    assert smoke.check_crash_serve_across(rep, ranks, want) == 12
    bad = copy.deepcopy(rep)
    bad["completions"][0]["tokens"] = bad["completions"][0]["tokens"][:-1]
    with pytest.raises(AssertionError, match="tokens differ"):
        smoke.check_crash_serve_across(bad, ranks, want)
    ranks[2]["launches"]["paged_attention"].update(launches=0, split=0)
    with pytest.raises(AssertionError, match=r"ranks \[2\] launched none"):
        smoke.check_crash_serve_across(rep, ranks, want)


def _smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_trainer_kill9_of_four_ranks_then_resume_bitwise(tmp_path):
    """``faults.kill_at`` across 4 ranks in a child process: every rank
    SIGKILLs itself after step 9, the launch raises naming the kill (no
    rank survives, no rendezvous directory is left), and
    ``Session.resume(dir, procs=4)`` continues from the step-7 safe point
    bitwise the uninterrupted run, the kill not firing again."""
    full = dict(KILL_BASE, ckpt_dir=str(tmp_path / "full"))
    with Session(RunSpec.from_dict(full), device="cpu") as s:
        rep_full = s.train()
    doomed = dict(KILL_BASE, ckpt_dir=str(tmp_path / "killed"),
                  faults={"enabled": True, "kill_at": 9})
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    code = ("import torch\n"
            "torch.set_num_threads(1)\n"
            "from repro_torch.api import RunSpec, Session\n"
            f"with Session(RunSpec.from_dict({doomed!r}), device='cpu', "
            "procs=4) as s:\n"
            "    s.train()\n"
            "raise SystemExit('unreachable: kill_at did not fire')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": SRC,
                               "TMPDIR": str(tmp)})
    assert proc.returncode == 1, (proc.returncode, proc.stderr[-3000:])
    assert "ranks [0, 1, 2, 3] were killed by SIGKILL" in proc.stderr
    assert "unreachable" not in proc.stderr
    assert os.listdir(tmp) == []                 # the rendezvous is gone
    alive = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                argv = fh.read().split(b"\0")
        except OSError:
            continue
        if any(str(tmp).encode() in a for a in argv):
            alive.append(pid)
    assert alive == []
    with Session.resume(str(tmp_path / "killed"), device="cpu",
                        procs=4) as s:
        rep = s.train()
    assert rep["start_step"] == 8
    assert rep["losses"] == rep_full["losses"][8:]
    assert rep["faults"] == []
