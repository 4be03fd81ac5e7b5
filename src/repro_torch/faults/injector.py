"""Chaos injection runtime, ported from ``repro.faults.injector``: fires a
``FaultPlan`` into a live run.

``ChaosInjector`` is transport for the plan only — it owns NO runtime
objects.  The ``Session`` (or a test) binds callbacks for the actions that
need privileged access (killing the manager process, SIGKILLing the
trainer, crashing a serving worker), and the injector fires them at the
scheduled steps, recording every injected fault into ``records`` (the
fault-event log the chaos CI job uploads).

Worker crashes in *training* need no callback: the injector simply stops
the worker from heartbeating (``heartbeat_workers`` filters it), and the
ordinary ``HeartbeatMonitor`` → ``Autoscaler`` → ``engine.evict`` pipeline
does the rest — chaos exercises the REAL failure path, it does not
simulate its effects.

``ChaosFileJobManager`` wraps the file RPC transport with seeded message
loss / duplication / delay: a lost request is simply never written (the
client's retry re-publishes the same sequence number), a duplicated one is
re-delivered after the server already answered (exercising server-side
dedup), a delayed one sleeps before the write.  All rolls come from one
seeded stream (``random.Random(plan.seed ^ 0x5EED)``, drawn in the
reference's order), so a chaos run is reproducible per seed and its
per-RPC loss and duplicate rolls are the reference's.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

from repro_torch.cluster.rpc import FileJobManager
from repro_torch.faults.plan import FaultEvent, FaultPlan
from repro_torch.obs.events import stamp_record


@dataclasses.dataclass
class FaultRecord:
    """One injected fault.  The dict form (``report()``) also carries the
    unified event fields — schema / source / wall and the tracing identity
    when a tracer is current; the ``step`` / ``kind`` / ``detail`` triple
    is the reference's."""
    step: int
    kind: str
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)
    obs: Dict[str, Any] = dataclasses.field(default_factory=dict)


class ChaosInjector:
    def __init__(self, plan: FaultPlan, *, start_step: int = 0,
                 resumed: bool = False):
        self.plan = plan
        self.records: List[FaultRecord] = []
        self.crashed: Set[int] = set()
        self._cbs: Dict[str, Callable] = {}
        self._fired: Set[int] = set()
        self._spike: Dict[int, float] = {}   # worker -> multiplier
        for i, e in enumerate(plan.events):
            if e.at < start_step:
                # history replay on resume: events before the restart
                # point already happened — a crashed worker stays crashed,
                # but nothing re-fires
                self._fired.add(i)
                if e.kind == "worker_crash":
                    self.crashed.add(e.target)
            if resumed and e.kind == "trainer_kill":
                # a kill fires once per run lifetime, or the resumed
                # trainer would re-kill itself at the same step forever
                self._fired.add(i)

    def bind(self, **callbacks: Callable) -> None:
        """Register action callbacks: ``kill_manager()``,
        ``respawn_manager()``, ``kill_self()``, ``crash_worker(worker,
        step)``.  Unbound actions are recorded as skipped."""
        self._cbs.update(callbacks)

    def record(self, step: int, kind: str, **detail: Any) -> None:
        obs = stamp_record({}, source="fault", kind=kind)
        self.records.append(FaultRecord(step, kind, detail, obs))

    # -- heartbeat filtering (train-side worker crash) ---------------------
    def heartbeat_workers(self, workers: Sequence[int]) -> List[int]:
        return [w for w in workers if w not in self.crashed]

    # -- straggler spikes ---------------------------------------------------
    def spike_for(self, workers: Sequence[int]) -> Optional[List[float]]:
        """Per-stage multipliers for the current worker list, or None when
        no spike is active."""
        if not self._spike:
            return None
        return [self._spike.get(w, 1.0) for w in workers]

    # -- firing -------------------------------------------------------------
    def on_step(self, step: int, *,
                workers: Sequence[int] = ()) -> List[FaultEvent]:
        """Fire every unfired event scheduled at ``step``; returns them.
        ``workers`` is the live stage→worker map (spike target resolution
        and crash-sanity checks)."""
        fired: List[FaultEvent] = []
        for i, e in enumerate(self.plan.events):
            if e.at != step or i in self._fired:
                continue
            self._fired.add(i)
            fired.append(e)
            if e.kind == "worker_crash":
                if workers and e.target not in workers:
                    self.record(step, "worker_crash_skipped",
                                worker=e.target, reason="not active")
                    continue
                self.crashed.add(e.target)
                self.record(step, "worker_crash", worker=e.target)
                cb = self._cbs.get("crash_worker")
                if cb is not None:
                    cb(e.target, step)
            elif e.kind == "straggler_spike":
                target = e.target
                if target < 0:
                    target = workers[-1] if workers else 0
                self._spike[target] = e.value
                self.record(step, "straggler_spike", worker=target,
                            mult=e.value)
            elif e.kind in ("manager_kill", "manager_respawn",
                            "trainer_kill"):
                name = {"manager_kill": "kill_manager",
                        "manager_respawn": "respawn_manager",
                        "trainer_kill": "kill_self"}[e.kind]
                cb = self._cbs.get(name)
                self.record(step, e.kind, bound=cb is not None)
                if cb is not None:
                    cb()
        return fired

    def report(self) -> List[Dict[str, Any]]:
        # flatten: legacy keys at the top level, unified fields merged in
        out = []
        for r in self.records:
            d = {"step": r.step, "kind": r.kind, "detail": dict(r.detail)}
            d.update(r.obs)
            out.append(d)
        return out


class ChaosFileJobManager(FileJobManager):
    """``FileJobManager`` with seeded RPC chaos on the transport hooks."""

    def __init__(self, root: str, plan: FaultPlan,
                 injector: Optional[ChaosInjector] = None, **kw):
        super().__init__(root, **kw)
        self._plan = plan
        self._chaos_rng = random.Random(plan.seed ^ 0x5EED)
        self._injector = injector

    def _chaos_record(self, kind: str, **detail: Any) -> None:
        if self._injector is not None:
            self._injector.record(-1, kind, **detail)

    def _send(self, req_path: str, obj: dict, attempt: int) -> None:
        if self._plan.rpc_delay_s:
            delay = self._chaos_rng.random() * self._plan.rpc_delay_s
            if delay > 0:
                time.sleep(delay)
        # loss only on the first delivery attempt: retries must converge
        # (the retry/backoff path is what the fault exercises)
        if attempt == 0 and self._chaos_rng.random() < self._plan.rpc_loss:
            self._chaos_record("rpc_loss", seq=obj.get("seq"),
                               op=obj.get("op"))
            return                       # message vanished in the network
        super()._send(req_path, obj, attempt)

    def _await(self, resp_path: str, deadline: float, attempt: int) -> dict:
        out = super()._await(resp_path, deadline, attempt)
        if self._chaos_rng.random() < self._plan.rpc_dup:
            # duplicate delivery AFTER the answer: re-publish the same
            # request; the server's seq dedup must ignore it
            seq = out.get("seq")
            if seq is not None:
                self._chaos_record("rpc_dup", seq=seq, op=out.get("op"))
                req_path = resp_path.replace("resp-", "req-")
                super()._send(req_path,
                              {"op": out.get("op"), "seq": seq}, attempt)
        return out
