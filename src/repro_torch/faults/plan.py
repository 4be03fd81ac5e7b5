"""Deterministic fault schedules, ported from ``repro.faults.plan``.

A ``FaultPlan`` is the resolved, concrete form of ``api.specs.FaultSpec``:
a sorted list of ``FaultEvent``s keyed to trainer steps / scheduler ticks,
plus per-RPC fault probabilities for the file transport.  ``auto`` mode
derives a randomized-but-seeded schedule from the run shape, so two chaos
runs with the same ``faults.seed`` inject byte-identical fault sequences —
the property the chaos soak's parity assertions rest on.  The draws come
from the stdlib's ``random.Random(faults.seed)`` in the reference's order,
so a seed gives the reference's plan, event for event.

Event kinds:

  * ``worker_crash``   — the target worker dies silently: it stops
    heartbeating (train) / its stage's KV shard is lost (serve).
  * ``manager_kill``   — SIGKILL the file job-manager server process.
  * ``manager_respawn``— restart the server on the same directory (its
    journal restores the pool).
  * ``trainer_kill``   — SIGKILL this process at a step (after the safe
    point), to be resumed with ``Session.resume``.  Never auto-derived.
  * ``straggler_spike``— the target worker's measured stage times are
    multiplied by ``value`` from this step on (thermal-throttle model).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List

from repro_torch.api.specs import FaultSpec

KINDS = ("worker_crash", "manager_kill", "manager_respawn", "trainer_kill",
         "straggler_spike")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    at: int                       # trainer step / scheduler tick
    kind: str                     # one of KINDS
    target: int = -1              # worker id (crash / spike)
    value: float = 0.0            # multiplier (spike)

    def __post_init__(self):
        assert self.kind in KINDS, self.kind


@dataclasses.dataclass
class FaultPlan:
    """Resolved schedule + RPC fault knobs."""
    events: List[FaultEvent] = dataclasses.field(default_factory=list)
    rpc_loss: float = 0.0
    rpc_dup: float = 0.0
    rpc_delay_s: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: (e.at, e.kind))

    def at(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.at == step]

    @property
    def any_rpc(self) -> bool:
        return bool(self.rpc_loss or self.rpc_dup or self.rpc_delay_s)

    def to_dict(self) -> Dict:
        return {"seed": self.seed, "rpc_loss": self.rpc_loss,
                "rpc_dup": self.rpc_dup, "rpc_delay_s": self.rpc_delay_s,
                "events": [dataclasses.asdict(e) for e in self.events]}


def resolve_plan(fs: FaultSpec, *, horizon: int, workers: int,
                 file_manager: bool) -> FaultPlan:
    """Build the concrete plan for one run.  Explicitly pinned ``FaultSpec``
    fields always win; ``auto`` fills the unset ones from a seeded RNG so
    `--chaos --faults.auto true` exercises a fresh-but-reproducible
    schedule per seed.  ``horizon`` is the step/tick budget the schedule
    must fit inside; ``workers`` the initial worker-id range."""
    events: List[FaultEvent] = []
    rng = random.Random(fs.seed)
    crash = dict(fs.worker_crash or {})
    kill, respawn = fs.manager_kill, fs.manager_respawn
    loss, dup, delay = fs.rpc_loss, fs.rpc_dup, fs.rpc_delay_s
    spikes = dict(fs.straggler_spike or {})
    if fs.auto:
        if not crash and workers > 1 and horizon >= 8:
            # crash a non-zero worker in the middle third of the run
            at = rng.randrange(max(1, horizon // 3),
                               max(2, 2 * horizon // 3))
            crash = {at: rng.randrange(1, workers)}
        if file_manager and kill is None and horizon >= 8:
            kill = rng.randrange(max(1, horizon // 4),
                                 max(2, horizon // 2))
            if respawn is None:
                respawn = kill + max(2, horizon // 10)
        if file_manager and not (loss or dup or delay):
            loss, dup = 0.3, 0.3
        if not spikes and horizon >= 8:
            spikes = {rng.randrange(2 * horizon // 3, horizon): 2.5}
    for at, w in crash.items():
        events.append(FaultEvent(at=at, kind="worker_crash", target=w))
    if kill is not None:
        events.append(FaultEvent(at=kill, kind="manager_kill"))
    if respawn is not None:
        events.append(FaultEvent(at=respawn, kind="manager_respawn"))
    if fs.kill_at is not None:
        events.append(FaultEvent(at=fs.kill_at, kind="trainer_kill"))
    for at, mult in spikes.items():
        # target -1: the injector resolves it to the last stage's worker
        # at fire time (the stage set may have changed by then)
        events.append(FaultEvent(at=at, kind="straggler_spike",
                                 target=-1, value=float(mult)))
    return FaultPlan(events=events, rpc_loss=loss, rpc_dup=dup,
                     rpc_delay_s=delay, seed=fs.seed)
