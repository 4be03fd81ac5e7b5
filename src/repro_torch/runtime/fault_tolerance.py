"""Straggler detection and the worker pool — the parts of
``repro.runtime.fault_tolerance`` the trainer and the elastic engine use,
with the pool's state round trip that safe points store (heartbeats, spare
machines and fresh worker ids wait for ROADMAP Queue 1 [cluster])."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Set

import numpy as np


class StragglerDetector:
    """EMA of per-stage step times; exposes slowdown multipliers ≥ 1 that
    the controller multiplies into the by-time cost vector."""

    def __init__(self, num_stages: int, ema: float = 0.9):
        self.ema = ema
        self.times = np.zeros(num_stages)
        self.initialized = False

    def reset(self, num_stages: int) -> None:
        """Forget the EMAs — required after an elastic resize (the stage
        set itself changed, old per-stage times are meaningless)."""
        self.times = np.zeros(num_stages)
        self.initialized = False

    def update(self, stage_times: np.ndarray) -> None:
        stage_times = np.asarray(stage_times, dtype=np.float64)
        if stage_times.shape != self.times.shape:
            self.reset(len(stage_times))
        if not self.initialized:
            self.times = stage_times.copy()
            self.initialized = True
        else:
            self.times = self.ema * self.times + (1 - self.ema) * stage_times

    def relative_slowdown(self, expected: np.ndarray) -> np.ndarray:
        """Scale-free variant of ``slowdown``: rescales ``expected`` to the
        measured total first, so a uniform calibration error in the cost
        model (absolute seconds off by a constant factor) does not read as
        every stage straggling — only *relative* skew between stages
        survives.  This is the multiplier the controller folds into the
        balancer's time cost vector."""
        expected = np.maximum(np.asarray(expected, dtype=np.float64), 1e-12)
        if not self.initialized:
            return np.ones_like(expected)
        scale = self.times.sum() / expected.sum()
        if scale <= 0:
            return np.ones_like(expected)
        return np.maximum(1.0, self.times / (expected * scale))


@dataclasses.dataclass
class WorkerPool:
    """Job-manager facing pool: re-packing calls ``release``, failures call
    ``fail``, elastic growth calls ``request``, which grants released
    workers back.  Every transition is appended to ``log`` as
    ``"event:worker"``.  No spare machines: the reference's ``spares`` and
    ``provisioned`` are always 0 and empty here (fresh worker ids wait for
    ROADMAP Queue 1 [cluster])."""
    total: int
    active: Optional[Set[int]] = None

    def __post_init__(self):
        if self.active is None:
            self.active = set(range(self.total))
        self.released: Set[int] = set()
        self.dead: Set[int] = set()
        self._next_id = (max(self.active) + 1 if self.active
                         else self.total)
        self.log: List[str] = []

    def release(self, workers) -> None:
        for w in workers:
            if w in self.active:
                self.active.discard(w)
                self.released.add(w)
                self.log.append(f"release:{w}")

    def fail(self, worker: int) -> None:
        # a machine can die while idle too: scrub it from every live set,
        # so a later request() never re-grants a dead id
        self.active.discard(worker)
        self.released.discard(worker)
        self.dead.add(worker)
        self.log.append(f"fail:{worker}")

    def request(self, n: int) -> List[int]:
        grant = sorted(self.released)[:n]
        for w in grant:
            self.released.discard(w)
            self.active.add(w)
            self.log.append(f"grant:{w}")
        return grant

    def check_consistent(self) -> None:
        """Every worker id lives in exactly one of active / released /
        dead."""
        for a, b in (("active", "released"), ("active", "dead"),
                     ("released", "dead")):
            both = getattr(self, a) & getattr(self, b)
            if both:
                raise AssertionError(
                    f"worker(s) {sorted(both)} in both {a} and {b}")

    @property
    def num_active(self) -> int:
        return len(self.active)

    # -- persistence (trainer safe points) ------------------------------------
    def state_dict(self) -> dict:
        """The reference's keys, plus ``log`` (the reference's pool starts
        a resumed run with an empty log; here a resumed run's pool log is
        the uninterrupted run's)."""
        return {"total": self.total, "spares": 0,
                "active": sorted(self.active),
                "released": sorted(self.released),
                "dead": sorted(self.dead), "provisioned": [],
                "next_id": self._next_id, "log": list(self.log)}

    @classmethod
    def from_state(cls, sd: dict) -> "WorkerPool":
        if sd.get("spares", 0) or sd.get("provisioned"):
            raise NotImplementedError(
                "a pool with spare machines is not in repro_torch yet "
                "(ROADMAP Queue 1 [cluster])")
        pool = cls(int(sd["total"]), active=set(sd["active"]))
        pool.released = set(sd["released"])
        pool.dead = set(sd["dead"])
        pool._next_id = int(sd["next_id"])
        pool.log = list(sd.get("log", []))
        return pool
