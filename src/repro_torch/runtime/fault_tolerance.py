"""Heartbeats, straggler detection and the worker pool, ported from
``repro.runtime.fault_tolerance``:

1. ``HeartbeatMonitor`` — per-worker liveness with a timeout on an
   injectable clock (the trainer runs it on a step-granular one); a missed
   beat marks a worker failed and the autoscaler evicts it, a revive is
   the recovery signal it grows on.
2. ``StragglerDetector`` — per-stage step-time EMAs folded into the
   balancer's time vector as slowdown multipliers.
3. ``WorkerPool`` — the job manager's pool: re-packing releases workers,
   failures shrink it, ``request`` / ``grant`` hand workers back, and
   ``spares`` mints never-seen ids when released ones cannot meet a
   request.  Its state (with its log) rides safe points.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Set

import numpy as np


class HeartbeatMonitor:
    def __init__(self, workers: int, timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self._last = {w: clock() for w in range(workers)}
        self._lock = threading.Lock()
        self._failed: Set[int] = set()

    def beat(self, worker: int, at: Optional[float] = None) -> None:
        with self._lock:
            if worker in self._failed:
                return
            if worker not in self._last:
                # an unknown id must not silently grow the watch set — a
                # typo'd id would otherwise be tracked but never reported
                # failed for the real worker; ``revive`` is the only way to
                # (re-)register a worker after construction
                raise KeyError(
                    f"heartbeat from unregistered worker {worker!r} "
                    f"(known: {sorted(self._last)})")
            self._last[worker] = self.clock() if at is None else at

    def known_workers(self) -> Set[int]:
        with self._lock:
            return set(self._last)

    def failed_workers(self) -> Set[int]:
        now = self.clock()
        with self._lock:
            for w, t in self._last.items():
                if w not in self._failed and now - t > self.timeout:
                    self._failed.add(w)
            return set(self._failed)

    def expire(self, worker: int) -> None:
        """Mark a worker gone without waiting out the timeout — used when
        it leaves deliberately (released back to the job manager) rather
        than by crashing.  ``revive`` is the symmetric re-registration."""
        with self._lock:
            if worker in self._last:
                self._failed.add(worker)

    def revive(self, worker: int) -> None:
        with self._lock:
            self._failed.discard(worker)
            self._last[worker] = self.clock()


# decimals of a relative slowdown (``StragglerDetector.relative_slowdown``)
SLOWDOWN_DIGITS = 12


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
        balancer's time cost vector.

        The ratio is rounded to ``SLOWDOWN_DIGITS`` decimals, so it is
        scale-free to the bit: times measured at another scale (another
        wall time a step) differ from these in their last bits, and the
        balancer breaks exact ties between cuts (a 2x straggler's stage
        against two others) on those bits."""
        expected = np.maximum(np.asarray(expected, dtype=np.float64), 1e-12)
        if not self.initialized:
            return np.ones_like(expected)
        scale = self.times.sum() / expected.sum()
        if scale <= 0:
            return np.ones_like(expected)
        return np.maximum(1.0, np.round(self.times / (expected * scale),
                                        SLOWDOWN_DIGITS))


@dataclasses.dataclass
class WorkerPool:
    """Job-manager facing pool (k8s/ECK stand-in).  DynMo's re-packing calls
    ``release``; failures call ``fail``; elastic growth calls ``request``.

    ``spares`` models the cluster provisioning *fresh* machines: when a
    ``request`` cannot be met from previously released workers, up to
    ``spares`` brand-new worker ids (never seen before — a NEW process, not
    a revived one) are minted.  The engine must treat such ids as unknown
    hardware and bind a free stage-buffer slot for them."""
    total: int
    active: Optional[Set[int]] = None
    spares: int = 0

    def __post_init__(self):
        if self.active is None:
            self.active = set(range(self.total))
        self.released: Set[int] = set()
        self.dead: Set[int] = set()
        self.provisioned: Set[int] = set()
        self._next_id = (max(self.active) + 1 if self.active
                         else self.total)
        self.log: List[str] = []
        self._hooks: List[Callable[[str, int], None]] = []

    def subscribe(self, hook: Callable[[str, int], None]) -> None:
        """Register a release/acquire observer ``hook(event, worker)`` with
        event in {"release", "fail", "grant"} — the elastic engine subscribes
        to mirror pool transitions into its ``pool_events`` log."""
        self._hooks.append(hook)

    def unsubscribe(self, hook: Callable[[str, int], None]) -> None:
        """Remove a hook (engines on a shared pool must detach on close so
        the pool doesn't pin them alive)."""
        if hook in self._hooks:
            self._hooks.remove(hook)

    def _notify(self, event: str, worker: int) -> None:
        self.log.append(f"{event}:{worker}")
        for h in self._hooks:
            h(event, worker)

    def release(self, workers) -> None:
        for w in workers:
            if w in self.active:
                self.active.discard(w)
                self.released.add(w)
                self._notify("release", w)

    def fail(self, worker: int) -> None:
        # a machine can die while idle too: scrub it from *every* live set,
        # not just active, or a later request() would re-grant a dead id
        # (the double-grant bug — see check_consistent)
        self.active.discard(worker)
        self.released.discard(worker)
        self.dead.add(worker)
        self._notify("fail", worker)

    def grant(self, workers) -> List[int]:
        """Promote specific *released* worker ids back to active — the
        cluster scheduler hands a preemption victim's workers to the
        stealing tenant by id, not by count."""
        granted = []
        for w in workers:
            if w in self.released:
                self.released.discard(w)
                self.active.add(w)
                granted.append(w)
                self._notify("grant", w)
            elif w not in self.active:
                raise ValueError(f"grant of unknown/dead worker {w}")
        return granted

    def request(self, n: int, exclude=()) -> List[int]:
        grant = []
        skip = set(exclude)
        for w in sorted(self.released):
            if len(grant) == n:
                break
            if w in skip:  # reserved for another tenant's pending steal
                continue
            grant.append(w)
        for w in grant:
            self.released.discard(w)
            self.active.add(w)
            self._notify("grant", w)
        # released workers exhausted: provision fresh machines from the
        # spare budget — each arrives as a NEVER-seen worker id
        while len(grant) < n and len(self.provisioned) < self.spares:
            w = self._next_id
            self._next_id += 1
            self.provisioned.add(w)
            self.active.add(w)
            grant.append(w)
            self._notify("grant", w)
        return grant

    def check_consistent(self) -> None:
        """Every worker id lives in exactly one of active/released/dead —
        overlap means some path can hand the same machine to two owners.
        Cheap (sets are small); callers with correctness at stake run it
        after every transition."""
        for a, b in (("active", "released"), ("active", "dead"),
                     ("released", "dead")):
            both = getattr(self, a) & getattr(self, b)
            if both:
                raise AssertionError(
                    f"worker(s) {sorted(both)} in both {a} and {b}")

    @property
    def num_active(self) -> int:
        return len(self.active)

    # -- persistence (job-manager journal / trainer safe points) -----------
    def state_dict(self) -> dict:
        """The reference's keys, plus ``log`` (the reference's pool starts
        a resumed run with an empty log; here a resumed run's pool log is
        the uninterrupted run's)."""
        return {"total": self.total, "spares": self.spares,
                "active": sorted(self.active),
                "released": sorted(self.released),
                "dead": sorted(self.dead),
                "provisioned": sorted(self.provisioned),
                "next_id": self._next_id, "log": list(self.log)}

    @classmethod
    def from_state(cls, sd: dict) -> "WorkerPool":
        pool = cls(int(sd["total"]), active=set(sd["active"]),
                   spares=int(sd.get("spares", 0)))
        pool.released = set(sd["released"])
        pool.dead = set(sd["dead"])
        pool.provisioned = set(sd.get("provisioned", []))
        pool._next_id = int(sd["next_id"])
        pool.log = list(sd.get("log", []))
        return pool
