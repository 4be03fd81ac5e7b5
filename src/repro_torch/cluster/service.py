"""The DynMo decision service (paper §3.3.1), ported from
``repro.cluster.service``.

The profile -> decide loop stays off the training critical path.
``ControlPlane`` runs ``DynMoController.decide`` on a background thread
behind a latest-wins mailbox:

  * the training thread *publishes* the host-side ``StatsSnapshot`` on
    controller cadence (a pointer swap, never a wait on the decision);
  * the worker thread folds the snapshot through the profiler, runs the
    balancer / repack decision and posts the plan into a latest-wins
    outbox;
  * the training thread *polls* the outbox at its next safe point and
    applies the plan there (a migration, or a live shrink for a
    ``ResizePlan``).

The worker thread touches only host numpy: ``apply``, which migrates the
device tensors, runs on the training thread.  Every controller access is
serialized on one lock (``_ctrl_lock``: decide vs apply, rebind,
``with_ctrl``).  Epoch fencing: every engine resize (shrink / grow /
evict) advances the world epoch, and a plan decided against an older world
is rejected at ``poll`` (or not decided at all, when the plane sees the
live epoch through ``epoch_fn``).  With ``async_mode=False`` the same
``_decide`` runs on the publishing thread, so the inline and asynchronous
paths decide bit-identically from the same snapshot; ``drain()`` blocks
until the worker has emptied the mailbox, which makes an asynchronous run
step-for-step the inline one.  A worker-thread failure is raised on the
training thread at the next ``poll`` or ``drain``.

Across ranks without the drain, ``RankControlPlane`` makes every rank apply
each plan at the same step although each rank's thread decides on its own
time: the launch's rank 0 (the timing authority) runs the plane as above,
and each other rank's thread decides the same snapshots, in the same order
and between the same controller mutations, from its own controller.  The
authority's ``poll`` names the plan to apply (the snapshot iteration and
epoch) in one small broadcast, with the decisions its thread started since
the last broadcast and the plans its outbox overwrote; a rank waits for its
own thread to finish that decision and applies its own plan, never rank
0's bytes.  Every training-thread mutation of the controller (``apply``,
``rebind``, ``with_ctrl``) is a broadcast point too, so a decision starts
between the same two mutations on every rank.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.controller import (ControllerEvent, DynMoController,
                                         ResizePlan)
from repro_torch.core.expert_layout import ExpertRelayoutPlan
from repro_torch.core.profiler import profile_from_stats


@dataclasses.dataclass
class StatsSnapshot:
    """Host-side view of one profiling iteration, tagged with the engine
    epoch it was observed in."""
    iteration: int
    epoch: int
    stats: Dict[str, np.ndarray]        # folded [S, L_max, ...] (host)
    tags: np.ndarray                    # [S, L_max] slot -> layer type
    num_micro: int
    tokens: int
    seq: int
    frozen: Optional[np.ndarray] = None
    stage_times: Optional[np.ndarray] = None   # per-stage seconds (feeds
    #   the controller's StragglerDetector when one is attached)


@dataclasses.dataclass
class DecisionPlan:
    """One controller decision, fenced by the epoch of the world it was
    decided against.  Either ``new_lps`` (in-mesh migration; None: keep the
    current split) or ``resize`` (live shrink) is set, never both;
    ``expert_relayout`` is orthogonal (it moves no stage state, only the
    expert_map dyn leaf)."""
    epoch: int
    iteration: int
    new_lps: Optional[List[int]]
    resize: Optional[ResizePlan]
    event: Optional[ControllerEvent]
    decide_s: float
    expert_relayout: Optional[ExpertRelayoutPlan] = None
    # the plan's identity across ranks: ("decide", iteration, epoch), or
    # ("inject", n) for the n-th injected resize
    key: Optional[Tuple] = None


class ControlPlane:
    """Runs the controller's decisions off the training thread with
    ``async_mode=True``, or on it (the default here: the reference defaults
    to the thread, the port's callers predate it).  A context manager:
    ``close()`` stops the worker thread."""

    def __init__(self, ctrl: DynMoController, *, async_mode: bool = False,
                 epoch_fn: Optional[Callable[[], int]] = None,
                 name: str = "dynmo-control-plane"):
        self.ctrl = ctrl
        self.async_mode = async_mode
        self.epoch_fn = epoch_fn
        # decide vs apply / rebind (reentrant: a rank's broadcast point
        # holds it around the mutation it orders)
        self._ctrl_lock = threading.RLock()
        self._cv = threading.Condition()     # inbox, outbox, busy, stop
        self._inbox: Optional[StatsSnapshot] = None
        self._outbox: Optional[DecisionPlan] = None
        self._busy = False
        self._stop = False
        self._error: Optional[BaseException] = None
        self.published = 0
        self.decided = 0
        self.dropped = 0            # snapshots overwritten before a decide
        self.stale_rejected = 0     # plans fenced off by epoch
        self.injected = 0           # resizes put in by inject_resize
        self._thread: Optional[threading.Thread] = None
        if async_mode:
            self._thread = threading.Thread(target=self._loop, name=name,
                                            daemon=True)
            self._thread.start()

    # -- training-thread API -------------------------------------------------
    def publish(self, snap: StatsSnapshot) -> None:
        """Hand a snapshot to the decision worker (inline: decide now).
        Never blocks on the decision; an unconsumed older snapshot is
        overwritten (latest wins)."""
        with self._cv:
            self.published += 1
        if not self.async_mode:
            plan = self._decide(snap)
            with self._cv:
                self._post(plan)
            return
        with self._cv:
            if self._inbox is not None:
                self.dropped += 1
            self._inbox = snap
            self._cv.notify_all()

    def poll(self, epoch: int) -> Optional[DecisionPlan]:
        """Fetch the newest finished plan, or None; a plan decided against
        another epoch than the caller's current one is rejected."""
        self._reraise()
        with self._cv:
            plan, self._outbox = self._outbox, None
            if plan is not None and plan.epoch != epoch:
                self.stale_rejected += 1
                return None
        return plan

    def inject_resize(self, epoch: int, target_stages: int, *,
                      policy: str = "preempt") -> DecisionPlan:
        """Put an externally originated shrink into the outbox: it reaches
        the training loop's safe point through the same epoch-fenced
        mailbox as the controller's decisions (latest wins)."""
        self.injected += 1
        plan = DecisionPlan(
            epoch=epoch, iteration=-1, new_lps=None,
            resize=ResizePlan(iteration=-1, target_stages=target_stages,
                              layers_per_stage=None, released_stages=[],
                              policy=policy, mem_per_stage=[]),
            event=None, decide_s=0.0, key=("inject", self.injected))
        with self._cv:
            self._post(plan)
        return plan

    def _post(self, plan: Optional[DecisionPlan]) -> None:
        """Put a finished plan in the outbox (latest wins; under ``_cv``).
        Inline, a stale snapshot's None clears it as the reference's
        does."""
        self._outbox = plan

    def drain(self, timeout: float = 60.0) -> None:
        """Block until the worker has consumed the inbox and finished any
        decision in flight: publish -> drain -> poll is step for step the
        inline path."""
        if not self.async_mode:
            return
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._inbox is not None or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("control-plane drain timed out")
                self._cv.wait(min(0.05, remaining))
        self._reraise()

    def _reraise(self) -> None:
        """Raise a worker-thread failure on the training thread."""
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                "control-plane decision worker failed") from err

    # -- safe-point state mutation (training thread) -------------------------
    def apply(self, plan: DecisionPlan, params, opt_state, dyn, cache=None):
        """Apply a rebalance plan's migration at a safe point, serialized
        against a decision in flight."""
        with self._ctrl_lock:
            return self.ctrl.apply(plan.new_lps, params, opt_state, dyn,
                                   cache)

    def rebind(self, dcfg, layers_per_stage, mesh=None) -> None:
        """Re-anchor the controller after an engine resize (new world;
        across ranks, ``mesh`` is the new world's, which its migrations
        run on)."""
        with self._ctrl_lock:
            self.ctrl.rebind(dcfg, layers_per_stage)
            if mesh is not None:
                self.ctrl.mesh = mesh

    def with_ctrl(self, fn: Callable[[DynMoController], Any]) -> Any:
        """Run ``fn(ctrl)`` under the controller lock — any other controller
        mutation the training loop makes (e.g. latching repack off after a
        grow)."""
        with self._ctrl_lock:
            return fn(self.ctrl)

    # -- decision body (inline and worker paths) -----------------------------
    def _admit(self, snap: StatsSnapshot) -> bool:
        """Whether to decide on ``snap`` (under the controller lock): not
        when the world changed under it."""
        return self.epoch_fn is None or self.epoch_fn() == snap.epoch

    def _decide(self, snap: StatsSnapshot) -> Optional[DecisionPlan]:
        with self._ctrl_lock:
            if not self._admit(snap):
                # the world changed under this snapshot: no decide on it
                with self._cv:
                    self.stale_rejected += 1
                return None
            return self._decide_admitted(snap)

    def _decide_admitted(self, snap: StatsSnapshot
                         ) -> Optional[DecisionPlan]:
        t0 = time.perf_counter()
        from repro_torch.obs.trace import current_tracer
        tr = current_tracer()
        sp = (tr.span("controlplane.decide", cat="controller",
                      iteration=snap.iteration, epoch=snap.epoch)
              if tr is not None else None)
        with self._ctrl_lock:
            ctrl = self.ctrl
            if snap.stage_times is not None and ctrl.straggler is not None:
                ctrl.straggler.update(snap.stage_times)
            profile = profile_from_stats(
                ctrl.cfg, snap.stats, snap.tags, snap.num_micro,
                snap.tokens, snap.seq, frozen=snap.frozen,
                bytes_per_param=ctrl.dcfg.bytes_per_param)
            new_lps, ev = ctrl.decide(profile, snap.iteration)
            resize = ctrl.take_resize()
            relayout = ctrl.take_expert_relayout()
        with self._cv:      # the counters are shared by both threads
            self.decided += 1
        if sp is not None:
            sp.end(rebalanced=bool(ev is not None and ev.rebalanced),
                   resize=resize is not None)
        return DecisionPlan(epoch=snap.epoch, iteration=snap.iteration,
                            new_lps=new_lps, resize=resize, event=ev,
                            decide_s=time.perf_counter() - t0,
                            expert_relayout=relayout,
                            key=("decide", snap.iteration, snap.epoch))

    # -- worker thread -------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._inbox is None and not self._stop:
                    self._cv.wait(0.2)
                if self._stop:
                    return
                snap, self._inbox = self._inbox, None
                self._busy = True
            plan = None
            try:
                plan = self._decide(snap)
            except BaseException as e:   # noqa: BLE001 — handed to trainer
                self._error = e
            finally:
                with self._cv:
                    if plan is not None:
                        self._post(plan)
                    self._busy = False
                    self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class RankControlPlane(ControlPlane):
    """``ControlPlane`` of one rank of a launch, asynchronous without the
    drain: every rank applies each plan at the same step, each deciding it
    on its own thread.

    The launch's rank ``root`` is the timing authority: its thread takes
    snapshots and posts plans as one process's does, and it records, under
    the controller lock, each decision it starts (the snapshot's iteration
    and epoch, the count of controller mutations before it, and whether
    the epoch fence rejected it) and each plan its outbox overwrote.  At
    every ``poll`` and every controller mutation (``apply``, ``rebind``,
    ``with_ctrl``) it broadcasts what it recorded since the last broadcast
    (and, at ``poll``, the key of the plan it applies or rejects).  Another
    rank keeps its published snapshots until that word arrives, hands the
    ones the authority started to its own thread (the skipped ones were
    overwritten in the authority's inbox: ``dropped``), finishes them
    before its next mutation, so each decision sees the controller state
    the authority's did, and at ``poll`` waits for the named plan of its
    own.  Every rank calls every method in the same order, as the ranks'
    identical host loops do."""

    def __init__(self, ctrl: DynMoController, *, comm, rank: int,
                 root: int = 0, epoch_fn: Optional[Callable[[], int]] = None,
                 name: str = "dynmo-control-plane"):
        self.comm, self.rank, self.root = comm, rank, root
        self.lead = rank == root
        self._mutations = 0
        # the authority's record since its last broadcast
        self._started: List[Tuple] = []     # (iteration, epoch, count, stale)
        self._lost: List[Tuple] = []
        # another rank's: snapshots by iteration, the decisions its thread
        # owes (snapshot, count, stale), finished plans by key
        self._pending: Dict[int, StatsSnapshot] = {}
        self._work: collections.deque = collections.deque()
        self._done: Dict[Tuple, Optional[DecisionPlan]] = {}
        self._discard: set = set()
        super().__init__(ctrl, async_mode=True, epoch_fn=epoch_fn, name=name)

    # -- the authority's record ---------------------------------------------
    def _admit(self, snap: StatsSnapshot) -> bool:
        ok = super()._admit(snap)
        self._started.append((snap.iteration, snap.epoch, self._mutations,
                              not ok))
        return ok

    def _post(self, plan: Optional[DecisionPlan]) -> None:
        if self.lead and self._outbox is not None and plan is not None:
            self._lost.append(self._outbox.key)
        if self.lead or plan is None:
            self._outbox = plan
        else:
            self._done[plan.key] = plan

    def _word(self, **extra) -> Dict[str, Any]:
        """The authority's broadcast (every rank calls; under its
        controller lock on the authority, so no decision starts while it
        is sent); another rank takes up what it says."""
        msg = None
        if self.lead:
            with self._cv:
                msg = {"started": self._started, "lost": self._lost,
                       **extra}
                self._started, self._lost = [], []
        msg = self.comm.broadcast_object(msg, self.root)
        if not self.lead:
            self._take_up(msg)
        return msg

    # -- another rank -----------------------------------------------------------
    def publish(self, snap: StatsSnapshot) -> None:
        if self.lead:
            return super().publish(snap)
        with self._cv:
            self.published += 1
            self._pending[snap.iteration] = snap

    def _take_up(self, msg) -> None:
        with self._cv:
            for it, ep, count, stale in msg["started"]:
                for older in [i for i in self._pending if i < it]:
                    del self._pending[older]
                    self.dropped += 1
                snap = self._pending.pop(it)
                self._work.append((snap, count, stale))
            for key in msg["lost"]:
                if self._done.pop(key, 0) == 0:
                    self._discard.add(key)
            self._cv.notify_all()

    def _idle(self) -> None:
        """Wait until this rank's thread has finished every decision it
        owes."""
        with self._cv:
            while self._work or self._busy:
                if self._error is not None:
                    break
                self._cv.wait(0.05)
        self._reraise()

    def _loop(self) -> None:
        if self.lead:
            return super()._loop()
        while True:
            with self._cv:
                while not self._work and not self._stop:
                    self._cv.wait(0.2)
                if self._stop:
                    return
                snap, count, stale = self._work.popleft()
                self._busy = True
            try:
                plan = None
                with self._ctrl_lock:
                    if count != self._mutations:
                        raise RuntimeError(
                            f"rank {self.rank}: snapshot {snap.iteration} "
                            f"started after {count} controller mutations "
                            f"on rank {self.root}, {self._mutations} here")
                    if stale:
                        with self._cv:
                            self.stale_rejected += 1
                    else:
                        plan = self._decide_admitted(snap)
            except BaseException as e:   # noqa: BLE001 — handed to trainer
                self._error = e
            finally:
                with self._cv:
                    if plan is not None:
                        if plan.key in self._discard:
                            self._discard.discard(plan.key)
                        else:
                            self._done[plan.key] = plan
                    self._busy = False
                    self._cv.notify_all()

    # -- the training thread's side (every rank) ----------------------------------
    def poll(self, epoch: int) -> Optional[DecisionPlan]:
        self._reraise()
        if self.lead:
            with self._ctrl_lock:
                with self._cv:
                    plan, self._outbox = self._outbox, None
                verdict = None
                if plan is not None:
                    verdict = ("apply" if plan.epoch == epoch else "stale",
                               plan.key)
                self._word(poll=verdict)
        else:
            verdict = self._word()["poll"]
            plan = None
            if verdict is not None:
                key = verdict[1]
                with self._cv:
                    while key not in self._done and self._error is None:
                        self._cv.wait(0.05)
                    plan = self._done.pop(key, None)
                self._reraise()
        if verdict is None:
            return None
        if verdict[0] == "stale":
            with self._cv:
                self.stale_rejected += 1
            return None
        return plan

    def _mutate(self, fn: Callable[[], Any]) -> Any:
        """Run a training-thread mutation of the controller at a broadcast
        point: on every rank after the same decisions."""
        if self.lead:
            with self._ctrl_lock:
                self._word()
                out = fn()
                self._mutations += 1
            return out
        self._word()
        self._idle()
        with self._ctrl_lock:
            out = fn()
            self._mutations += 1
        return out

    def apply(self, plan: DecisionPlan, params, opt_state, dyn, cache=None):
        base = super().apply
        return self._mutate(lambda: base(plan, params, opt_state, dyn,
                                         cache))

    def rebind(self, dcfg, layers_per_stage, mesh=None) -> None:
        base = super().rebind
        return self._mutate(lambda: base(dcfg, layers_per_stage, mesh))

    def with_ctrl(self, fn: Callable[[DynMoController], Any]) -> Any:
        return self._mutate(lambda: fn(self.ctrl))

    def drain(self, timeout: float = 60.0) -> None:
        raise RuntimeError("RankControlPlane runs without the drain (a "
                           "drained plane is step for step the inline one "
                           "on every rank already)")
