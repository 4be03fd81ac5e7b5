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
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

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
        self._ctrl_lock = threading.Lock()   # decide vs apply / rebind
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
                self._outbox = plan
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
        plan = DecisionPlan(
            epoch=epoch, iteration=-1, new_lps=None,
            resize=ResizePlan(iteration=-1, target_stages=target_stages,
                              layers_per_stage=None, released_stages=[],
                              policy=policy, mem_per_stage=[]),
            event=None, decide_s=0.0)
        with self._cv:
            self._outbox = plan
        return plan

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
    def _decide(self, snap: StatsSnapshot) -> Optional[DecisionPlan]:
        if self.epoch_fn is not None and self.epoch_fn() != snap.epoch:
            # the world changed under this snapshot: no decide on it
            with self._cv:
                self.stale_rejected += 1
            return None
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
                            expert_relayout=relayout)

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
                        self._outbox = plan
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
