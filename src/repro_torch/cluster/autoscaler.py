"""Signal-driven autoscaling policy (replaces CLI ``--grow-back``),
ported from ``repro.cluster.autoscaler``.

Drives ``ElasticEngine.shrink`` / ``grow`` / ``evict`` from live signals
instead of a hard-coded step count:

  * **Heartbeats** — a newly failed *active* worker must be evicted
    immediately (correctness, bypasses hysteresis); a recovered worker
    (revived after failure, e.g. a released machine handed back by the job
    manager) triggers re-growth.
  * **Throughput watermark** — per-worker token throughput over a recent
    step-time window, compared against the best per-worker throughput seen
    so far.  Sustained idleness (current < ``low_watermark`` × best) means
    the pipeline no longer feeds its workers and suggests a shrink;
    recovery headroom uses the symmetric ``high_watermark``.

Hysteresis so decisions don't flap: a watermark signal must persist for
``patience`` consecutive observations, and any resize starts a ``cooldown``
window during which only failure evictions fire.  ``note_resize`` resets
the window — post-resize step times are a different distribution.

The policy is deliberately engine-agnostic: ``observe`` returns a
``ScaleDecision`` and the training loop chooses how to execute it, so the
same policy drives the trainer (``observe``) and the server
(``observe_load``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence, Set

from repro_torch.runtime.fault_tolerance import HeartbeatMonitor


@dataclasses.dataclass
class AutoscalerConfig:
    min_stages: int = 1
    max_stages: int = 64
    window: int = 4              # step-time observations per throughput est.
    low_watermark: float = 0.6   # per-worker throughput fraction → shrink
    high_watermark: float = 0.9  # recovery threshold before growing again
    patience: int = 3            # consecutive signals before acting
    cooldown: int = 8            # steps after a resize with no scaling
    watermark: bool = True       # False: heartbeat signals only (wall-clock
    #   throughput is noise on shared CI machines — keep scaling
    #   deterministic there)
    # ---- serving load signals (``observe_load``) -------------------------
    queue_high: int = 8          # pending requests → grow pressure
    occupancy_low: float = 0.35  # live-lane fraction; with an empty queue,
    #   sustained occupancy below this consolidates the serving pipeline
    latency_slo_s: float = 0.0   # p95 inter-token latency SLO → grow
    #   pressure (the server feeds the p95 over its recent token window,
    #   not a raw tick wall).  0 disables: the latency signal is
    #   wall-clock and therefore breaks run-to-run determinism — leave
    #   off when comparing traces
    page_high: float = 0.92      # paged-KV pool occupancy → grow pressure:
    #   a nearly-full block pool is the memory analogue of a deep queue
    #   (admission gates on free *pages*, so pool pressure backs requests
    #   up even while lanes sit free).  Only fed in paged serving mode


@dataclasses.dataclass
class ScaleDecision:
    step: int
    action: str                  # "none" | "shrink" | "grow" | "evict"
    workers: int                 # how many workers the action concerns
    reason: str
    ids: List[int] = dataclasses.field(default_factory=list)
    # concrete worker ids, when the signal names them (evict: the dead
    # workers; grow: the recovered ones) — empty for watermark decisions
    urgent: bool = False
    # hard pressure (SLO breach / deep queue): on a multi-tenant manager a
    # grow may escalate to a cluster-scheduler *steal*


_NONE = "none"


class Autoscaler:
    """Stateful policy: feed it one observation per step, act on what it
    returns.  ``monitor`` is optional — without it only the throughput
    watermark is active."""

    def __init__(self, cfg: AutoscalerConfig,
                 monitor: Optional[HeartbeatMonitor] = None):
        self.cfg = cfg
        self.monitor = monitor
        self._times: collections.deque = collections.deque(
            maxlen=max(1, cfg.window))
        self._known_failed: Set[int] = set()
        self._pending_recovered: Set[int] = set()
        self._pending_evict: Set[int] = set()
        self._bad_shrink_sizes: Set[int] = set()
        self._best_per_worker = 0.0
        self._best_total = 0.0
        self._low_streak = 0
        self._slow_streak = 0
        self._pressure_streak = 0
        self._drain_streak = 0
        self._last_resize_step: Optional[int] = None
        self._last_grow_attempt: Optional[int] = None
        self.decisions: List[ScaleDecision] = []

    # -- persistence (safe points) -----------------------------------------
    def state_dict(self) -> dict:
        """Hysteresis state for crash-safe resume: a resumed run must make
        the same decisions the uninterrupted run would have (cooldown
        anchors, streaks, and best-throughput baselines all carry over).
        ``decisions`` stays out — it is report telemetry, not policy state."""
        return {
            "times": list(self._times),
            "known_failed": sorted(self._known_failed),
            "pending_recovered": sorted(self._pending_recovered),
            "pending_evict": sorted(self._pending_evict),
            "bad_shrink_sizes": sorted(self._bad_shrink_sizes),
            "best_per_worker": self._best_per_worker,
            "best_total": self._best_total,
            "low_streak": self._low_streak,
            "slow_streak": self._slow_streak,
            "pressure_streak": self._pressure_streak,
            "drain_streak": self._drain_streak,
            "last_resize_step": self._last_resize_step,
            "last_grow_attempt": self._last_grow_attempt,
        }

    def load_state(self, sd: dict) -> None:
        self._times.clear()
        self._times.extend(float(t) for t in sd["times"])
        self._known_failed = set(sd["known_failed"])
        self._pending_recovered = set(sd["pending_recovered"])
        self._pending_evict = set(sd["pending_evict"])
        self._bad_shrink_sizes = set(sd["bad_shrink_sizes"])
        self._best_per_worker = float(sd["best_per_worker"])
        self._best_total = float(sd["best_total"])
        self._low_streak = int(sd["low_streak"])
        self._slow_streak = int(sd["slow_streak"])
        self._pressure_streak = int(sd["pressure_streak"])
        self._drain_streak = int(sd["drain_streak"])
        self._last_resize_step = sd["last_resize_step"]
        self._last_grow_attempt = sd["last_grow_attempt"]

    # -- lifecycle hooks ---------------------------------------------------
    def note_resize(self, step: int, stages: int) -> None:
        """The world changed (any cause): reset the throughput window and
        start the cooldown clock."""
        del stages
        self._times.clear()
        self._low_streak = 0
        self._slow_streak = 0
        self._pressure_streak = 0
        self._drain_streak = 0
        self._last_resize_step = step

    def _in_cooldown(self, step: int) -> bool:
        return (self._last_resize_step is not None
                and step - self._last_resize_step < self.cfg.cooldown)

    # -- one observation per step -----------------------------------------
    def observe(self, step: int, step_time_s: float, stages: int,
                active_workers: Sequence[int], tokens: int) -> ScaleDecision:
        decision = ScaleDecision(step, _NONE, 0, "")

        # 1) heartbeat signals (these bypass the watermark hysteresis: a
        # dead worker is a correctness problem and a recovered one is an
        # explicit grant from the job-manager side, not a noisy measurement)
        if self.monitor is not None:
            failed = self.monitor.failed_workers()
            active = set(active_workers)
            newly_failed = (failed - self._known_failed) & active
            # remember recoveries until acted on — the revive transition is
            # transient but the capacity it frees is not (a grow blocked by
            # max_stages today must still fire after a later evict).  Only
            # becoming ACTIVE clears one: a revived-but-not-yet-granted
            # worker is not beaten, so it may time out back into ``failed``
            # while waiting — that must not drop the recovery
            self._pending_recovered |= self._known_failed - failed
            self._pending_recovered -= active
            # dead ACTIVE workers stay due for eviction until they actually
            # leave the pipeline (min_stages may cap how many go at once)
            # or recover on their own
            self._pending_evict = (self._pending_evict | newly_failed) \
                & failed & active
            self._known_failed = set(failed)
            if self._pending_evict:
                n = min(len(self._pending_evict),
                        stages - self.cfg.min_stages)
                if n > 0:
                    ids = sorted(self._pending_evict)[:n]
                    decision = ScaleDecision(
                        step, "evict", n,
                        f"heartbeat lost: workers {ids}", ids=ids)
            # NOT elif on the evict SET: when min_stages caps eviction to
            # zero, the recovery grow below is exactly what creates the
            # capacity to evict the dead worker — blocking it would stall
            # the autoscaler with a corpse in the pipeline
            if decision.action == _NONE and self._pending_recovered:
                n = min(len(self._pending_recovered),
                        self.cfg.max_stages - stages)
                # ids are NOT consumed here: the grant may fail (e.g. the
                # worker is dead on the manager side), so they stay pending
                # until they actually turn up active (cleaned above) — with
                # retries spaced by the cooldown so a never-grantable
                # worker doesn't spam grow attempts every step
                if n > 0 and (self._last_grow_attempt is None
                              or step - self._last_grow_attempt
                              >= self.cfg.cooldown):
                    self._last_grow_attempt = step
                    ids = sorted(self._pending_recovered)[:n]
                    decision = ScaleDecision(
                        step, "grow", n,
                        f"heartbeat recovered: {ids}", ids=ids)
        if decision.action != _NONE:
            self.decisions.append(decision)
            return decision

        # 2) throughput/idleness watermark with hysteresis
        if not self.cfg.watermark:
            return decision
        self._times.append(float(step_time_s))
        if (len(self._times) == self._times.maxlen
                and not self._in_cooldown(step)):
            mean_t = sum(self._times) / len(self._times)
            total = tokens / max(1e-9, mean_t)
            per_worker = total / stages
            self._best_per_worker = max(self._best_per_worker, per_worker)
            self._best_total = max(self._best_total, total)
            idle = per_worker < self.cfg.low_watermark * self._best_per_worker
            slow = total < self.cfg.high_watermark * self._best_total
            self._low_streak = self._low_streak + 1 if idle else 0
            self._slow_streak = self._slow_streak + 1 if slow else 0
            if (self._low_streak >= self.cfg.patience
                    and stages > self.cfg.min_stages
                    and stages - 1 not in self._bad_shrink_sizes):
                # (a size whose shrink previously regressed total
                # throughput enough to trigger the grow watermark is
                # remembered and never re-tried — the two watermarks would
                # otherwise oppose each other into a steady resize cycle
                # in compute-bound regimes)
                self._low_streak = 0
                decision = ScaleDecision(
                    step, "shrink", 1,
                    f"per-worker throughput {per_worker:.0f} tok/s below "
                    f"{self.cfg.low_watermark:.0%} of best "
                    f"{self._best_per_worker:.0f}")
            elif (self._slow_streak >= self.cfg.patience
                    and stages < self.cfg.max_stages):
                # end-to-end throughput regressed (e.g. the model grew back,
                # or a worker was evicted): try to reclaim capacity — the
                # grow is a no-op if the job manager grants nothing
                self._slow_streak = 0
                self._bad_shrink_sizes.add(stages)
                decision = ScaleDecision(
                    step, "grow", 1,
                    f"throughput {total:.0f} tok/s below "
                    f"{self.cfg.high_watermark:.0%} of best "
                    f"{self._best_total:.0f}")
        if decision.action != _NONE:
            self.decisions.append(decision)
        return decision

    # -- serving load signals (one observation per scheduler tick) ---------
    def observe_load(self, step: int, stages: int, *, queue_depth: int,
                     occupancy: float, latency_s: float = 0.0,
                     page_occupancy: Optional[float] = None
                     ) -> ScaleDecision:
        """Queue-depth / latency / occupancy watermarks for the serving
        tier, sharing the training watermarks' hysteresis (``patience``
        consecutive signals, ``cooldown`` after any resize).

        *Grow* on sustained admission pressure: the queue backs up past
        ``queue_high`` (requests wait because every KV lane is taken), or
        p95 per-token latency breaches the SLO when one is configured.
        *Shrink* on sustained drain: queue empty and live-lane occupancy
        below ``occupancy_low`` — early exits / short generations have
        vacated most lanes, so fewer workers serve the same tokens with a
        shorter pipeline fill.  Signals are logical (queue/occupancy), so
        scaling is deterministic per trace unless the latency SLO is on.

        ``page_occupancy`` (paged serving only, else None) adds page
        *pressure*: a block pool past ``page_high`` gates admissions just
        like exhausted lanes do, and also vetoes the drain shrink — lanes
        may look idle while the pool is pinned by long prompts.
        """
        decision = ScaleDecision(step, _NONE, 0, "")
        if self._in_cooldown(step):
            return decision
        paged_hot = (page_occupancy is not None
                     and page_occupancy >= self.cfg.page_high)
        pressured = queue_depth >= self.cfg.queue_high or paged_hot or (
            self.cfg.latency_slo_s > 0
            and latency_s > self.cfg.latency_slo_s)
        draining = (queue_depth == 0 and occupancy <= self.cfg.occupancy_low
                    and not paged_hot)
        self._pressure_streak = self._pressure_streak + 1 if pressured else 0
        self._drain_streak = self._drain_streak + 1 if draining else 0
        if (self._pressure_streak >= self.cfg.patience
                and stages < self.cfg.max_stages):
            self._pressure_streak = 0
            # urgent = SLO actually breached, or the queue runs at twice
            # the grow watermark — worth preempting a lower-priority
            # tenant for, not just waiting on free capacity
            urgent = (self.cfg.latency_slo_s > 0
                      and latency_s > self.cfg.latency_slo_s) or (
                          queue_depth >= 2 * self.cfg.queue_high)
            pages = (f" pages={page_occupancy:.0%}"
                     if page_occupancy is not None else "")
            decision = ScaleDecision(
                step, "grow", 1,
                f"load: queue={queue_depth} latency={latency_s * 1e3:.0f}ms "
                f"at occupancy {occupancy:.0%}{pages}", urgent=urgent)
        elif (self._drain_streak >= self.cfg.patience
                and stages > self.cfg.min_stages):
            self._drain_streak = 0
            decision = ScaleDecision(
                step, "shrink", 1,
                f"drain: queue empty, occupancy {occupancy:.0%} below "
                f"{self.cfg.occupancy_low:.0%}")
        if decision.action != _NONE:
            self.decisions.append(decision)
        return decision
