"""In-step stage timing, ported from ``repro.obs.timing``.

The stage probe (``ElasticEngine.measure_stage_times``) runs each stage
alone, outside the step.  ``StageTimer`` instead times each stage's
forward call inside the live pipelined step: the loss function stamps
``stamp(stage, 0)`` before a stage's forward and ``stamp(stage, 1)`` after
it, and the timer pairs the stamps into busy seconds per stage.  The
backward is not stamped (the reference's stamp is an identity in the
backward too).

The reference stamps with ``jax.pure_callback`` host timestamps threaded
through the carry.  Here the stamps are:
  * on the CPU, ``time.perf_counter()`` (execution is synchronous);
  * on CUDA, a pair of ``torch.cuda.Event(enable_timing=True)`` recorded
    on the current stream around the call.  The events come from a pool of
    ``2 x num_micro x S`` made once per timer and reused: stage s's k-th
    forward of a step records pair (s, k mod num_micro), so the pool holds
    the newest step's pairs.  Nothing reads them on the hot path: the pairs
    are read (``elapsed_time``) only in ``snapshot``, which the trainer
    calls on controller cadence after the step's loss sync has completed
    every recorded event, so stamping adds no host-device sync.  An event
    interval spans the stage's work on the device timeline, including the
    gaps in which the device waits for the host to enqueue more.

``snapshot(ticks_per_step)`` returns the mean seconds per stamped call
times ``ticks_per_step`` (per-step busy seconds when that is the number of
calls a stage makes in a step), None until every stage has stamped since
the last snapshot, and resets on read (the reference's semantics).

``StepSpans`` times the phases of a traced training step the same way:
each phase is a span of the current tracer (its host interval is the
host's enqueue time) and carries ``device_ms``, the device time between
CUDA events recorded at its boundaries, read after the step's loss sync.
``step_tracer`` is the tracer a training step records into; while a
``torch.profiler`` records and no tracer is current, it makes one current
(``profile_tracer``), so a profile carries the loop's and the step's
spans on its own clock.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from repro_torch.obs.trace import (Span, Tracer, current_tracer,
                                   set_current_tracer)


class StageTimer:
    """Collects stage-boundary stamps into per-stage busy seconds.

    ``device`` selects the clock: CUDA events on a CUDA device (pool of
    ``2 x num_micro x num_stages``), ``time.perf_counter`` on the CPU."""

    def __init__(self, num_stages: int, device=None, num_micro: int = 1):
        self.num_stages = int(num_stages)
        self.device = torch.device("cpu" if device is None else device)
        self._lock = threading.Lock()
        self._open = {}
        self._acc = np.zeros(self.num_stages, np.float64)
        self._n = np.zeros(self.num_stages, np.int64)
        self._events = None
        if self.device.type == "cuda":
            self.num_micro = max(1, int(num_micro))
            self._events = [[(torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                             for _ in range(self.num_micro)]
                            for _ in range(self.num_stages)]
            self._next = [0] * self.num_stages     # pair to record next
            self._filled = [0] * self.num_stages   # pairs recorded

    def stamp(self, stage: int, phase: int) -> None:
        s = int(stage)
        if self._events is not None:
            if 0 <= s < self.num_stages:
                k = self._next[s]
                self._events[s][k][int(phase) != 0].record()
                if int(phase) != 0:
                    self._next[s] = (k + 1) % self.num_micro
                    self._filled[s] = min(self._filled[s] + 1,
                                          self.num_micro)
            return
        t = time.perf_counter()
        if not (0 <= s < self.num_stages):
            return
        with self._lock:
            if int(phase) == 0:
                self._open[s] = t
            else:
                t0 = self._open.pop(s, None)
                if t0 is not None:
                    self._acc[s] += t - t0
                    self._n[s] += 1

    def _fold_events(self, reset: bool) -> None:
        """Read the recorded CUDA pairs into the accumulators."""
        for s in range(self.num_stages):
            for k in range(self._filled[s]):
                start, end = self._events[s][k]
                end.synchronize()        # complete already after the step
                self._acc[s] += start.elapsed_time(end) * 1e-3
                self._n[s] += 1
            if reset:
                self._filled[s] = 0
                self._next[s] = 0

    def snapshot(self, ticks_per_step: Optional[int] = None,
                 reset: bool = True) -> Optional[np.ndarray]:
        """Per-stage busy seconds: mean per stamped call (times
        ``ticks_per_step`` when given).  None until every stage has stamped
        at least once since the last snapshot."""
        with self._lock:
            if self._events is not None:
                acc0, n0 = self._acc.copy(), self._n.copy()
                self._fold_events(reset)
                acc, n = self._acc.copy(), self._n.copy()
                if not reset:
                    self._acc, self._n = acc0, n0
            else:
                acc, n = self._acc.copy(), self._n.copy()
            if reset:
                self._acc[:] = 0.0
                self._n[:] = 0
                self._open.clear()
        if not n.all():
            return None
        per_tick = acc / n
        return per_tick * ticks_per_step if ticks_per_step else per_tick

    @property
    def samples(self) -> np.ndarray:
        with self._lock:
            n = self._n.copy()
            if self._events is not None:
                n += np.asarray(self._filled, np.int64)
            return n


class StepSpans:
    """The phases of a training step as spans with their device time.

    ``begin(tracer)`` returns ``phase``: ``phase(name)`` ends the open
    phase's span and opens ``name`` (None: opens nothing) under the
    tracer's innermost open span, whose ``step`` it carries.  On CUDA an
    event is recorded on the current stream at each boundary, from a pool
    made on the first traced step and reused; ``resolve`` writes each
    span's ``device_ms`` after the step's own sync has completed the
    events.  On the CPU ``device_ms`` is the host interval (execution is
    synchronous)."""

    def __init__(self, device=None):
        self.device = torch.device("cpu" if device is None else device)
        self._events: Optional[List[Any]] = None
        self._pending: List[Tuple[Dict[str, Any], int]] = []
        self._tracer: Optional[Tracer] = None
        self._open: Optional[Span] = None
        self._b = 0
        self._step = None

    def begin(self, tracer: Tracer):
        # a step whose events were never read keeps no device time
        self._pending.clear()
        self._tracer, self._open, self._b = tracer, None, 0
        parent = tracer.open_span()
        self._step = None if parent is None else parent.args.get("step")
        if self.device.type == "cuda" and self._events is None:
            self._events = []
        return self.phase

    def phase(self, name: Optional[str]) -> None:
        evs = self._events
        if evs is not None:
            if self._b == len(evs):
                evs.append(torch.cuda.Event(enable_timing=True))
            evs[self._b].record()
        if self._open is not None:
            ev = self._open.end()
            if evs is None:
                ev["args"]["device_ms"] = ev["dur"] / 1e3
            else:
                self._pending.append((ev, self._b - 1))
        self._b += 1
        self._open = None
        if name is not None:
            args = {} if self._step is None else {"step": self._step}
            self._open = self._tracer.span(name, cat="step", **args)

    def resolve(self) -> None:
        """Each ended span's ``device_ms``: its boundary events' elapsed
        time, for the events the device has completed."""
        for ev, b in self._pending:
            start, end = self._events[b], self._events[b + 1]
            if end.query():
                ev["args"]["device_ms"] = start.elapsed_time(end)
        self._pending.clear()


_profiled: Optional[Tracer] = None   # the newest profile's tracer
_profiled_current = False            # ... and whether it is current
_profiles = 0


def profile_tracer() -> Optional[Tracer]:
    """The tracer ``step_tracer`` made current for the newest stretch of
    steps run under a recording ``torch.profiler``, or None."""
    return _profiled


def step_tracer() -> Optional[Tracer]:
    """The tracer a training step records into, looked up as the step
    starts: the current tracer.  While a ``torch.profiler`` records and no
    tracer is current, a fresh one is made current (``profile_tracer``);
    once the profiler has stopped, it is made not current again."""
    global _profiled, _profiled_current, _profiles
    cur = current_tracer()
    recording = _autograd_profiler._is_profiler_enabled
    if cur is None:
        if recording:
            _profiles += 1
            cur = _profiled = Tracer(f"profile-{_profiles}",
                                     meta={"mode": "profile"})
            _profiled_current = True
            set_current_tracer(cur)
    elif not recording and _profiled_current and cur is _profiled:
        release_profile_tracer()
        cur = None
    return cur


def release_profile_tracer() -> None:
    """Make the profile's tracer not current (a training loop's end)."""
    global _profiled_current
    if _profiled_current and current_tracer() is _profiled:
        set_current_tracer(None)
    _profiled_current = False
