"""Span-based structured tracing, ported from ``repro.obs.trace``.

A ``Tracer`` records spans (trace_id / span_id / parent_id) with both
wall-clock stamps (microseconds, for Perfetto) and a logical clock (a
per-tracer monotonic counter, for determinism tests and cross-event
ordering that survives wall-clock noise).  Export is Chrome trace-event
JSON: ``{"traceEvents": [...]}`` — drag the file into
https://ui.perfetto.dev and every span shows its ids under ``args``.

Cross-process correlation: RPC transports call :meth:`Tracer.rpc_ctx` to
mint a child span context ``{"trace_id", "span_id"}`` and ship it inside
the request payload; the receiving process records the context on its own
events (``parent_id`` pointing at the sender's span), so a serve-tenant
steal, the scheduler's preemption directive, and the trainer's safe-point
shrink chain up across three processes.

The module-level *current tracer* is how deep layers (RPC clients, the
control plane, the fault injector) find the session's tracer without
threading it through every constructor.  It is process-global on
purpose — the async controller thread and HTTP client calls must see it.
The span ids, logical clocks and export schema are the reference's byte
for byte (``tests/golden/trace_events.json``).  A span the asynchronous
controller thread opens takes its id when it opens, so a fixed-seed run's
``event_sequence`` is reproducible wherever the main thread waits for the
decision (inline, or async with the drain).  Stdlib-only: safe to import
in manager processes that never load torch.

The default clock is the wall clock in integer nanoseconds
(``time.time_ns``), the clock ``torch.profiler``'s Chrome trace is on:
``wall0`` is the same reading as the origin of ``ts``, so ``wall0 + ts``
places a span on a device trace with no second clock read.  A span's
event is returned by ``end`` and may take more arguments until export
(``obs.timing.StepSpans`` writes a step span's device time into it).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_lock = threading.Lock()
_current: Optional["Tracer"] = None


def set_current_tracer(tracer: Optional["Tracer"]) -> None:
    global _current
    with _lock:
        _current = tracer


def current_tracer() -> Optional["Tracer"]:
    return _current


class Span:
    """One open span; use as a context manager or call ``end()``."""

    __slots__ = ("tracer", "name", "cat", "span_id", "parent_id",
                 "args", "_t0", "_lc0", "_done")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 span_id: str, parent_id: Optional[str],
                 args: Dict[str, Any], t0: float, lc0: int):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.span_id = span_id
        self.parent_id = parent_id
        self.args = args
        self._t0 = t0
        self._lc0 = lc0
        self._done = False

    def ctx(self) -> Dict[str, str]:
        """The wire context other processes parent their events on."""
        return {"trace_id": self.tracer.trace_id, "span_id": self.span_id}

    def end(self, **extra_args) -> Optional[Dict[str, Any]]:
        """Record the span; returns its event (None if already ended)."""
        if self._done:
            return None
        self._done = True
        return self.tracer._end_span(self, extra_args)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class Tracer:
    """Collects spans/instants; exports Chrome trace-event JSON.

    ``trace_id`` should be derived from stable run identity (seed +
    tenant), NOT from pids or clocks — the logical event sequence of a
    fixed-seed run must be reproducible (tested).  ``clock``/``pid`` are
    injectable for golden fixtures (seconds; ``wall0`` is then read apart).
    """

    def __init__(self, trace_id: str, *, clock=None,
                 pid: Optional[int] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id
        self._clock = clock
        self._pid = os.getpid() if pid is None else pid
        self._lock = threading.RLock()
        self._events: List[Dict[str, Any]] = []
        self._lc = 0
        self._span_seq = 0
        if clock is None:
            self._t0 = time.time_ns()
            self.wall0_ns = self._t0
        else:
            self._t0 = clock()
            self.wall0_ns = time.time_ns()
        self._wall0 = self.wall0_ns / 1e9
        self._stack = threading.local()   # open-span stack, per thread
        self.meta = dict(meta or {})

    # -- clocks and ids -----------------------------------------------------
    def next_lc(self) -> int:
        with self._lock:
            self._lc += 1
            return self._lc

    def _new_span_id(self) -> str:
        with self._lock:
            self._span_seq += 1
            return f"{self.trace_id}.s{self._span_seq}"

    def _us(self) -> float:
        if self._clock is None:
            return (time.time_ns() - self._t0) / 1e3
        return (self._clock() - self._t0) * 1e6

    def _tid(self) -> int:
        return threading.get_ident() % 100000

    def _parent(self) -> Optional[str]:
        stack = getattr(self._stack, "spans", None)
        return stack[-1].span_id if stack else None

    def open_span(self) -> Optional[Span]:
        """This thread's innermost open span."""
        stack = getattr(self._stack, "spans", None)
        return stack[-1] if stack else None

    # -- recording ----------------------------------------------------------
    def span(self, name: str, cat: str = "session",
             parent_id: Optional[str] = None, **args) -> Span:
        """Open a span; parent defaults to this thread's enclosing span.
        Pass ``parent_id`` explicitly to chain onto a foreign (cross-
        process) span context."""
        sp = Span(self, name, cat, self._new_span_id(),
                  parent_id if parent_id is not None else self._parent(),
                  dict(args), self._us(), self.next_lc())
        stack = getattr(self._stack, "spans", None)
        if stack is None:
            stack = self._stack.spans = []
        stack.append(sp)
        return sp

    def _end_span(self, sp: Span, extra_args: Dict[str, Any]
                  ) -> Dict[str, Any]:
        stack = getattr(self._stack, "spans", None)
        if stack and sp in stack:
            stack.remove(sp)
        t1 = self._us()
        args = {"trace_id": self.trace_id, "span_id": sp.span_id,
                "parent_id": sp.parent_id, "lc": sp._lc0,
                "lc_end": self.next_lc(), **sp.args, **extra_args}
        ev = {"name": sp.name, "cat": sp.cat, "ph": "X",
              "ts": sp._t0, "dur": max(0.0, t1 - sp._t0),
              "pid": self._pid, "tid": self._tid(), "args": args}
        with self._lock:
            self._events.append(ev)
        return ev

    def instant(self, name: str, cat: str = "session",
                parent_id: Optional[str] = None, **args) -> Dict[str, str]:
        """Record a zero-duration event; returns its wire context."""
        span_id = self._new_span_id()
        rec_args = {"trace_id": self.trace_id, "span_id": span_id,
                    "parent_id": (parent_id if parent_id is not None
                                  else self._parent()),
                    "lc": self.next_lc(), **args}
        with self._lock:
            self._events.append(
                {"name": name, "cat": cat, "ph": "i", "s": "p",
                 "ts": self._us(), "pid": self._pid, "tid": self._tid(),
                 "args": rec_args})
        return {"trace_id": self.trace_id, "span_id": span_id}

    def rpc_ctx(self, op: str, **args) -> Dict[str, str]:
        """Mint the child context an RPC request carries on the wire."""
        return self.instant(f"rpc.{op}", cat="rpc", **args)

    def event_context(self) -> Dict[str, Any]:
        """ids + logical stamp for a unified event record (obs.events)."""
        span_id = self._new_span_id()
        return {"trace_id": self.trace_id, "span_id": span_id,
                "parent_id": self._parent(), "lc": self.next_lc()}

    # -- export -------------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        with self._lock:
            events = list(self._events)
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"trace_id": self.trace_id,
                              "wall0": self._wall0, **self.meta}}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
        return path

    def event_sequence(self) -> List[tuple]:
        """The wall-free view a determinism test compares: (name, ph, lc,
        span_id, parent_id) in logical-clock order."""
        with self._lock:
            evs = [(e["name"], e["ph"], e["args"].get("lc"),
                    e["args"].get("span_id"), e["args"].get("parent_id"))
                   for e in self._events]
        return sorted(evs, key=lambda t: (t[2] is None, t[2]))

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
