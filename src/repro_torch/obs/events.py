"""The unified event-record schema, ported from ``repro.obs.events``.

Every event record the port produces — the session telemetry stream
(``--events-out``), the fault-event log (``faults.injector.FaultRecord``)
and the cluster scheduler's grant timeline — carries, beside its own
fields:

  ``schema``     "obs.event/1"
  ``source``     "session" | "fault" | "scheduler"
  ``kind``       the event kind (scheduler records alias their legacy
                 ``ev`` field here)
  ``wall``       unix wall stamp (absent on journaled records)
  ``trace_id`` / ``span_id`` / ``parent_id`` / ``lc``
                 tracing identity, when a tracer (local or propagated
                 over RPC) is in scope; ``lc`` is the source's logical
                 clock — comparable within a source, not across them.

``stamp_record`` is the single mutator every producer calls.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

from repro_torch.obs import trace as _trace

EVENT_SCHEMA = "obs.event/1"


def stamp_record(rec: Dict[str, Any], *, source: str,
                 kind: Optional[str] = None,
                 tracer: Optional["_trace.Tracer"] = None,
                 ctx: Optional[Dict[str, Any]] = None,
                 wall: bool = True) -> Dict[str, Any]:
    """Attach the unified-schema fields to ``rec`` in place.

    ``ctx`` is a foreign span context (e.g. carried over RPC): its
    trace_id / span_id become this record's trace identity / parent.  A
    local ``tracer`` (defaults to the process-current one) mints fresh
    ids; with both, the record keeps the local identity and parents on the
    foreign span (``cause_trace_id`` names the foreign trace).
    """
    rec.setdefault("schema", EVENT_SCHEMA)
    rec.setdefault("source", source)
    if kind is not None:
        rec.setdefault("kind", kind)
    if wall and "wall" not in rec:
        rec["wall"] = time.time()
    tr = tracer if tracer is not None else _trace.current_tracer()
    if tr is not None:
        rec.update(tr.event_context())
    elif ctx:
        rec.setdefault("trace_id", ctx.get("trace_id"))
        rec.setdefault("parent_id", ctx.get("span_id"))
    if ctx and tr is not None:
        # a local tracer AND a foreign cause: keep the local identity,
        # parent onto the foreign span so cross-process chains correlate
        rec["parent_id"] = ctx.get("span_id") or rec.get("parent_id")
        rec.setdefault("cause_trace_id", ctx.get("trace_id"))
    return rec
