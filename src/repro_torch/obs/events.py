"""The unified event-record schema, ported from ``repro.obs.events``.

Every event record the port produces — the train and serve CLIs'
``--events-out`` streams and the cluster scheduler's grant timeline —
carries, beside its own fields:

  ``schema``     "obs.event/1"
  ``source``     "session" | "scheduler"
  ``kind``       the event kind (scheduler records alias their legacy
                 ``ev`` field here)
  ``wall``       unix wall stamp (absent on journaled records)
  ``trace_id`` / ``parent_id``
                 the requester's span context when one was carried over
                 RPC.  The port has no tracer yet (ROADMAP Queue 1
                 [faults-obs]), so its clients send none and these stay
                 unset unless a foreign client sent one.

``stamp_record`` is the single mutator every producer calls.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

EVENT_SCHEMA = "obs.event/1"


def stamp_record(rec: Dict[str, Any], *, source: str,
                 kind: Optional[str] = None,
                 ctx: Optional[Dict[str, Any]] = None,
                 wall: bool = True) -> Dict[str, Any]:
    """Attach the unified-schema fields to ``rec`` in place.  ``ctx`` is
    a foreign span context (carried over RPC): its trace_id / span_id
    become this record's trace identity / parent."""
    rec.setdefault("schema", EVENT_SCHEMA)
    rec.setdefault("source", source)
    if kind is not None:
        rec.setdefault("kind", kind)
    if wall and "wall" not in rec:
        rec["wall"] = time.time()
    if ctx:
        rec.setdefault("trace_id", ctx.get("trace_id"))
        rec.setdefault("parent_id", ctx.get("span_id"))
    return rec
