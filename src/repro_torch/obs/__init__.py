"""Observability, ported from ``repro.obs``: in-step stage timing and the
unified event-record schema (the tracer and metrics wait for ROADMAP
Queue 1 [faults-obs])."""
from repro_torch.obs.events import EVENT_SCHEMA, stamp_record
from repro_torch.obs.timing import StageTimer

__all__ = ["EVENT_SCHEMA", "StageTimer", "stamp_record"]
