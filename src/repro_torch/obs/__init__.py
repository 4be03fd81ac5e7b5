"""Observability, ported from ``repro.obs``: in-step stage timing, the
unified event-record schema and the metrics registry (the tracer and the
``/metrics`` endpoint wait for ROADMAP Queue 1 [faults-obs])."""
from repro_torch.obs.events import EVENT_SCHEMA, stamp_record
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.timing import StageTimer

__all__ = ["EVENT_SCHEMA", "MetricsRegistry", "StageTimer", "stamp_record"]
