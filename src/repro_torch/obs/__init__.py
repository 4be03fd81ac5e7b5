"""Observability, ported from ``repro.obs``:

  * ``obs.timing``  — in-step stage timing (CUDA events around each stage's
    calls inside the live step; imports torch);
  * ``obs.trace``   — span-based structured tracing exported as Chrome
    trace-event JSON (stdlib only);
  * ``obs.metrics`` — counters / gauges / histograms with Prometheus text,
    a JSON snapshot and the ``/metrics`` endpoint (stdlib only);
  * ``obs.events``  — the unified event-record schema (stdlib only).

The names below resolve on first use (PEP 562), so importing
``repro_torch.obs.trace`` / ``events`` / ``metrics`` — as the job-manager
processes do — loads no torch.
"""
import importlib

_EXPORTS = {
    "EVENT_SCHEMA": "events", "stamp_record": "events",
    "MetricsRegistry": "metrics", "scheduler_to_prometheus": "metrics",
    "serve_metrics": "metrics",
    "Tracer": "trace", "current_tracer": "trace",
    "set_current_tracer": "trace",
    "StageTimer": "timing",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
