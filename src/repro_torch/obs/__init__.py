"""Observability, ported from ``repro.obs``: in-step stage timing (the
tracer, metrics and events wait for ROADMAP Queue 1 [faults-obs])."""
from repro_torch.obs.timing import StageTimer

__all__ = ["StageTimer"]
