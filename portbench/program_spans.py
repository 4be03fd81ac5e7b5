"""The program's own spans in a traced run.  While the harness's profiler
records, the program's training loop records each phase of a step into a
tracer of its own (``repro_torch.obs.timing.profile_tracer``): the loader,
the step's batch, forward, backward and optimizer with their device time
(``device_ms``, from CUDA events at the phases' boundaries), the loss sync,
the prune, the decision and its stats read-back, the migration, the hook
and the log.  Its clock is the wall clock the profiler's trace is on.

``read`` gives them to the per-layer readers, or None when the program
recorded none (a program without such spans); ``label_gaps`` lays them on
the device trace's idle gaps."""
from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple


def read() -> Optional[List[Dict[str, Any]]]:
    """[{name, start_ns, end_ns, device_ms, step, parent}]: the program's
    spans on the device trace's clock (``parent`` is the parent span's
    name, None for the root ``train``)."""
    timing = sys.modules.get("repro_torch.obs.timing")
    get = getattr(timing, "profile_tracer", None)
    tracer = get() if get is not None else None
    if tracer is None:
        return None
    evs = [e for e in tracer.to_chrome()["traceEvents"] if e["ph"] == "X"]
    names = {e["args"]["span_id"]: e["name"] for e in evs}
    w0 = tracer.wall0_ns
    out = [{"name": e["name"], "start_ns": w0 + e["ts"] * 1e3,
            "end_ns": w0 + (e["ts"] + e["dur"]) * 1e3,
            "device_ms": e["args"].get("device_ms"),
            "step": e["args"].get("step"),
            "parent": names.get(e["args"].get("parent_id"))} for e in evs]
    return out or None


def steps(spans) -> int:
    """How many steps the spans traced."""
    return sum(1 for s in spans if s["name"] == "train.step")


def device_ms(spans, name: str) -> Optional[float]:
    """Mean ``device_ms`` of the spans ``name`` (one a traced step)."""
    got = [s["device_ms"] for s in spans or ()
           if s["name"] == name and s["device_ms"] is not None]
    return sum(got) / len(got) if got else None


def host_ms(spans, names: Sequence[str]) -> Optional[float]:
    """Host ms a traced step in the spans ``names``."""
    if not spans or not steps(spans):
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for s in spans if s["name"] in names)
    return ns / 1e6 / steps(spans)


def untraced_ms(spans) -> Optional[float]:
    """Host ms a traced step that no span but the root covers, from the
    first traced step's first span to the last one's end."""
    inner = sorted((s["start_ns"], s["end_ns"]) for s in spans or ()
                   if s["parent"] is not None)
    if not inner or not steps(spans):
        return None
    covered, reach = 0.0, inner[0][0]
    for a, b in inner:
        if b > reach:
            covered += b - max(a, reach)
            reach = b
    return (reach - inner[0][0] - covered) / 1e6 / steps(spans)


def label_gaps(path: str, marks_ns: Sequence[int],
               harness_spans: Sequence[Tuple[int, int, str]], spans
               ) -> Optional[List[list]]:
    """``devtrace.reduce_trace``'s ten longest idle gaps, each labelled
    ``<harness label>:<program span>`` by the innermost program span (the
    root aside) that covers the gap's start; a gap that none covers keeps
    the harness's label."""
    import devtrace
    by_harness = devtrace.reduce_trace(path, marks_ns, harness_spans)
    if by_harness is None:
        return None
    inner = [(s["start_ns"], s["end_ns"], s["name"]) for s in spans or ()
             if s["parent"] is not None]
    by_program = devtrace.reduce_trace(path, marks_ns, inner)
    # the same trace and marks give the same gaps in the same order;
    # "loop" is reduce_trace's label where no span covers
    return [[h if p == "loop" else f"{h}:{p}", sec]
            for (h, sec), (p, _) in zip(by_harness["idle_gaps"],
                                        by_program["idle_gaps"])]
