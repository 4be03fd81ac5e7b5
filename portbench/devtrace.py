"""Reading a traced run: ``torch.profiler`` (device activity only, so the
profiler adds little host work) over a few steady steps of the window,
its Chrome trace written under the run's output directory and reduced
here to the device's busy time, kernel time by name, launches, and the
idle gaps labelled by the harness span the host was in.

The trace's times are on the host's wall clock (``baseTimeNanoseconds``
plus ``ts`` microseconds); the harness stamps the traced window's step
boundaries and its spans on the same clock (``time.time_ns``).  Device
time is the union of kernel, copy and fill intervals inside the
window."""
from __future__ import annotations

import bisect
import json
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from reference.formulas import KERNEL_IDS

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_PORT = re.compile(r"\b(" + "|".join(KERNEL_IDS) + r")\b")


def kernel_id(name: str) -> Optional[str]:
    """The port kernel (K1 .. K6) a device function belongs to, or None."""
    m = _PORT.search(name)
    return KERNEL_IDS[m.group(1)] if m else None


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(path: str, marks_ns: Sequence[int],
                 spans_ns: Sequence[Tuple[int, int, str]]
                 ) -> Optional[Dict[str, Any]]:
    """The summary of one Chrome trace between the first and the last of
    ``marks_ns`` (the traced steps' boundaries), or None when the window
    holds no device activity.  ``spans_ns``: the harness's host spans
    (start, end, name).  Times in seconds."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    w0, w1 = float(marks_ns[0]), float(marks_ns[-1])
    dev = []
    for e in doc.get("traceEvents", []):
        if e.get("cat") not in DEVICE_CATS or "ts" not in e:
            continue
        a = base + float(e["ts"]) * 1e3
        b = a + float(e.get("dur", 0)) * 1e3
        if b > w0 and a < w1:
            dev.append((a, b, e.get("name", ""), e["cat"]))
    if not dev:
        return None
    kernels: Dict[str, List[Any]] = {}
    for a, b, name, cat in dev:
        k = kernels.setdefault(name, [0, 0.0, cat])
        k[0] += 1
        k[1] += (min(b, w1) - max(a, w0)) * 1e-9
    busy_iv = _union([(max(a, w0), min(b, w1)) for a, b, _, _ in dev])
    busy = sum(b - a for a, b in busy_iv) * 1e-9
    gaps, prev = [], w0
    for a, b in busy_iv:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    spans = sorted(spans_ns)
    starts = [s[0] for s in spans]
    top = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy,
            "steps": len(marks_ns) - 1, "kernels": kernels,
            "idle_gaps": [[_label(spans, starts, a), (b - a) * 1e-9]
                          for a, b in top]}


def _label(spans, starts, t: float) -> str:
    """The harness span the host was in at ``t``; ``loop``: the training
    loop between the spans (controller stats, prune, data, events)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 8), -1):
        a, b, name = spans[j]
        if a <= t <= b:
            return name
    return "loop"


def breakdown(summary: Dict[str, Any]) -> Dict[str, Any]:
    ops = sorted(((n, v[1]) for n, v in summary["kernels"].items()),
                 key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": summary["idle_gaps"]}


def by_kernel(summary: Dict[str, Any]) -> Dict[str, List[float]]:
    """{K1 .. K6: [launches, seconds]} over the traced window."""
    out: Dict[str, List[float]] = {}
    for name, (n, s, cat) in summary["kernels"].items():
        kid = kernel_id(name) if cat == "kernel" else None
        if kid:
            v = out.setdefault(kid, [0, 0.0])
            v[0] += n
            v[1] += s
    return out
