"""Metrics registry, ported from ``repro.obs.metrics``: counters, gauges
and histograms behind one API, with Prometheus text exposition and a JSON
snapshot (``save``; ``RunSpec.obs.metrics_out``).

Stdlib-only — the job manager serves its ``GET /metrics`` page
(``scheduler_to_prometheus``) from this module without importing torch.
Metric identity is ``(name, sorted(labels))``; helps are attached on first
touch.  ``Session`` keeps one registry live in every run and, with
``obs.metrics_port``, exposes it at ``http://127.0.0.1:PORT/metrics``
(``serve_metrics``).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

SNAPSHOT_SCHEMA = "obs.metrics/1"

# latency-ish default buckets, seconds (also fine for fractions/counts)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def _key(name: str, labels: Dict[str, Any]) -> Tuple[str, tuple]:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(label_items: tuple) -> str:
    if not label_items:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in label_items)
    return "{%s}" % inner


class MetricsRegistry:
    """One process-local registry; thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, tuple], float] = {}
        self._gauges: Dict[Tuple[str, tuple], float] = {}
        self._hists: Dict[Tuple[str, tuple], Dict[str, Any]] = {}
        self._help: Dict[str, str] = {}
        self._buckets: Dict[str, tuple] = {}

    # -- write API ----------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, help: str = "",
            **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value
            if help:
                self._help.setdefault(name, help)

    def set(self, name: str, value: float, help: str = "",
            **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._gauges[k] = float(value)
            if help:
                self._help.setdefault(name, help)

    def observe(self, name: str, value: float, help: str = "",
                buckets: Optional[tuple] = None, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            bks = self._buckets.setdefault(name, buckets or DEFAULT_BUCKETS)
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = {"counts": [0] * (len(bks) + 1),
                                      "sum": 0.0, "count": 0}
            for i, b in enumerate(bks):
                if value <= b:
                    h["counts"][i] += 1
                    break
            else:
                h["counts"][-1] += 1
            h["sum"] += float(value)
            h["count"] += 1
            if help:
                self._help.setdefault(name, help)

    # -- read API -----------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            lines = []
            seen_type: Dict[str, str] = {}

            def head(name, mtype):
                if seen_type.get(name) != mtype:
                    seen_type[name] = mtype
                    if name in self._help:
                        lines.append(f"# HELP {name} {self._help[name]}")
                    lines.append(f"# TYPE {name} {mtype}")

            for (name, li), v in sorted(self._counters.items()):
                head(name, "counter")
                lines.append(f"{name}{_fmt_labels(li)} {_num(v)}")
            for (name, li), v in sorted(self._gauges.items()):
                head(name, "gauge")
                lines.append(f"{name}{_fmt_labels(li)} {_num(v)}")
            for (name, li), h in sorted(self._hists.items()):
                head(name, "histogram")
                bks = self._buckets[name]
                cum = 0
                for i, b in enumerate(bks):
                    cum += h["counts"][i]
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(li + (('le', _num(b)),))} {cum}")
                cum += h["counts"][-1]
                lines.append(
                    f"{name}_bucket{_fmt_labels(li + (('le', '+Inf'),))} "
                    f"{cum}")
                lines.append(f"{name}_sum{_fmt_labels(li)} {_num(h['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(li)} {h['count']}")
            return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able state dump (the CI artifact format, golden-pinned)."""
        with self._lock:
            def unkey(d):
                return [{"name": name, "labels": dict(li), "value": v}
                        for (name, li), v in sorted(d.items())]
            hists = []
            for (name, li), h in sorted(self._hists.items()):
                hists.append({"name": name, "labels": dict(li),
                              "buckets": list(self._buckets[name]),
                              "counts": list(h["counts"]),
                              "sum": h["sum"], "count": h["count"]})
            return {"schema": SNAPSHOT_SCHEMA,
                    "counters": unkey(self._counters),
                    "gauges": unkey(self._gauges),
                    "histograms": hists}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path


def _num(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


# ---------------------------------------------------------------------------
# scheduler -> Prometheus (the manager's GET /metrics)
# ---------------------------------------------------------------------------
def scheduler_to_prometheus(sched) -> str:
    """Render a ``ClusterScheduler``'s grant timeline + tenant state as
    Prometheus text.  Event counters are derived from the same ``events``
    list the ``metrics`` RPC verb returns, so scraped counters and the
    events stream can never disagree (asserted by the cluster smoke)."""
    reg = MetricsRegistry()
    for ev in sched.events:
        reg.inc("dynmo_scheduler_events_total",
                help="scheduler grant-timeline events by tenant and kind",
                tenant=ev["tenant"], event=ev["ev"])
    for t in sched.tenants.values():
        reg.set("dynmo_workers_granted", len(t.granted),
                help="workers currently granted to the tenant",
                tenant=t.tenant_id)
        reg.set("dynmo_tenant_priority", t.priority,
                help="tenant priority (higher steals first)",
                tenant=t.tenant_id)
        reg.set("dynmo_preempt_due", t.preempt_due,
                help="workers the tenant still owes to preemption",
                tenant=t.tenant_id)
    reg.set("dynmo_pool_active", sched.pool.total + sched.pool.spares,
            help="total workers in the shared pool (incl. spares)")
    return reg.to_prometheus()


# ---------------------------------------------------------------------------
# optional in-process /metrics endpoint (obs.metrics_port)
# ---------------------------------------------------------------------------
class _MetricsHandler(BaseHTTPRequestHandler):
    def do_GET(self):          # noqa: N802 (stdlib API)
        if self.path not in ("/metrics", "/"):
            self.send_response(404)
            self.end_headers()
            return
        body = self.server.registry.to_prometheus().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # quiet
        pass


def serve_metrics(registry: MetricsRegistry, port: int,
                  host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Expose ``registry`` at ``http://host:port/metrics`` on a daemon
    thread; caller shuts down with ``server.shutdown()``."""
    srv = ThreadingHTTPServer((host, port), _MetricsHandler)
    srv.registry = registry
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="obs-metrics").start()
    return srv
