"""HTTP job-manager transport, ported from ``repro.cluster.http_rpc``.

The file transport (``cluster.rpc``) stays the crash-tested test double;
this module is the k8s-operator-shaped real thing: one
``ClusterScheduler`` served over plain HTTP (stdlib ``http.server`` +
``urllib`` — no dependencies), so N Sessions in N *processes* — or N
machines — contend over one pool.  Wire protocol: ``POST /rpc`` with a
JSON body ``{"op": ..., "seq": ..., "client": ..., ...}``; the response
is the scheduler's response dict.  ``GET /healthz`` answers liveness;
``GET /metrics`` renders the scheduler as Prometheus text
(``obs.metrics.scheduler_to_prometheus``), derived from the same events
list the ``metrics`` RPC verb returns.

Exactly-once semantics carry over from the file transport, reshaped for
many clients: the idempotency key is ``(client, seq)`` instead of the
bare sequence number (two tenants both on seq 1 must not collide).  The
server journals every executed response before replying; a client retry
re-sends the SAME ``(client, seq)`` and is answered from the journal, so
ops never execute twice even when the response was lost in flight.  All
scheduler access is serialized under one lock — arbitration stays
deterministic no matter how requests interleave on the wire.

The client (``HttpJobManager``) mirrors ``FileJobManager``: same retry/
backoff/circuit-breaker skeleton, same ``JobManagerClient`` surface plus
the ``TenantVerbsMixin`` verbs.  ``shutdown_on_close`` defaults to False
— tenants of a shared manager deregister on close; only the process that
spawned the manager tears it down.
"""
from __future__ import annotations

import argparse
import http.server
import json
import os
import random
import socketserver
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.rpc import (CircuitBreaker, JobManagerUnavailable,
                                     TenantVerbsMixin, _atomic_write_json,
                                     _read_json)
from repro_torch.cluster.scheduler import ClusterScheduler
from repro_torch.runtime.fault_tolerance import WorkerPool


class HttpJobManager(TenantVerbsMixin):
    """HTTP-backed ``JobManagerClient``: the pool lives behind a URL."""

    def __init__(self, url: str, timeout_s: float = 30.0, *,
                 retries: int = 3, backoff_s: float = 0.05,
                 jitter_seed: int = 0, breaker_after: int = 2,
                 breaker_probe_every: int = 4,
                 shutdown_on_close: bool = False,
                 client_id: Optional[str] = None):
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s       # TOTAL budget, split over retries
        self.retries = max(1, retries)
        self.backoff_s = backoff_s
        self._jitter = random.Random(jitter_seed)
        self.breaker = CircuitBreaker(breaker_after, breaker_probe_every)
        self.shutdown_on_close = shutdown_on_close
        # the (client, seq) pair is the idempotency key; the pid makes the
        # namespace unique per process even before register_tenant names us
        self.client_id = client_id or f"pid{os.getpid()}"
        self.tenant = None
        self._seq = 0
        self._active: Optional[int] = None
        self.log: List[str] = []         # client-side mirror of transitions
        self.rpc_stats: Dict[str, int] = {"calls": 0, "retries": 0,
                                          "timeouts": 0}

    # -- transport ---------------------------------------------------------
    def _roundtrip(self, obj: dict, deadline: float) -> dict:
        body = json.dumps(obj).encode()
        req = urllib.request.Request(
            self.url + "/rpc", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        budget = max(0.05, deadline - time.monotonic())
        with urllib.request.urlopen(req, timeout=budget) as resp:
            return json.loads(resp.read().decode())

    def _call(self, op: str, **payload) -> dict:
        if not self.breaker.allow():
            raise JobManagerUnavailable(
                f"job manager circuit open ({self.breaker.failures} "
                f"consecutive failures): {op} skipped")
        self._seq += 1
        seq = self._seq
        self.rpc_stats["calls"] += 1
        obj = {"op": op, "seq": seq, "client": self.client_id, **payload}
        # ship the caller's span context (client_id + seq ride along) so
        # the scheduler can attribute the op and forward a steal's context
        # to its preemption victim
        from repro_torch.obs.trace import current_tracer
        tr = current_tracer()
        if tr is not None:
            obj["trace"] = tr.rpc_ctx(op, transport="http",
                                      client=self.client_id, seq=seq)
        per_attempt = self.timeout_s / self.retries
        last_err: Optional[Exception] = None
        for attempt in range(self.retries):
            # retries re-send the SAME (client, seq): the server dedups on
            # it, so a retried-but-actually-executed op is answered from
            # its journal, never run twice
            try:
                out = self._roundtrip(obj,
                                      time.monotonic() + per_attempt)
            except (urllib.error.URLError, OSError, TimeoutError,
                    ConnectionError) as e:
                last_err = e
                self.rpc_stats["timeouts"] += 1
                if attempt + 1 < self.retries:
                    self.rpc_stats["retries"] += 1
                    time.sleep(self.backoff_s * (2 ** attempt)
                               * (1.0 + self._jitter.random()))
                continue
            self.breaker.success()
            if "active" in out:
                self._active = int(out["active"])
            if out.get("error"):
                raise RuntimeError(
                    f"job manager rejected {op}: {out['error']}")
            return out
        self.breaker.failure()
        raise JobManagerUnavailable(
            f"job manager did not answer {op} (seq {seq}) within "
            f"{self.timeout_s}s across {self.retries} attempts — is the "
            f"server at {self.url!r} up? ({last_err!r})")

    # -- JobManagerClient --------------------------------------------------
    def release(self, workers: Sequence[int]) -> List[int]:
        out = self._call("release", workers=[int(w) for w in workers],
                         **self._tenant_kw())
        released = [int(w) for w in out["released"]]
        self.log.extend(f"release:{w}" for w in released)
        return released

    def request(self, n: int) -> List[int]:
        out = self._call("request", n=int(n), **self._tenant_kw())
        granted = [int(w) for w in out["granted"]]
        self.log.extend(f"grant:{w}" for w in granted)
        return granted

    def fail(self, worker: int) -> None:
        self._call("fail", worker=int(worker), **self._tenant_kw())
        self.log.append(f"fail:{worker}")

    @property
    def num_active(self) -> int:
        if self._active is None:
            try:
                self._call("status")
            except JobManagerUnavailable:
                return -1
        return int(self._active)

    def close(self) -> None:
        prev = self.timeout_s
        self.timeout_s = min(prev, 2.0)
        try:
            if self.tenant:
                self.deregister()        # grants flow back to the pool
            if self.shutdown_on_close:
                self._call("shutdown")
        except (TimeoutError, OSError, RuntimeError):
            pass                         # server already gone — fine
        finally:
            self.timeout_s = prev


class _SchedulerHTTPServer(socketserver.ThreadingMixIn,
                           http.server.HTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, handler, sched: ClusterScheduler,
                 state_path: Optional[str]):
        super().__init__(addr, handler)
        self.sched = sched
        self.state_path = state_path
        self.lock = threading.Lock()     # serializes ALL scheduler access
        self.answered: Dict[str, dict] = {}
        self.last_traffic = time.monotonic()
        self.shutting_down = False


class _Handler(http.server.BaseHTTPRequestHandler):
    server: _SchedulerHTTPServer

    def log_message(self, fmt, *args):   # quiet; the journal is the log
        pass

    def _reply(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            with self.server.lock:
                self._reply(200, {"ok": True,
                                  "active": self.server.sched.pool
                                  .num_active})
        elif self.path == "/metrics":
            # Prometheus text exposition derived from the SAME events list
            # the `metrics` RPC verb returns — scraped counters can never
            # disagree with the events stream
            from repro_torch.obs.metrics import scheduler_to_prometheus
            with self.server.lock:
                body = scheduler_to_prometheus(self.server.sched).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": "not found"})

    def do_POST(self):
        if self.path != "/rpc":
            self._reply(404, {"error": "not found"})
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n).decode())
        except (ValueError, json.JSONDecodeError):
            self._reply(400, {"error": "bad request body"})
            return
        key = f"{req.get('client', '?')}:{req.get('seq', '?')}"
        srv = self.server
        with srv.lock:
            srv.last_traffic = time.monotonic()
            if key in srv.answered:
                # client retry after response loss: re-serve the journaled
                # answer — the op is NOT re-executed
                self._reply(200, srv.answered[key])
                return
            out = srv.sched.handle(req)
            # journal BEFORE replying (same exactly-once contract as the
            # file transport): a crash between journal and reply makes the
            # retry hit the journal, not the scheduler
            srv.answered[key] = out
            if srv.state_path:
                sd = srv.sched.state_dict()
                _atomic_write_json(srv.state_path,
                                   {"pool": sd["pool"],
                                    "tenants": sd["tenants"],
                                    "answered": srv.answered})
            if req.get("op") == "shutdown":
                srv.shutting_down = True
        self._reply(200, out)
        if srv.shutting_down:
            threading.Thread(target=srv.shutdown, daemon=True).start()


def serve_http_manager(workers: int, *, spares: int = 0,
                       host: str = "127.0.0.1", port: int = 0,
                       state_path: Optional[str] = None,
                       addr_file: Optional[str] = None,
                       idle_timeout_s: Optional[float] = None
                       ) -> WorkerPool:
    """Serve one ``ClusterScheduler`` over HTTP until a ``shutdown`` op
    (or ``idle_timeout_s`` with no traffic).  Binds ``port`` (0 = pick a
    free one) and, when ``addr_file`` is given, atomically publishes
    ``{"url": ...}`` there so a spawning parent can discover the address.
    Returns the final pool for inspection when called in-process."""
    sched: Optional[ClusterScheduler] = None
    if state_path and os.path.exists(state_path):
        try:
            js = _read_json(state_path)
            sched = ClusterScheduler.from_state(
                {"pool": js["pool"], "tenants": js.get("tenants", [])})
        except (json.JSONDecodeError, OSError, KeyError):
            sched = None
    if sched is None:
        sched = ClusterScheduler(WorkerPool(workers, spares=spares))
    srv = _SchedulerHTTPServer((host, port), _Handler, sched, state_path)
    if state_path and os.path.exists(state_path):
        try:
            srv.answered = dict(_read_json(state_path).get("answered", {}))
        except (json.JSONDecodeError, OSError):
            pass
    url = f"http://{srv.server_address[0]}:{srv.server_address[1]}"
    if addr_file:
        _atomic_write_json(addr_file, {"url": url})
    stop_watchdog = threading.Event()
    if idle_timeout_s is not None:
        def _watchdog():
            while not stop_watchdog.wait(min(idle_timeout_s, 0.5)):
                with srv.lock:
                    idle = time.monotonic() - srv.last_traffic
                if idle > idle_timeout_s:
                    srv.shutdown()
                    return
        threading.Thread(target=_watchdog, daemon=True).start()
    try:
        srv.serve_forever(poll_interval=0.05)
    finally:
        stop_watchdog.set()
        srv.server_close()
    return sched.pool


def spawn_http_manager(run_dir: str, workers: int, *, spares: int = 0,
                       idle_timeout_s: float = 300.0,
                       startup_timeout_s: float = 20.0
                       ) -> Tuple[subprocess.Popen, str]:
    """Start the HTTP job manager as a separate process and return
    ``(proc, url)`` once it is accepting connections.  The idle timeout is
    a safety net so an orphaned server never outlives its job by much."""
    os.makedirs(run_dir, exist_ok=True)
    addr_file = os.path.join(run_dir, "addr.json")
    if os.path.exists(addr_file):
        os.unlink(addr_file)
    src_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from repro_torch.cluster.http_rpc import main; main()",
         "--workers", str(workers), "--spares", str(spares),
         "--port", "0", "--addr-file", addr_file,
         "--state", os.path.join(run_dir, "state.json"),
         "--idle-timeout", str(idle_timeout_s)],
        env={**os.environ,
             "PYTHONPATH": os.pathsep.join(
                 p for p in [os.environ.get("PYTHONPATH"), src_root]
                 if p)})
    deadline = time.monotonic() + startup_timeout_s
    while not os.path.exists(addr_file):
        if proc.poll() is not None:
            raise RuntimeError(
                f"http job manager died on startup (rc={proc.returncode})")
        if time.monotonic() > deadline:
            proc.kill()
            raise TimeoutError("http job manager never published its "
                               f"address to {addr_file!r}")
        time.sleep(0.02)
    url = _read_json(addr_file)["url"]
    return proc, url


def main() -> None:
    ap = argparse.ArgumentParser(description="HTTP job manager")
    ap.add_argument("--workers", type=int, required=True)
    ap.add_argument("--spares", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--addr-file", default=None)
    ap.add_argument("--state", default=None,
                    help="journal path for exactly-once crash recovery")
    ap.add_argument("--idle-timeout", type=float, default=None)
    args = ap.parse_args()
    pool = serve_http_manager(args.workers, spares=args.spares,
                              host=args.host, port=args.port,
                              state_path=args.state,
                              addr_file=args.addr_file,
                              idle_timeout_s=args.idle_timeout)
    print(f"job manager done: active={pool.num_active} "
          f"released={sorted(pool.released)} dead={sorted(pool.dead)}")


if __name__ == "__main__":
    main()
