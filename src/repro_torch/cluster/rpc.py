"""Job-manager RPC boundary (paper §3.4.2), ported from
``repro.cluster.rpc``.

DynMo's elasticity assumes a job manager that can *take released workers
back* (and grant them again later).  ``JobManagerClient`` is the protocol
the elastic engine talks to; two implementations:

  * ``InProcessJobManager`` — wraps the in-process ``WorkerPool`` (the
    engine's default, zero overhead, same logs);
  * ``FileJobManager`` — a file-backed stub shaped like a k8s-operator /
    Ray autoscaler endpoint: each call serializes one request file into a
    shared directory and blocks for the matching response, written by a
    *separate process* running ``serve_file_manager`` (CLI:
    ``python -m repro_torch.cluster.rpc --dir D --workers N``).  Release/grant
    genuinely crosses a process boundary, which is what the multi-node
    story needs tested; swapping the file transport for HTTP/gRPC changes
    only this module.

Wire protocol: ``req-<seq>.json`` → ``resp-<seq>.json``, JSON objects,
atomically published via write-to-temp + ``os.replace`` so a reader never
observes a partial file.  Ops: ``status | release | request | fail |
shutdown``.  Every response carries the manager's view of the pool
(``active`` count) so the client can mirror it without extra round trips.

Failure model: the sequence number IS the idempotency key.
The client retries a timed-out call by re-publishing the SAME ``req-<seq>``
with exponential backoff + seeded jitter; the server journals every
executed response (plus the pool state it produced) into ``state.json``
*before* publishing it, so a retry — or a freshly respawned server after a
``kill -9`` — re-serves the stored response instead of re-executing the
op.  When the whole retry budget burns, ``JobManagerUnavailable`` (a
``TimeoutError``) surfaces and a client-side circuit breaker opens: calls
fail fast (training continues without scaling decisions) with a periodic
probe so a revived manager is rediscovered.

When a tracer is current (``obs.trace``), every request carries the
caller's span context under ``"trace"``: the scheduler attributes the op
to it and forwards a steal's context to the preempted tenant as
``cause``.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time
from typing import Dict, List, Optional, Protocol, Sequence, \
    runtime_checkable

from repro_torch.runtime.fault_tolerance import WorkerPool


class JobManagerUnavailable(TimeoutError):
    """The manager did not answer within the retry budget (or the circuit
    breaker is open).  Subclasses ``TimeoutError`` so callers that handled
    the raw timeout keep working; the elastic engine catches it and
    degrades — no scaling decision, training continues."""


class CircuitBreaker:
    """Count-based breaker (deterministic — no wall-clock cool-off): after
    ``trip_after`` consecutive call failures the circuit opens and calls
    fail fast; every ``probe_every``-th blocked call is let through as a
    probe, and one success closes the circuit again."""

    def __init__(self, trip_after: int = 2, probe_every: int = 4):
        self.trip_after = max(1, trip_after)
        self.probe_every = max(1, probe_every)
        self.failures = 0
        self.trips = 0
        self.fast_fails = 0
        self._blocked_since_probe = 0

    @property
    def open(self) -> bool:
        return self.failures >= self.trip_after

    def allow(self) -> bool:
        if not self.open:
            return True
        self._blocked_since_probe += 1
        if self._blocked_since_probe >= self.probe_every:
            self._blocked_since_probe = 0
            return True                   # probe
        self.fast_fails += 1
        return False

    def success(self) -> None:
        self.failures = 0
        self._blocked_since_probe = 0

    def failure(self) -> None:
        self.failures += 1
        if self.failures == self.trip_after:
            self.trips += 1

    def state_dict(self) -> dict:
        return {"failures": self.failures, "trips": self.trips,
                "fast_fails": self.fast_fails}


@runtime_checkable
class JobManagerClient(Protocol):
    """What the elastic engine needs from a job manager."""

    def release(self, workers: Sequence[int]) -> List[int]:
        """Hand workers back to the manager; returns those actually taken."""
        ...

    def request(self, n: int) -> List[int]:
        """Ask for up to ``n`` workers; returns the granted ids."""
        ...

    def fail(self, worker: int) -> None:
        """Report a dead worker (not released — gone)."""
        ...

    @property
    def num_active(self) -> int: ...

    def close(self) -> None: ...


class TenantVerbsMixin:
    """Multi-tenant verbs shared by the file and HTTP clients.  Once ``register_tenant`` has run, the plain ``release``/
    ``request`` verbs become tenant-scoped automatically (the payload
    carries the tenant id), so the elastic engine's existing release/grant
    hooks participate in scheduler arbitration without knowing it."""

    tenant: Optional[str] = None

    def _call(self, op: str, **payload) -> dict:  # provided by the client
        raise NotImplementedError

    def _tenant_kw(self) -> dict:
        return {"tenant": self.tenant} if self.tenant else {}

    def register_tenant(self, tenant_id: str, *, priority: int = 0,
                        kind: str = "train", workers: int = 0,
                        max_workers: Optional[int] = None,
                        min_workers: int = 1) -> List[int]:
        """Join the cluster; returns the initial grant.  Idempotent — a
        retried registration sees the tenant's current grant."""
        out = self._call("register", tenant=tenant_id,
                         priority=int(priority), kind=kind,
                         workers=int(workers),
                         max_workers=max_workers,
                         min_workers=int(min_workers))
        self.tenant = tenant_id
        return [int(w) for w in out["granted"]]

    def steal(self, n: int) -> List[int]:
        """Demand ``n`` workers NOW: whatever free capacity allows is
        granted immediately; the shortfall becomes a preemption directive
        against lower-priority tenants, and the victims' workers arrive
        reserved-for-us (collect with a later ``request``)."""
        out = self._call("steal", n=int(n), **self._tenant_kw())
        granted = [int(w) for w in out["granted"]]
        if hasattr(self, "log"):
            self.log.extend(f"grant:{w}" for w in granted)
        return granted

    def yield_workers(self, workers: Sequence[int]) -> List[int]:
        """Voluntarily hand workers back (load dropped) — a tenant-scoped
        release; freed workers settle pending steals first, then become
        offers to tenants below their ceiling."""
        out = self._call("yield", workers=[int(w) for w in workers],
                         **self._tenant_kw())
        released = [int(w) for w in out["released"]]
        if hasattr(self, "log"):
            self.log.extend(f"release:{w}" for w in released)
        return released

    def poll_cluster(self) -> Dict[str, int]:
        """Directive mailbox: ``{"preempt": k, "offer": m}`` — this tenant
        must release ``k`` workers at its next safe point / could absorb
        ``m`` free ones.  Level-triggered: re-delivered until acted on.
        ``cause`` (when present) is the thief's span context — the victim
        parents its preemption events on it so the cross-process
        steal→preempt→shrink chain correlates."""
        out = self._call("poll", **self._tenant_kw())
        return {"preempt": int(out.get("preempt", 0)),
                "offer": int(out.get("offer", 0)),
                "cause": out.get("cause")}

    def cluster_metrics(self) -> dict:
        """Scheduler event timeline + per-tenant grants (bench telemetry)."""
        return self._call("metrics")

    def deregister(self) -> List[int]:
        """Leave the cluster, releasing everything this tenant holds."""
        if not self.tenant:
            return []
        out = self._call("deregister", tenant=self.tenant)
        self.tenant = None
        return [int(w) for w in out.get("released", [])]


class InProcessJobManager:
    """A ``WorkerPool`` in this process behind the job-manager calls.  The
    engine's subscribe hooks and logs keep working unchanged."""

    def __init__(self, pool: WorkerPool):
        self.pool = pool

    def release(self, workers: Sequence[int]) -> List[int]:
        before = set(self.pool.released)
        self.pool.release(list(workers))
        return sorted(set(self.pool.released) - before)

    def request(self, n: int) -> List[int]:
        return self.pool.request(n)

    def fail(self, worker: int) -> None:
        self.pool.fail(worker)

    @property
    def num_active(self) -> int:
        return self.pool.num_active

    @property
    def log(self) -> List[str]:
        return self.pool.log

    def close(self) -> None:
        pass


def _atomic_write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


class FileJobManager(TenantVerbsMixin):
    """File-backed ``JobManagerClient``; the pool lives in the server
    process.  Calls are synchronous RPCs with a poll-for-response loop —
    release/grant are rare (resize-time only), so latency is irrelevant and
    the transport stays trivially debuggable (``ls`` the directory)."""

    def __init__(self, root: str, timeout_s: float = 30.0,
                 poll_s: float = 0.01, *, retries: int = 3,
                 backoff_s: float = 0.05, jitter_seed: int = 0,
                 breaker_after: int = 2, breaker_probe_every: int = 4,
                 shutdown_on_close: bool = True):
        self.root = root
        self.tenant = None
        self.shutdown_on_close = shutdown_on_close
        self.timeout_s = timeout_s       # TOTAL budget, split over retries
        self.poll_s = poll_s
        self.retries = max(1, retries)
        self.backoff_s = backoff_s
        self._jitter = random.Random(jitter_seed)
        self.breaker = CircuitBreaker(breaker_after, breaker_probe_every)
        # start past any leftover req/resp files (a reused directory):
        # colliding with a previous run's sequence numbers would read its
        # stale responses as answers to our requests
        self._seq = 0
        for name in os.listdir(root):
            if ((name.startswith("req-") or name.startswith("resp-"))
                    and name.endswith(".json")):
                try:
                    self._seq = max(self._seq,
                                    int(name.split("-", 1)[1][:-len(".json")]))
                except ValueError:
                    pass
        self._active: Optional[int] = None
        self.log: List[str] = []        # client-side mirror of transitions
        self.rpc_stats: Dict[str, int] = {"calls": 0, "retries": 0,
                                          "timeouts": 0}

    # -- transport hooks (a chaos transport overrides these) ---------------
    def _send(self, req_path: str, obj: dict, attempt: int) -> None:
        _atomic_write_json(req_path, obj)

    def _await(self, resp_path: str, deadline: float, attempt: int) -> dict:
        while not os.path.exists(resp_path):
            if time.monotonic() > deadline:
                raise TimeoutError(resp_path)
            time.sleep(self.poll_s)
        return _read_json(resp_path)

    def _call(self, op: str, **payload) -> dict:
        if not self.breaker.allow():
            raise JobManagerUnavailable(
                f"job manager circuit open ({self.breaker.failures} "
                f"consecutive failures): {op} skipped")
        self._seq += 1
        seq = self._seq
        self.rpc_stats["calls"] += 1
        req = os.path.join(self.root, f"req-{seq:06d}.json")
        resp = os.path.join(self.root, f"resp-{seq:06d}.json")
        obj = {"op": op, "seq": seq, **payload}
        # ship the caller's span context so the scheduler can attribute
        # this op (and forward a steal's context to its preemption victim)
        from repro_torch.obs.trace import current_tracer
        tr = current_tracer()
        if tr is not None:
            obj["trace"] = tr.rpc_ctx(op, transport="file", seq=seq)
        per_attempt = self.timeout_s / self.retries
        for attempt in range(self.retries):
            # retries re-publish the SAME sequence number: the server
            # dedups on it, so a retried-but-actually-executed op is
            # answered from its journal, never run twice
            self._send(req, obj, attempt)
            try:
                out = self._await(resp,
                                  time.monotonic() + per_attempt, attempt)
            except TimeoutError:
                self.rpc_stats["timeouts"] += 1
                if attempt + 1 < self.retries:
                    self.rpc_stats["retries"] += 1
                    # exponential backoff with seeded jitter: deterministic
                    # per client, still decorrelated across clients
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
        # withdraw the request before giving up: a server that comes back
        # later must not execute an op whose caller already moved on (a
        # stale ``request`` would leak its grant).  Best-effort — if the
        # server is mid-execution the journal dedup still applies.
        try:
            os.unlink(req)
        except OSError:
            pass
        self.breaker.failure()
        raise JobManagerUnavailable(
            f"job manager did not answer {op} (req {seq}) within "
            f"{self.timeout_s}s across {self.retries} attempts — is the "
            f"server process running on {self.root!r}?")

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
        """Last-known active count; -1 when the manager has never answered
        and is currently unreachable (telemetry must not raise in degraded
        mode — scaling decisions use the RPC ops, not this)."""
        if self._active is None:
            try:
                self._call("status")
            except JobManagerUnavailable:
                return -1
        return int(self._active)

    def close(self) -> None:
        # best-effort: a dead server must not stall shutdown for the full
        # RPC timeout, so the farewell uses its own short deadline
        prev = self.timeout_s
        self.timeout_s = min(prev, 2.0)
        try:
            if self.tenant:
                self.deregister()        # grants flow back to the pool
            if self.shutdown_on_close:
                # only the run that owns the manager process tears it
                # down; tenants of a shared manager just deregister
                self._call("shutdown")
        except (TimeoutError, OSError, RuntimeError):
            pass                         # server already gone — fine
        finally:
            self.timeout_s = prev


def serve_file_manager(root: str, workers: int, poll_s: float = 0.01,
                       idle_timeout_s: Optional[float] = None,
                       spares: int = 0) -> WorkerPool:
    """Serve one ``WorkerPool`` over the file protocol until a ``shutdown``
    request (or ``idle_timeout_s`` with no traffic).  Runs in its own
    process in tests; returns the final pool for inspection when called
    in-process.

    Crash-safety: before publishing any response the server journals
    ``{pool state, answered responses}`` into ``state.json`` (atomic
    replace).  A respawned server on the same directory restores the pool
    exactly where the dead one left it and re-serves journaled responses
    for retried sequence numbers — ops are executed at most once even
    across a ``kill -9``."""
    from repro_torch.cluster.scheduler import ClusterScheduler

    state_path = os.path.join(root, "state.json")
    answered: Dict[str, dict] = {}
    sched: Optional[ClusterScheduler] = None
    if os.path.exists(state_path):
        try:
            js = _read_json(state_path)
            # the journal keeps the "pool" key (a journal without tenants
            # restores with zero) plus the tenant ledger alongside
            sched = ClusterScheduler.from_state(
                {"pool": js["pool"], "tenants": js.get("tenants", [])})
            answered = dict(js["answered"])
        except (json.JSONDecodeError, OSError, KeyError):
            sched = None                 # torn/old journal: start fresh
    if sched is None:
        sched = ClusterScheduler(WorkerPool(workers, spares=spares))
    pool = sched.pool
    done: set = set(answered)
    last_traffic = time.monotonic()
    while True:
        names = sorted(n for n in os.listdir(root)
                       if n.startswith("req-") and n.endswith(".json"))
        for name in names:
            seq = name[len("req-"):-len(".json")]
            resp_path = os.path.join(root, f"resp-{seq}.json")
            if seq in done:
                # a client retry after response loss: re-publish the
                # journaled answer — the op itself is NOT re-executed
                if not os.path.exists(resp_path) and seq in answered:
                    _atomic_write_json(resp_path, answered[seq])
                continue
            if os.path.exists(resp_path):
                done.add(seq)            # answered by a previous server
                try:                     # keep it re-servable after resp
                    answered[seq] = _read_json(resp_path)   # file loss
                except (json.JSONDecodeError, OSError):
                    pass
                continue                 # — but never re-execute its op
            try:
                req = _read_json(os.path.join(root, name))
            except (json.JSONDecodeError, OSError):
                continue                 # writer mid-flight; next scan
            done.add(seq)
            last_traffic = time.monotonic()
            op = req.get("op")
            # op execution lives in ClusterScheduler.handle — the SAME
            # dispatch the HTTP transport serves, so tenant semantics
            # can't drift between transports
            out = sched.handle(req)
            # journal BEFORE publishing: if we die in between, the respawn
            # finds the executed op in the journal and re-serves it; if we
            # die before journaling, the resp was never visible and the
            # retried op re-executes against the pre-op pool state —
            # either way the op takes effect exactly once
            answered[seq] = out
            sd = sched.state_dict()
            _atomic_write_json(state_path, {"pool": sd["pool"],
                                            "tenants": sd["tenants"],
                                            "answered": answered})
            _atomic_write_json(resp_path, out)
            if op == "shutdown":
                return pool
        if (idle_timeout_s is not None
                and time.monotonic() - last_traffic > idle_timeout_s):
            return pool
        time.sleep(poll_s)


def spawn_file_manager(root: str, workers: int,
                       idle_timeout_s: float = 300.0,
                       spares: int = 0) -> subprocess.Popen:
    """Start the file job manager as a separate process (the RPC actually
    crosses a process boundary).  The idle timeout is a safety net so an
    orphaned server never outlives its job by much."""
    return subprocess.Popen(
        [sys.executable, "-c",
         "from repro_torch.cluster.rpc import main; main()", "--dir", root,
         "--workers", str(workers), "--idle-timeout",
         str(idle_timeout_s), "--spares", str(spares)],
        env={**os.environ,
             "PYTHONPATH": os.pathsep.join(
                 p for p in [os.environ.get("PYTHONPATH"),
                             os.path.dirname(os.path.dirname(
                                 os.path.dirname(
                                     os.path.abspath(__file__))))]
                 if p)})


def main() -> None:
    ap = argparse.ArgumentParser(description="file-backed job manager")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--workers", type=int, required=True)
    ap.add_argument("--poll", type=float, default=0.01)
    ap.add_argument("--idle-timeout", type=float, default=None)
    ap.add_argument("--spares", type=int, default=0,
                    help="fresh worker ids grantable beyond the released "
                         "set (new processes, not revivals)")
    args = ap.parse_args()
    pool = serve_file_manager(args.dir, args.workers, poll_s=args.poll,
                              idle_timeout_s=args.idle_timeout,
                              spares=args.spares)
    print(f"job manager done: active={pool.num_active} "
          f"released={sorted(pool.released)} dead={sorted(pool.dead)}")


if __name__ == "__main__":
    main()
