"""The job-manager and telemetry plumbing the train and serve CLIs share —
the port of ``Session._connect_job_manager``, ``Session._register_tenant``
and the session's event stream (``--events-out``).

``connect`` returns a ``JobManager`` handle: its ``client`` is None for
``inproc`` (the engine wraps its own pool), a ``FileJobManager`` talking
to a manager process this run spawned for ``file``, and an
``HttpJobManager`` for ``http`` — on ``manager_url`` when one is given
(several runs contending over one shared manager, which this run never
shuts down), else on a private manager process it spawns.  A fresh
directory is made for every spawned manager: leftover request files of a
previous run would be replayed.  ``pool_state`` (a safe point's pool)
seeds the spawned manager's journal, so it starts from the crashed run's
topology.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import tempfile
from typing import Any, Dict, List, Optional

from repro_torch.cluster.http_rpc import HttpJobManager, spawn_http_manager
from repro_torch.cluster.rpc import FileJobManager, spawn_file_manager
from repro_torch.obs.events import stamp_record

JOB_MANAGERS = ("inproc", "file", "http")


@dataclasses.dataclass
class JobManager:
    """A connected job manager: the client, the manager process this run
    spawned (None for inproc and for a shared manager) and its
    directory."""
    kind: str
    client: Any = None
    proc: Optional[subprocess.Popen] = None
    run_dir: Optional[str] = None

    def kill(self) -> None:
        """Stop the manager process at once (the degraded-mode check: the
        engine defers its calls until ``respawn``)."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def respawn(self, workers: int, spares: int = 0) -> None:
        """Restart a killed file manager on its directory: it restores the
        pool from its journal and re-serves answered requests."""
        assert self.kind == "file" and self.run_dir is not None
        self.proc = spawn_file_manager(self.run_dir, workers, spares=spares)

    def close(self, engine=None) -> None:
        """Deliver bookkeeping deferred while the manager was down (best
        effort), deregister the tenant, shut a spawned manager down and
        wait for its process."""
        if engine is not None:
            engine._flush_pending_jm()
            engine.close()
        if self.client is not None:
            self.client.close()
        if self.proc is not None:
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def _fresh_dir(parent: Optional[str], prefix: str) -> str:
    if parent:
        os.makedirs(parent, exist_ok=True)
        return tempfile.mkdtemp(prefix="run_", dir=parent)
    return tempfile.mkdtemp(prefix=prefix)


def connect(kind: str, *, workers: int, spares: int = 0,
            job_manager_dir: Optional[str] = None,
            manager_url: Optional[str] = None,
            pool_state: Optional[dict] = None,
            rpc_timeout_s: float = 60.0) -> JobManager:
    """Connect the job manager ``kind`` (inproc | file | http) over a pool
    of ``workers`` (plus ``spares`` fresh ids)."""
    if kind not in JOB_MANAGERS:
        raise ValueError(f"job manager {kind!r} not in {JOB_MANAGERS}")
    if kind == "inproc":
        return JobManager(kind)
    if kind == "http" and manager_url:
        # a shared manager owned by someone else: never shut it down
        return JobManager(kind, HttpJobManager(manager_url,
                                               timeout_s=rpc_timeout_s,
                                               shutdown_on_close=False))
    run_dir = _fresh_dir(job_manager_dir,
                         "repro_torch_jm_" if kind == "file" else
                         "repro_torch_http_")
    if pool_state is not None:
        with open(os.path.join(run_dir, "state.json"), "w") as f:
            json.dump({"pool": pool_state, "answered": {}}, f)
    if kind == "http":
        proc, url = spawn_http_manager(run_dir, workers, spares=spares)
        return JobManager(kind, HttpJobManager(url, timeout_s=rpc_timeout_s,
                                               shutdown_on_close=True),
                          proc, run_dir)
    proc = spawn_file_manager(run_dir, workers, spares=spares)
    return JobManager(kind, FileJobManager(run_dir, timeout_s=rpc_timeout_s),
                      proc, run_dir)


class EventLog:
    """The run's structured telemetry stream: one record per log, resize,
    autoscale, tenant_register, preempt, absorb, steal, yield and summary
    event, in the reference's ``SessionEvent`` shape (``kind``, ``step``,
    ``data`` plus the unified event fields; no tracing identity: the port
    has no tracer yet)."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []

    def emit(self, kind: str, step: int, **data) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"kind": kind, "step": int(step),
                               "data": data}
        stamp_record(rec, source="session", kind=kind)
        self.events.append(rec)
        return rec

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.events, f, indent=1)


def register_tenant(jm: JobManager, tenant_id: Optional[str], *,
                    priority: int, kind: str, workers: int,
                    max_workers: int, min_workers: int,
                    log: EventLog) -> Optional[List[int]]:
    """Register this run with the cluster scheduler when a tenant id is
    given; returns the granted worker ids (to bind the engine onto), or
    None when running single-tenant."""
    if jm.client is None or not tenant_id:
        return None
    granted = jm.client.register_tenant(
        tenant_id, priority=priority, kind=kind, workers=workers,
        max_workers=max_workers, min_workers=min_workers)
    if not granted:
        raise RuntimeError(f"cluster scheduler granted no workers to "
                           f"tenant {tenant_id!r} (pool exhausted?)")
    log.emit("tenant_register", -1, tenant=tenant_id, priority=priority,
             tenant_kind=kind, granted=list(granted))
    return granted


def add_cluster_flags(ap) -> None:
    """The reference's shared cluster flags (``repro.api.cli._COMMON``)
    plus ``--events-out``."""
    a = ap.add_argument
    a("--job-manager", default="inproc", choices=list(JOB_MANAGERS),
      help="'file' puts the WorkerPool behind a file-RPC server in a "
           "separate process; 'http' behind the multi-tenant cluster "
           "scheduler's HTTP job manager")
    a("--job-manager-dir", default=None)
    a("--manager-url", default=None,
      help="attach to an already-running HTTP job manager "
           "(http://host:port) instead of spawning one")
    a("--tenant-id", default=None,
      help="register this run as a cluster tenant (requires "
           "--job-manager file|http)")
    a("--priority", type=int, default=0,
      help="tenant priority: a higher-priority tenant can steal workers "
           "from lower ones at their next safe point")
    a("--spares", type=int, default=0,
      help="spare workers the job manager can grant beyond the initial "
           "pool")
    a("--rpc-timeout-s", type=float, default=60.0,
      help="file / HTTP client: total retry budget per call")
    a("--events-out", default=None, metavar="PATH",
      help="write the run's structured telemetry stream (one JSON record "
           "per resize / autoscale / tenant event) to this file")


def check_cluster_flags(args) -> None:
    if args.tenant_id and args.job_manager == "inproc":
        raise ValueError("--tenant-id needs --job-manager file|http")
    if args.manager_url and args.job_manager != "http":
        raise ValueError("--manager-url needs --job-manager http")
    if args.spares < 0:
        raise ValueError(f"--spares must be >= 0, got {args.spares}")
