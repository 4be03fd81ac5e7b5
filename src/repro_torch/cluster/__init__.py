"""The cluster control plane of the port, ported from ``repro.cluster``:

  service    — ControlPlane: off-thread profile→decide with a double-buffered
               stats mailbox and epoch-fenced plan application
  autoscaler — signal-driven shrink/grow policy (heartbeats + throughput
               watermark in training, queue depth / occupancy in serving)
  rpc        — JobManagerClient boundary: in-process WorkerPool wrapper and
               a file-backed manager in its own process
  scheduler  — ClusterScheduler: multi-tenant arbitration (priorities,
               steal/yield, safe-point preemption) above one WorkerPool
  http_rpc   — HTTP transport for the scheduler (stdlib http.server), so
               several runs in several processes contend over one manager

The names below resolve on first use (PEP 562): a manager process
(``python -m repro_torch.cluster.rpc`` / ``http_rpc``) imports only its
transport, the scheduler and the stdlib observability modules, never
torch or the controller.
"""
import importlib

_EXPORTS = {
    "Autoscaler": "autoscaler", "AutoscalerConfig": "autoscaler",
    "ScaleDecision": "autoscaler",
    "ControlPlane": "service", "DecisionPlan": "service",
    "StatsSnapshot": "service",
    "JobManagerClient": "rpc", "JobManagerUnavailable": "rpc",
    "CircuitBreaker": "rpc", "InProcessJobManager": "rpc",
    "FileJobManager": "rpc", "TenantVerbsMixin": "rpc",
    "serve_file_manager": "rpc", "spawn_file_manager": "rpc",
    "ClusterScheduler": "scheduler", "SchedulerInvariantError": "scheduler",
    "Tenant": "scheduler",
    "HttpJobManager": "http_rpc", "serve_http_manager": "http_rpc",
    "spawn_http_manager": "http_rpc",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
