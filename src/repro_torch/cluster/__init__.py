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
"""
from repro_torch.cluster.autoscaler import (Autoscaler, AutoscalerConfig,
                                            ScaleDecision)
from repro_torch.cluster.http_rpc import (HttpJobManager,
                                          serve_http_manager,
                                          spawn_http_manager)
from repro_torch.cluster.rpc import (CircuitBreaker, FileJobManager,
                                     InProcessJobManager, JobManagerClient,
                                     JobManagerUnavailable, TenantVerbsMixin,
                                     serve_file_manager, spawn_file_manager)
from repro_torch.cluster.scheduler import (ClusterScheduler,
                                           SchedulerInvariantError, Tenant)
from repro_torch.cluster.service import (ControlPlane, DecisionPlan,
                                         StatsSnapshot)

__all__ = [
    "Autoscaler", "AutoscalerConfig", "ScaleDecision",
    "ControlPlane", "DecisionPlan", "StatsSnapshot",
    "JobManagerClient", "JobManagerUnavailable", "CircuitBreaker",
    "InProcessJobManager", "FileJobManager", "TenantVerbsMixin",
    "serve_file_manager", "spawn_file_manager",
    "ClusterScheduler", "SchedulerInvariantError", "Tenant",
    "HttpJobManager", "serve_http_manager", "spawn_http_manager",
]
