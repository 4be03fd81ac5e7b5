"""The job-manager boundary the elastic engine talks to, ported from
``repro.cluster.rpc`` in its in-process form: ``InProcessJobManager`` wraps
a ``WorkerPool`` in this process.  It always answers, so the engine calls
it directly.  The file and HTTP managers (a pool in another process,
retries, a circuit breaker, ``JobManagerUnavailable`` and the engine's
deferred calls while one is unreachable) wait for ROADMAP Queue 1
[cluster]."""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.runtime.fault_tolerance import WorkerPool


class InProcessJobManager:
    """A ``WorkerPool`` in this process behind the job-manager calls."""

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
