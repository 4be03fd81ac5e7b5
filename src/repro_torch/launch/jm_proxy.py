"""One job-manager client for every rank of a launch.

A file or HTTP job manager has one client per job: the launch's rank 0
spawns (or joins) the manager and holds the client; every other rank holds
a ``RankJobManager`` without one.  Each verb — ``request``, ``release``,
``fail``, ``steal``, ``poll_active`` (the client's ``num_active``), the
tenant verbs and the directive poll — runs on rank 0 and its answer is
broadcast over the launch, so every rank's engine binds, releases and
defers the same way: a
``JobManagerUnavailable`` (or a manager's rejection) on rank 0 is raised on
every rank.  The client-side mirrors a report reads (``log``,
``rpc_stats``, the breaker's counters, ``tenant``) travel with every
answer, and so do the fault records rank 0's chaos transport logged
during the call (``rpc_loss``, ``rpc_dup``): every rank's
``ChaosInjector`` holds them, so the ranks' fault logs are the same.  Every rank must call the verbs in the same order, which the
ranks' identical host loops do.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from repro_torch.cluster.rpc import JobManagerUnavailable


class _Breaker:
    """The breaker's counters as rank 0's client last reported them."""

    def __init__(self):
        self.state: Dict[str, int] = {}

    def state_dict(self) -> dict:
        return dict(self.state)


class RankJobManager:
    """A ``JobManagerClient`` whose calls run on ``root``'s ``inner``
    client (None on the other ranks) and reach every rank of ``comm``'s
    launch."""

    def __init__(self, inner, comm, rank: int, root: int = 0,
                 injector=None):
        self.inner = inner if rank == root else None
        self.comm, self.rank, self.root = comm, rank, root
        self.injector = injector
        self.log: List[str] = []
        self.rpc_stats: Dict[str, int] = {}
        self.breaker = _Breaker()
        self.tenant: Optional[str] = None

    def _call(self, verb: str, *args, **kw) -> Any:
        msg = None
        inj = self.injector
        if self.inner is not None:
            n0 = len(inj.records) if inj is not None else 0
            out = err = None
            try:
                # a verb, or a property of the client (``num_active``)
                fn = getattr(self.inner, verb)
                out = fn(*args, **kw) if callable(fn) else fn
            except JobManagerUnavailable as e:
                err = ("unavailable", str(e))
            except RuntimeError as e:
                err = ("rejected", str(e))
            inner = self.inner
            msg = {"out": out, "err": err, "log": list(inner.log),
                   "rpc_stats": dict(getattr(inner, "rpc_stats", {})),
                   "breaker": (inner.breaker.state_dict()
                               if hasattr(inner, "breaker") else {}),
                   "tenant": getattr(inner, "tenant", None),
                   "faults": (inj.records[n0:] if inj is not None
                              else [])}
        msg = self.comm.broadcast_object(msg, self.root)
        if self.inner is None and inj is not None:
            inj.records.extend(msg["faults"])
        self.log = msg["log"]
        self.rpc_stats = msg["rpc_stats"]
        self.breaker.state = msg["breaker"]
        self.tenant = msg["tenant"]
        if msg["err"] is not None:
            kind, text = msg["err"]
            if kind == "unavailable":
                raise JobManagerUnavailable(text)
            raise RuntimeError(text)
        return msg["out"]

    # -- JobManagerClient ------------------------------------------------
    def release(self, workers: Sequence[int]) -> List[int]:
        return self._call("release", [int(w) for w in workers])

    def request(self, n: int) -> List[int]:
        return self._call("request", int(n))

    def fail(self, worker: int) -> None:
        return self._call("fail", int(worker))

    def steal(self, n: int) -> List[int]:
        return self._call("steal", int(n))

    def poll_active(self) -> int:
        """The manager's ``num_active``.  A method here, not the client's
        property: it is a broadcast from rank 0 like every verb, so every
        rank of the launch must call it, in the same order."""
        return self._call("num_active")

    # -- tenant verbs ------------------------------------------------------
    def register_tenant(self, tenant_id: str, **kw) -> List[int]:
        return self._call("register_tenant", tenant_id, **kw)

    def yield_workers(self, workers: Sequence[int]) -> List[int]:
        return self._call("yield_workers", [int(w) for w in workers])

    def poll_cluster(self) -> Dict[str, int]:
        return self._call("poll_cluster")

    def cluster_metrics(self) -> dict:
        return self._call("cluster_metrics")

    def deregister(self) -> List[int]:
        return self._call("deregister")

    def close(self) -> None:
        """Rank 0 closes its client (a spawned manager is told to exit);
        no other rank talks to the manager."""
        if self.inner is not None:
            self.inner.close()
