"""Multi-tenant cluster scheduler: train and serve sharing one WorkerPool,
ported from ``repro.cluster.scheduler``.

The job-manager boundary (``cluster.rpc``) used to assume exactly one
Session per pool: workers a trainer released just sat in ``pool.released``
with nowhere to go.  ``ClusterScheduler`` is the arbitration layer above
the pool — N concurrent Sessions (*tenants*) register with a priority and
a desired worker ceiling, and the scheduler decides who holds what:

  * ``register`` — a tenant joins and receives its initial grant.
  * ``request``  — more workers, from free capacity only (never preempts).
  * ``steal``    — more workers NOW: free capacity first, then a
    **preemption directive** is posted against the lowest-priority tenant
    holding workers above its floor.  The victim learns about it at its
    next ``poll`` and shrinks at its next safe point (the trainer sees an
    externally-originated ``ResizePlan`` — same epoch-fence machinery as
    any controller plan); the workers it releases are
    *reserved* for the stealing tenant, not returned to the free set.
  * ``yield``    — a tenant hands workers back voluntarily (serving load
    dropped).  Freed workers first settle outstanding steals, then become
    an ``offer`` to the highest-priority tenant running below its ceiling
    (training absorbs them back off-peak).
  * ``poll``     — a tenant's directive mailbox: ``preempt`` (how many
    workers it must release) and ``offer`` (how many it could absorb).

Arbitration is by priority and marginal utility: a steal only preempts
strictly lower-priority tenants, victims are chosen lowest-priority-first
and — within a priority — the tenant whose marginal worker is least
utilized (largest grant relative to its floor) loses first.  Directives
are *level-triggered*: ``preempt`` is recomputed from live demand at every
poll, so a directive lost to an epoch fence on the tenant side is simply
re-delivered — never acked, never dropped.

``handle(req) -> resp`` is the transport-facing dispatch.  Both transports
serve the SAME scheduler through it — the file server (``cluster.rpc``,
the crash-tested test double) and the HTTP server (``cluster.http_rpc``,
the k8s-operator-shaped real thing) — so tenant semantics can never drift
between them.  Requests without a ``tenant`` field fall through to the
legacy single-Session pool ops unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.events import stamp_record
from repro_torch.runtime.fault_tolerance import WorkerPool


@dataclasses.dataclass
class Tenant:
    """One registered Session's standing with the scheduler."""
    tenant_id: str
    priority: int = 0
    kind: str = "train"            # "train" | "serve" (telemetry only)
    max_workers: int = 0           # ceiling for offers (0 = initial grant)
    min_workers: int = 1           # floor a steal can never push below
    granted: List[int] = dataclasses.field(default_factory=list)
    preempt_due: int = 0           # workers this tenant must still release
    reserved: List[int] = dataclasses.field(default_factory=list)
    # freed-by-preemption workers parked for THIS tenant's next request
    steal_owed: int = 0            # outstanding steal demand not yet granted
    # the thief's span context ({"trace_id","span_id"}) when its request
    # carried one: forwarded to the victim on poll
    preempt_cause: Optional[dict] = None

    def state_dict(self) -> dict:
        return {"tenant_id": self.tenant_id, "priority": self.priority,
                "kind": self.kind, "max_workers": self.max_workers,
                "min_workers": self.min_workers,
                "granted": sorted(self.granted),
                "preempt_due": self.preempt_due,
                "reserved": sorted(self.reserved),
                "steal_owed": self.steal_owed,
                "preempt_cause": self.preempt_cause}

    @classmethod
    def from_state(cls, sd: dict) -> "Tenant":
        return cls(tenant_id=sd["tenant_id"], priority=int(sd["priority"]),
                   kind=sd.get("kind", "train"),
                   max_workers=int(sd.get("max_workers", 0)),
                   min_workers=int(sd.get("min_workers", 1)),
                   granted=[int(w) for w in sd["granted"]],
                   preempt_due=int(sd.get("preempt_due", 0)),
                   reserved=[int(w) for w in sd.get("reserved", [])],
                   steal_owed=int(sd.get("steal_owed", 0)),
                   preempt_cause=sd.get("preempt_cause"))


class SchedulerInvariantError(RuntimeError):
    """The double-grant guard tripped: scheduler/pool bookkeeping claims a
    worker is in two places at once.  Always a bug, never load."""


class ClusterScheduler:
    """Owns the ``WorkerPool`` and arbitrates grants across tenants.

    Thread-safety is the transport's problem (the file server is a single
    loop; the HTTP server serializes ``handle`` under one lock) — this
    class is deliberately lock-free and deterministic."""

    def __init__(self, pool: WorkerPool):
        self.pool = pool
        self.tenants: Dict[str, Tenant] = {}
        # grant-count timeline for utilization accounting (bench_cluster):
        # one record per worker transition, wall-stamped by the server
        self.events: List[dict] = []
        self._req_ctx: Optional[dict] = None   # requester's span context
        self._check()

    # -- telemetry ---------------------------------------------------------
    def _record(self, tenant: str, ev: str, worker: int) -> None:
        rec = {"t": time.time(), "tenant": tenant, "ev": ev,
               "worker": int(worker),
               "granted": {t.tenant_id: len(t.granted)
                           for t in self.tenants.values()}}
        # legacy "t"/"ev" keys stay (aliases); the unified fields ride
        # along — with the requester's span context as the trace identity
        # when the op carried one
        stamp_record(rec, source="scheduler", kind=ev, tracer=None,
                     ctx=self._req_ctx, wall=False)
        self.events.append(rec)

    # -- the double-grant guard ---------------------------------------------
    def _check(self) -> None:
        """A worker id granted to one tenant is never concurrently granted
        to another, reserved for anyone, or sitting in the pool's free/dead
        sets.  Runs after every mutating op — the pool is tiny, the check
        is O(workers)."""
        self.pool.check_consistent()
        seen: Dict[int, str] = {}
        for t in self.tenants.values():
            for w in list(t.granted) + list(t.reserved):
                if w in seen:
                    raise SchedulerInvariantError(
                        f"worker {w} held by both {seen[w]!r} and "
                        f"{t.tenant_id!r}")
                seen[w] = t.tenant_id
            for w in t.granted:
                if w not in self.pool.active:
                    raise SchedulerInvariantError(
                        f"worker {w} granted to {t.tenant_id!r} but not "
                        f"active in the pool")
            for w in t.reserved:
                if w not in self.pool.released:
                    raise SchedulerInvariantError(
                        f"worker {w} reserved for {t.tenant_id!r} but not "
                        f"released in the pool")

    # -- free capacity -----------------------------------------------------
    def _reserved_ids(self) -> set:
        return {w for t in self.tenants.values() for w in t.reserved}

    def _free(self) -> List[int]:
        """Released workers not reserved for a pending steal."""
        return sorted(set(self.pool.released) - self._reserved_ids())

    def _unassigned_active(self) -> set:
        """Active workers no tenant holds (the legacy single-Session pool
        starts fully active; a first-registering tenant must not treat
        those as its own)."""
        held = {w for t in self.tenants.values() for w in t.granted}
        return set(self.pool.active) - held

    # -- grant plumbing ----------------------------------------------------
    def _grant_to(self, t: Tenant, n: int) -> List[int]:
        """Grant up to ``n`` workers to ``t``: its reservation first, then
        the free set, then unassigned-active, then freshly-minted spares."""
        granted: List[int] = []
        while t.reserved and len(granted) < n:
            w = t.reserved.pop(0)
            self.pool.grant([w])
            granted.append(w)
        free = self._free()
        take = free[:n - len(granted)]
        if take:
            self.pool.grant(take)
            granted.extend(take)
        # active-but-unowned workers (pre-tenant pool stock) are claimable
        # without a pool transition — they are already provisioned
        for w in sorted(self._unassigned_active()):
            if len(granted) >= n:
                break
            granted.append(w)
        if len(granted) < n:
            granted.extend(self.pool.request(
                n - len(granted), exclude=self._reserved_ids()))
        t.granted.extend(granted)
        for w in granted:
            self._record(t.tenant_id, "grant", w)
        self._check()
        return granted

    def _settle_freed(self, victim: Tenant, workers: Sequence[int]) -> None:
        """Workers ``victim`` just released under preemption: park each on
        the reservation of whoever is owed a steal."""
        for w in workers:
            t = self._owed()
            if t is None:
                break
            t.reserved.append(int(w))
            self._record(t.tenant_id, "reserve", w)

    def _owed(self) -> Optional[Tenant]:
        """The tenant a freed worker should be reserved for: the highest-
        priority tenant with an unmet steal (reservation below its
        outstanding demand)."""
        for t in sorted(self.tenants.values(), key=lambda t: -t.priority):
            if t.steal_owed > len(t.reserved):
                return t
        return None

    # -- preemption --------------------------------------------------------
    def _assign_preemption(self, thief: Tenant, shortfall: int,
                           cause: Optional[dict] = None) -> int:
        """Post preemption directives worth ``shortfall`` workers against
        strictly-lower-priority tenants.  Victims: lowest priority first;
        within a priority, the tenant with the most workers above its floor
        (its marginal worker is the least useful).  Returns how many
        workers were actually assigned."""
        victims = sorted(
            (t for t in self.tenants.values()
             if t.priority < thief.priority and t is not thief),
            key=lambda t: (t.priority,
                           -(len(t.granted) - t.preempt_due
                             - t.min_workers)))
        assigned = 0
        for v in victims:
            headroom = len(v.granted) - v.preempt_due - v.min_workers
            take = min(headroom, shortfall - assigned)
            if take <= 0:
                continue
            v.preempt_due += take
            assigned += take
            if cause is not None:
                v.preempt_cause = dict(cause)
            self._record(v.tenant_id, "preempt_due", take)
            if assigned >= shortfall:
                break
        return assigned

    # -- ops ---------------------------------------------------------------
    def register(self, tenant_id: str, *, priority: int = 0,
                 kind: str = "train", workers: int = 0,
                 max_workers: Optional[int] = None,
                 min_workers: int = 1) -> List[int]:
        """Register (idempotent) and return the tenant's CURRENT grant —
        a re-register after a client retry sees the same workers."""
        t = self.tenants.get(tenant_id)
        if t is None:
            t = Tenant(tenant_id=tenant_id, priority=int(priority),
                       kind=kind,
                       max_workers=int(max_workers
                                       if max_workers is not None
                                       else workers),
                       min_workers=max(1, int(min_workers)))
            self.tenants[tenant_id] = t
            self._record(tenant_id, "register", -1)
            if workers:
                self._grant_to(t, int(workers))
        return sorted(t.granted)

    def deregister(self, tenant_id: str) -> List[int]:
        """The tenant's process is going away: everything it held returns
        to the free set (a yield of its full grant)."""
        t = self.tenants.pop(tenant_id, None)
        if t is None:
            return []
        freed = sorted(t.granted)
        self.pool.release(freed)
        for w in freed:
            self._record(tenant_id, "yield", w)
        # reservations it held go back to free too
        for w in t.reserved:
            self._record(tenant_id, "unreserve", w)
        self._check()
        return freed

    def request(self, tenant_id: str, n: int) -> List[int]:
        t = self.tenants[tenant_id]
        granted = self._grant_to(t, int(n))
        # a request that drained the reservation settles the steal ledger
        t.steal_owed = max(0, t.steal_owed - len(granted))
        return granted

    def steal(self, tenant_id: str, n: int) -> Dict[str, Any]:
        """Free capacity first; the shortfall becomes a preemption directive
        against lower-priority tenants.  Returns granted ids plus the
        number still pending (reserved-as-they-free, collect via a later
        ``request``)."""
        t = self.tenants[tenant_id]
        granted = self._grant_to(t, int(n))
        shortfall = int(n) - len(granted)
        pending = 0
        if shortfall > 0:
            pending = self._assign_preemption(t, shortfall,
                                              cause=self._req_ctx)
            t.steal_owed += pending
        if granted or pending:
            self._record(t.tenant_id, "steal",
                         granted[0] if granted else -1)
        self._check()
        return {"granted": granted, "pending": pending}

    def release(self, tenant_id: str, workers: Sequence[int]) -> List[int]:
        """Tenant-scoped release — a *yield* in multi-tenant vocabulary.
        Settles outstanding preemption first; the freed workers go to the
        stealer's reservation, the rest to the free set."""
        t = self.tenants[tenant_id]
        taken = [int(w) for w in workers if w in t.granted]
        for w in taken:
            t.granted.remove(w)
        self.pool.release(taken)
        settled = min(t.preempt_due, len(taken))
        t.preempt_due -= settled
        if t.preempt_due == 0:
            t.preempt_cause = None
        self._settle_freed(t, taken[:settled])
        for w in taken:
            self._record(t.tenant_id, "yield", w)
        self._check()
        return taken

    def fail(self, tenant_id: Optional[str], worker: int) -> None:
        w = int(worker)
        if tenant_id and tenant_id in self.tenants:
            t = self.tenants[tenant_id]
            if w in t.granted:
                t.granted.remove(w)
                # a death settles preemption debt like a release does — the
                # capacity is gone either way, don't shrink twice
                if t.preempt_due > 0:
                    t.preempt_due -= 1
            self._record(tenant_id, "fail", w)
        for t in self.tenants.values():
            if w in t.reserved:
                t.reserved.remove(w)
        self.pool.fail(w)
        self._check()

    def poll(self, tenant_id: str) -> Dict[str, int]:
        """Directive mailbox — recomputed from live state every time, so a
        directive the tenant fenced off is re-delivered, not lost."""
        t = self.tenants[tenant_id]
        offer = 0
        if len(t.granted) < t.max_workers and t.preempt_due == 0:
            # free capacity is offered to anyone below their ceiling; a
            # tenant under pressure doesn't wait for an offer — it steals
            offer = min(len(self._free()) + len(t.reserved),
                        t.max_workers - len(t.granted))
        out = {"preempt": t.preempt_due, "offer": offer}
        if t.preempt_due > 0 and t.preempt_cause is not None:
            # forward the thief's span context to the victim
            out["cause"] = dict(t.preempt_cause)
        return out

    # -- transport dispatch -------------------------------------------------
    def handle(self, req: dict) -> dict:
        """One request dict in, one response dict out — the shared body of
        the file and HTTP servers.  Ops without a ``tenant`` field keep the
        legacy single-Session pool semantics bit-for-bit."""
        op = req.get("op")
        tenant = req.get("tenant")
        # the requester's span context (shipped by the RPC transports)
        # scopes every record this op produces
        self._req_ctx = req.get("trace") if isinstance(
            req.get("trace"), dict) else None
        out: dict = {"op": op, "seq": req.get("seq")}
        try:
            if op == "release" and tenant:
                out["released"] = self.release(tenant, req["workers"])
            elif op == "yield" and tenant:
                out["released"] = self.release(tenant, req["workers"])
            elif op == "release":
                out["released"] = [int(w) for w in req["workers"]
                                   if w in self.pool.active]
                self.pool.release(req["workers"])
            elif op == "request" and tenant:
                out["granted"] = self.request(tenant, int(req["n"]))
            elif op == "request":
                out["granted"] = self.pool.request(
                    int(req["n"]), exclude=self._reserved_ids())
            elif op == "steal" and tenant:
                out.update(self.steal(tenant, int(req["n"])))
            elif op == "fail":
                self.fail(tenant, int(req["worker"]))
            elif op == "register" and tenant:
                out["granted"] = self.register(
                    tenant, priority=int(req.get("priority", 0)),
                    kind=req.get("kind", "train"),
                    workers=int(req.get("workers", 0)),
                    max_workers=req.get("max_workers"),
                    min_workers=int(req.get("min_workers", 1)))
            elif op == "deregister" and tenant:
                out["released"] = self.deregister(tenant)
            elif op == "poll" and tenant:
                out.update(self.poll(tenant))
            elif op == "metrics":
                out["events"] = list(self.events)
                out["tenants"] = {tid: t.state_dict()
                                  for tid, t in self.tenants.items()}
                out["total"] = self.pool.total + self.pool.spares
            elif op in ("status", "shutdown"):
                pass
            else:
                out["error"] = f"unknown op {op!r}"
        except KeyError as e:
            out["error"] = f"unknown tenant {e.args[0]!r} (register first)"
        finally:
            self._req_ctx = None
        out["active"] = self.pool.num_active
        return out

    # -- persistence (the file server's crash journal) ---------------------
    def state_dict(self) -> dict:
        return {"pool": self.pool.state_dict(),
                "tenants": [t.state_dict()
                            for t in self.tenants.values()]}

    @classmethod
    def from_state(cls, sd: dict) -> "ClusterScheduler":
        sched = cls(WorkerPool.from_state(sd["pool"]))
        for tsd in sd.get("tenants", []):
            t = Tenant.from_state(tsd)
            sched.tenants[t.tenant_id] = t
        sched._check()
        return sched
