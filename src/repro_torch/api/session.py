"""``Session`` — executes a ``RunSpec``; the runtime half of the API, ported
from ``repro.api.session``.

The trainer and the server share one lifecycle: build the engine ->
attach the ControlPlane -> attach the Autoscaler -> connect a job-manager
client -> tear everything down in the right order.  ``Session`` owns it:

    spec = RunSpec.load("configs/scenarios/early_exit.json")
    with Session(spec, device="cpu") as s:
        report = s.train()          # or s.serve()
    for ev in s.events:             # structured telemetry stream
        print(ev.kind, ev.step, ev.data)

``train`` / ``serve`` return the report dicts the CLIs print (every test
and ``chip_smoke.py`` read them); ``session.events`` is the structured
stream — one ``SessionEvent`` per resize / rebalance / relayout /
autoscale decision / safe point / log line / tenant event.  ``metrics``
is a ``MetricsRegistry`` kept live in every run (``obs.metrics_out``
saves it, ``obs.metrics_port`` serves it at ``GET /metrics``);
``obs.trace`` gives the run a ``Tracer`` (``session.tracer``, exported to
``obs.trace_out``) that is process-current while the run lasts, so the RPC
clients, the control plane and the fault injector stamp their spans and
events into it.  ``train`` looks the current tracer up as each step starts
(``obs.timing.step_tracer``), so a tracer made current or cleared from
``on_step`` traces from the next step on; while one is current every phase
of a step is a span (the loader's ``train.data``, the step's ``step.*``
with their device time, ``train.sync``, the prune, the decision and its
stats read-back, the migration, the hook, the log).  ``faults.enabled`` resolves the ``FaultSpec`` into a
``FaultPlan`` and fires it through a ``faults.ChaosInjector``
(``session.injector``): worker crashes, manager kills and respawns, RPC
loss / duplication / delay, straggler spikes and a trainer kill.

The port's differences from the reference:
  * ``device`` is a keyword, not a spec field: ``Session(spec,
    device=None)`` runs on the CUDA card and raises without one unless
    ``device="cpu"``; ``Session.resume(dir, step=None, device=None)``
    takes it the same way.
  * ``params`` (a converted reference tree, ``repro_torch.convert``)
    replaces the engine's own init: random streams do not cross
    frameworks, so this is how the tests hand both packages one init.
  * ``train(on_step=f)`` calls ``f(step, session)`` after each step's safe
    point, just after the fault injector fires (``kill_manager`` and
    ``respawn_manager`` are public for such a hook).
  * ``procs=N`` (``--procs N``) runs ``train`` as N processes, one per
    cell of the ``parallel.data x parallel.stages`` mesh of ranks
    (``launch.dist``; ``dist_backend`` forces ``gloo`` or ``nccl``).  Rank
    0's report comes back, with every rank's launches, memory, transfer
    counters, safe-point writes, restore and final role (active, released
    or dead) under ``ranks``; ``gather=True`` adds the final params and
    optimizer state gathered whole.  Resizes run across the ranks: a
    shrink or an evict releases a column of ranks (they hold nothing after
    it and stay in the host loop, deciding from the same gathered bytes),
    a grow binds one back.  A file or HTTP job manager has one client,
    rank 0's (``launch.jm_proxy``), whose RPC faults reach every rank's
    fault log.  Safe points are written per rank (the world's rank of each
    stage at data 0 writes its shard) and resume onto any rank count
    (``Session.resume(dir, procs=N)``); ``--chaos`` fires the same plan at
    the same step on every rank (a trainer kill ends every rank); the
    async control plane without the drain applies each plan at rank 0's
    step on every rank, each rank deciding it on its own thread.  ``serve`` with
    ``procs`` runs the elastic server as one rank per stage (data 1, as
    the reference's server): each rank holds its stage's rows of the paged
    KV pool, and a chaos worker crash evicts across the ranks.  In one
    process ``parallel.data > 1`` runs as one replica, which is
    numerically what the reference's data axis computes.  Every block
    family runs across the ranks (MoE with its live expert re-layout
    decided and committed on every rank; encoder–decoder, VLM, Mamba2 and
    xLSTM stages with their shared leaves and carries).

Teardown order matters and is centralized in ``close()``: the metrics
snapshot, then the control plane (its worker thread must stop deciding
against a dying engine), then the engine or server (deliver deferred
job-manager bookkeeping, detach pool hooks), then the job-manager client
(tells a spawned manager process to exit), then the process wait.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import tempfile
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

from repro_torch.api.specs import RunSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.events import EVENT_SCHEMA, stamp_record
from repro_torch.obs.metrics import MetricsRegistry


_NO_SPAN = contextlib.nullcontext()


def _span(tracer, name: str, step: int, cat: str = "train"):
    """A span of the training loop under the open one; a no-op (nothing
    built) without a tracer."""
    return _NO_SPAN if tracer is None else tracer.span(name, cat=cat,
                                                       step=step)


@dataclasses.dataclass
class SessionEvent:
    """One telemetry record: ``kind`` in {"log", "rebalance", "resize",
    "autoscale", "safepoint", "relayout", "serve_summary",
    "train_summary", "tenant_register", "preempt", "absorb", "steal",
    "yield"}; the last five are the multi-tenant cluster stream.

    Every record also carries the unified event fields
    (``schema`` / ``source`` / ``wall``) plus the tracing identity when
    the session has a tracer."""
    kind: str
    step: int
    data: Dict[str, Any]
    schema: str = EVENT_SCHEMA
    source: str = "session"
    wall: Optional[float] = None
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    parent_id: Optional[str] = None
    lc: Optional[int] = None
    cause_trace_id: Optional[str] = None


class Session:
    """Context manager that executes one ``RunSpec``."""

    def __init__(self, spec: RunSpec, *, device: DeviceLike = None,
                 params=None, procs: int = 1,
                 dist_backend: Optional[str] = None, gather: bool = False,
                 mesh=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.params = params
        self.procs = int(procs)
        self.dist_backend = dist_backend
        self.gather = gather
        # a rank's Session (launch.dist): its launch.mesh.Mesh
        self._mesh = mesh
        if self.procs > 1:
            p = spec.parallel
            if p.data * p.stages != self.procs:
                raise ValueError(
                    f"parallel.data x parallel.stages = {p.data} x "
                    f"{p.stages} = {p.data * p.stages} ranks, but procs="
                    f"{self.procs}: across processes every rank runs one "
                    f"cell of the data x model mesh")
        self.events: List[SessionEvent] = []
        self._cp = None          # cluster.service.ControlPlane
        self._engine = None      # launch.engine.ElasticEngine
        self._server = None      # serve.server.ElasticServer
        self._jm = None          # the job-manager client
        self._jm_proc: Optional[subprocess.Popen] = None
        self._jm_dir: Optional[str] = None
        self._closed = False
        self._resume_dir: Optional[str] = None
        self._resume_step: Optional[int] = None
        # across ranks: (the final world, params, moments) a train left
        self._final = None
        self.injector = None     # faults.ChaosInjector when chaos is on
        # ---- observability
        self.metrics = MetricsRegistry()   # always live; ~free when unread
        self.tracer = None                 # obs.trace.Tracer when obs.trace
        self._metrics_srv = None           # http server when obs.metrics_port

    @classmethod
    def resume(cls, ckpt_dir: str, *, step: Optional[int] = None,
               device: DeviceLike = None, procs: int = 1,
               dist_backend: Optional[str] = None,
               gather: bool = False) -> "Session":
        """Rebuild a crashed run from its newest complete safe point (or
        the one of ``step``).  The safe point carries the producing
        ``RunSpec``, so the caller needs nothing but the directory;
        ``train()`` then restores the tensors, the stage -> worker map, the
        pool and the control plane's latches and continues from the step
        after the safe point, bit-identically to the run that never
        stopped.  A safe point without a ``spec`` is refused by name.
        ``procs`` (as for a new Session) resumes as that many ranks,
        whatever rank count wrote the safe point."""
        from repro_torch.checkpoint.safepoint import peek
        idx = peek(ckpt_dir, step)
        spec = RunSpec.from_dict(idx["meta"]["spec"])
        s = cls(spec, device=device, procs=procs, dist_backend=dist_backend,
                gather=gather)
        s._resume_dir = ckpt_dir
        s._resume_step = int(idx["step"])
        return s

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._obs_end()
        if self._cp is not None:
            self._cp.close()
        if self._server is not None:
            self._server.close()
        elif self._engine is not None:
            # deliver bookkeeping deferred while the manager was down —
            # best effort; an unreachable manager must not block teardown
            self._engine._flush_pending_jm()
            self._engine.close()
        if self._jm is not None:
            self._jm.close()             # tells a spawned manager to exit
        if self._jm_proc is not None:
            try:
                self._jm_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._jm_proc.kill()
                self._jm_proc.wait()

    def _emit(self, kind: str, step: int, *, cause_ctx=None,
              **data) -> SessionEvent:
        rec: Dict[str, Any] = {}
        stamp_record(rec, source="session", kind=kind, tracer=self.tracer,
                     ctx=cause_ctx)
        ev = SessionEvent(kind, step, data, wall=rec.get("wall"),
                          trace_id=rec.get("trace_id"),
                          span_id=rec.get("span_id"),
                          parent_id=rec.get("parent_id"), lc=rec.get("lc"),
                          cause_trace_id=rec.get("cause_trace_id"))
        self.events.append(ev)
        return ev

    def write_events(self, path: str) -> None:
        """The structured stream as a JSON list (``--events-out``)."""
        with open(path, "w") as f:
            json.dump([dataclasses.asdict(ev) for ev in self.events], f,
                      indent=1)

    # -- observability lifecycle ---------------------------------------------
    def _obs_begin(self, mode: str):
        """Build the tracer and the metrics endpoint per ``spec.obs``.  The
        trace id derives from run identity (mode + tenant + seed), never
        pids or clocks, so a fixed-seed run's logical event sequence is
        reproducible."""
        obs = self.spec.obs
        if obs.trace:
            from repro_torch.obs.trace import Tracer, set_current_tracer
            if self.tracer is None:
                tenant = self.spec.cluster.tenant_id or "solo"
                self.tracer = Tracer(
                    f"{mode}-{tenant}-s{self.spec.seed}",
                    meta={"mode": mode, "tenant": tenant,
                          "seed": self.spec.seed})
            # deep layers (RPC clients, control plane, injector) find the
            # tracer here instead of through their constructors
            set_current_tracer(self.tracer)
        if obs.metrics_port and self._metrics_srv is None:
            from repro_torch.obs.metrics import serve_metrics
            self._metrics_srv = serve_metrics(self.metrics,
                                              obs.metrics_port)
        return self.tracer

    def _obs_end(self) -> None:
        obs = self.spec.obs
        if self._metrics_srv is not None:
            self._metrics_srv.shutdown()
            self._metrics_srv.server_close()
            self._metrics_srv = None
        if self.tracer is not None:
            if obs.trace_out:
                self.tracer.export(obs.trace_out)
            from repro_torch.obs.trace import (current_tracer,
                                               set_current_tracer)
            if current_tracer() is self.tracer:
                set_current_tracer(None)
        if obs.metrics_out:
            self.metrics.save(obs.metrics_out)

    # -- shared assembly ---------------------------------------------------
    def _model_config(self):
        from repro_torch.configs.base import get_config, reduced_config
        m = self.spec.model
        cfg = get_config(m.arch)
        if m.layers is not None:
            cfg = reduced_config(cfg, num_layers=m.layers, d_model=m.d_model,
                                 num_heads=m.num_heads,
                                 num_kv_heads=m.num_kv_heads,
                                 d_ff=m.d_ff or 2 * m.d_model,
                                 vocab_size=m.vocab_size)
        return cfg

    def _dist_config(self):
        from repro_torch.configs.base import DistConfig
        p = self.spec.parallel
        return DistConfig(num_stages=p.stages, slot_slack=p.slot_slack,
                          remat=p.remat, param_dtype=p.param_dtype,
                          kernel_impl=p.kernel_impl)

    def _fresh_dir(self, prefix: str) -> str:
        # always a FRESH directory (a unique subdir when the spec names a
        # location): leftover request files of an earlier run would be
        # replayed by the new manager and misread by the new client
        parent = self.spec.cluster.job_manager_dir
        if parent:
            os.makedirs(parent, exist_ok=True)
            return tempfile.mkdtemp(prefix="run_", dir=parent)
        return tempfile.mkdtemp(prefix=prefix)

    def _connect_job_manager(self, plan=None, injector=None,
                             pool_state=None):
        """The job-manager client (``_connect_one``); across ranks rank 0
        connects and every rank holds a ``launch.jm_proxy.RankJobManager``
        whose verbs run on rank 0's client."""
        mesh = self._mesh
        if mesh is None or self.spec.cluster.job_manager == "inproc":
            return self._connect_one(plan, injector, pool_state)
        from repro_torch.launch.jm_proxy import RankJobManager
        inner = (self._connect_one(plan, injector, pool_state)
                 if mesh.rank == 0 else None)
        self._jm = RankJobManager(inner, mesh.comm, mesh.rank,
                                  injector=injector)
        return self._jm

    def _connect_one(self, plan=None, injector=None, pool_state=None):
        """'file' spawns the WorkerPool server in a separate process and
        returns a client speaking atomic request / response JSON files to
        it; 'http' connects to ``cluster.manager_url`` when set (several
        Sessions in several processes contending over ONE manager, which
        this one never shuts down) or spawns a private HTTP manager;
        'inproc' returns None (the engine wraps its own pool).
        ``pool_state`` (from a safe point) is seeded into the fresh
        directory as the manager's journal, so the spawned manager starts
        from the crashed run's pool topology; with an RPC-chaos ``plan``
        the file client is the chaos transport."""
        from repro_torch.cluster.rpc import FileJobManager, spawn_file_manager
        c = self.spec.cluster
        if c.job_manager == "inproc":
            return None
        if c.job_manager == "http":
            from repro_torch.cluster.http_rpc import (HttpJobManager,
                                                      spawn_http_manager)
            if c.manager_url:
                self._jm = HttpJobManager(c.manager_url,
                                          timeout_s=c.rpc_timeout_s,
                                          shutdown_on_close=False)
                return self._jm
            run_dir = self._fresh_dir("repro_torch_http_")
        else:
            run_dir = self._fresh_dir("repro_torch_jm_")
        if pool_state is not None:
            with open(os.path.join(run_dir, "state.json"), "w") as f:
                json.dump({"pool": pool_state, "answered": {}}, f)
        self._jm_dir = run_dir
        if c.job_manager == "http":
            self._jm_proc, url = spawn_http_manager(
                run_dir, self.spec.parallel.stages, spares=c.spares)
            self._jm = HttpJobManager(url, timeout_s=c.rpc_timeout_s,
                                      shutdown_on_close=True)
            return self._jm
        self._jm_proc = spawn_file_manager(run_dir, self.spec.parallel.stages,
                                           spares=c.spares)
        if plan is not None and plan.any_rpc:
            from repro_torch.faults import ChaosFileJobManager
            self._jm = ChaosFileJobManager(run_dir, plan, injector,
                                           timeout_s=c.rpc_timeout_s)
        else:
            self._jm = FileJobManager(run_dir, timeout_s=c.rpc_timeout_s)
        return self._jm

    @property
    def server(self):
        """The ``ElasticServer`` of the last ``serve`` (its live state stays
        until ``close``)."""
        return self._server

    # the job manager seen from outside (``train(on_step=...)`` hooks)
    @property
    def job_manager(self):
        """The connected job-manager client (None for inproc)."""
        return self._jm

    @property
    def jm_dir(self) -> Optional[str]:
        """The spawned manager's directory (None for inproc / shared)."""
        return self._jm_dir

    def kill_manager(self) -> None:
        """Stop the spawned manager process at once: the engine defers its
        calls (degraded mode) until ``respawn_manager``.  Across ranks only
        rank 0 holds the manager: on the others it does nothing."""
        if self._jm_proc is not None and self._jm_proc.poll() is None:
            self._jm_proc.kill()
            self._jm_proc.wait()

    def respawn_manager(self) -> None:
        """Restart a killed file manager on its directory: it restores the
        pool from its journal and re-serves answered requests (rank 0's,
        across ranks: the others hold no manager)."""
        from repro_torch.cluster.rpc import spawn_file_manager
        if self._mesh is not None and self._mesh.rank != 0:
            return
        assert self.spec.cluster.job_manager == "file" and self._jm_dir
        self._jm_proc = spawn_file_manager(
            self._jm_dir, self.spec.parallel.stages,
            spares=self.spec.cluster.spares)

    def _register_tenant(self, jm, *, kind: str, workers: int,
                         max_workers: int, min_workers: int):
        """Register this Session with the cluster scheduler when the spec
        names a tenant.  Returns the granted worker ids (to bind the engine
        onto) or None when running single-tenant."""
        c = self.spec.cluster
        if jm is None or not c.tenant_id \
                or not hasattr(jm, "register_tenant"):
            return None
        granted = jm.register_tenant(
            c.tenant_id, priority=c.priority, kind=kind, workers=workers,
            max_workers=max_workers, min_workers=min_workers)
        if not granted:
            raise RuntimeError(
                f"cluster scheduler granted no workers to tenant "
                f"{c.tenant_id!r} (pool exhausted?)")
        self._emit("tenant_register", -1, tenant=c.tenant_id,
                   priority=c.priority, tenant_kind=kind,
                   granted=list(granted))
        return granted

    def _sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def _allocated(self) -> Optional[int]:
        """Bytes of live tensors on the card (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        import torch
        return torch.cuda.memory_allocated(self.device)

    def _mem(self) -> Dict[str, Any]:
        """``memory_allocated`` and ``memory_reserved`` (None on the CPU)
        and, across ranks, the rows and bytes moved so far."""
        out: Dict[str, Any] = {"allocated": self._allocated(),
                               "reserved": None}
        if self.device.type == "cuda":
            import torch
            out["reserved"] = torch.cuda.memory_reserved(self.device)
        if self._mesh is not None:
            st = self._mesh.comm.stats
            out.update({k: st[k] for k in ("rows_sent", "rows_recv",
                                           "bytes_sent", "bytes_recv")})
        return out

    # =======================================================================
    # Training
    # =======================================================================
    def train(self, steps: Optional[int] = None, *,
              on_step: Optional[Callable[[int, "Session"], None]] = None
              ) -> Dict[str, Any]:
        """Run the DynMo training loop for ``steps`` (default: spec.steps).
        ``on_step(step, session)`` runs after each step's safe point.
        Returns the report dict (losses, events, resizes, telemetry)."""
        if self.procs > 1 and self._mesh is None:
            return self._train_across(steps, on_step)
        import numpy as np

        from repro_torch.cluster.autoscaler import Autoscaler, AutoscalerConfig
        from repro_torch.cluster.service import (ControlPlane,
                                                 RankControlPlane,
                                                 StatsSnapshot)
        from repro_torch.core.controller import (ControllerConfig,
                                                 DynMoController)
        from repro_torch.data.loader import DataConfig, make_loader
        from repro_torch.dynamics import pruning as prn
        from repro_torch.dynamics.trajectories import zhu_gupta_sparsity
        from repro_torch.launch.engine import ElasticEngine
        from repro_torch.obs.timing import release_profile_tracer, step_tracer
        from repro_torch.optim.schedule import cosine_schedule
        from repro_torch.pipeline.pipeline import PipelineShapes
        from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                         StragglerDetector,
                                                         WorkerPool)

        spec = self.spec
        obs = spec.obs
        mesh = self._mesh

        def leader_dt() -> float:
            # across ranks every input of a decision is the same bytes on
            # every rank: a step's wall time is the world leader's
            if mesh is None:
                return step_times[-1]
            return float(mesh.comm.all_gather_object(
                step_times[-1])[engine.mesh.leader])
        self._obs_begin("train")
        mreg = self.metrics
        steps = steps if steps is not None else spec.steps
        stages = spec.parallel.stages
        seq = spec.parallel.seq
        dynamism = spec.dynamics.kind
        straggler = spec.controller.straggler
        measure_stage_times = spec.controller.measure_stage_times
        repack_target = spec.controller.repack.target
        grow_back = spec.cluster.grow_back
        if grow_back is not None:
            warnings.warn(
                "cluster.grow_back / --grow-back is deprecated: fixed-step "
                "re-expansion is superseded by signal-driven scaling "
                "(cluster.autoscale / --autoscale)", DeprecationWarning,
                stacklevel=2)

        cfg = self._model_config()
        dcfg = self._dist_config()
        dyncfg = spec.dynamics.to_config()
        # the loader's VLM patches / whisper frames ride the batch into the
        # pipeline, so the shapes carry the arch's prefix and encoder length
        shapes = PipelineShapes.for_model(cfg, spec.parallel.num_micro,
                                          spec.parallel.mb_global, seq)
        tokens_per_step = (spec.parallel.num_micro
                           * spec.parallel.mb_global * seq)

        # ---- resume point (safe-point metadata drives everything below)
        resume_idx = None
        start_step = 0
        if self._resume_dir:
            from repro_torch.checkpoint.safepoint import peek
            # a rank reads the index of the step its parent resolved, and
            # verifies only the files it restores from
            resume_idx = peek(self._resume_dir, self._resume_step,
                              verify=mesh is None)
            start_step = int(resume_idx["step"]) + 1
        rmeta = resume_idx["meta"] if resume_idx is not None else {}

        # ---- chaos: resolve the fault plan before anything it may target
        # (named fplan — the controller's DecisionPlan is ``plan`` inside
        # the step loop)
        fplan = injector = None
        if spec.faults.enabled:
            from repro_torch.faults import ChaosInjector, resolve_plan
            if spec.faults.worker_crash and not spec.cluster.autoscale:
                raise ValueError(
                    "faults.worker_crash requires cluster.autoscale: the "
                    "heartbeat -> autoscaler -> evict pipeline IS the "
                    "recovery path chaos exercises")
            fplan = resolve_plan(
                spec.faults, horizon=steps,
                workers=(stages if spec.cluster.autoscale else 1),
                file_manager=spec.cluster.job_manager == "file")
            injector = ChaosInjector(fplan, start_step=start_step,
                                     resumed=resume_idx is not None)
            self.injector = injector

        jm = self._connect_job_manager(
            plan=fplan, injector=injector,
            pool_state=(rmeta.get("pool")
                        if spec.cluster.job_manager == "file" else None))
        pool = None
        if jm is None and resume_idx is None and spec.cluster.spares:
            pool = WorkerPool(stages, spares=spec.cluster.spares)
        engine = ElasticEngine(cfg, dcfg, dyncfg, shapes, pool=pool,
                               job_manager=jm, device=self.device,
                               in_step_timing=obs.in_step_timing, mesh=mesh)
        self._engine = engine
        if injector is not None:
            import signal
            cbs = {}
            if any(e.kind == "trainer_kill" for e in fplan.events):
                # bound only when the plan kills this process: a library
                # caller's process never holds a SIGKILL it did not ask for.
                # Across ranks every rank fires it at the same step, so the
                # whole launch ends
                cbs["kill_self"] = lambda: os.kill(os.getpid(),
                                                   signal.SIGKILL)
            if spec.cluster.job_manager == "file":
                cbs["kill_manager"] = self.kill_manager
                cbs["respawn_manager"] = self.respawn_manager
            injector.bind(**cbs)
        restore_s = restore_mem = None
        if resume_idx is not None:
            # rebuild the world the run was in at its safe point (stage
            # count, split, workers, pool, epoch) and load the shards
            t_restore = time.perf_counter()
            state = engine.restore_state(self._resume_dir, resume_idx)
            self._sync()
            restore_s = time.perf_counter() - t_restore
            restore_mem = self._allocated()
            if mesh is not None:
                check_agreement(mesh, start_step - 1, state.lps,
                                state.assignment, engine, injector)
        else:
            granted = self._register_tenant(
                jm, kind="train", workers=stages, max_workers=stages,
                min_workers=max(1, repack_target))
            if granted is not None:
                # train on exactly the granted workers (arbitrary ids:
                # another tenant may hold 0..k)
                engine.bind_workers([int(w) for w in granted])
            state = engine.init_state(
                spec.seed, with_opt=True, params=self.params,
                stages=len(granted) if granted is not None else None)

        ccfg = ControllerConfig(method=spec.controller.balancer,
                                rebalance_every=spec.controller
                                .rebalance_every,
                                repack=spec.controller.repack.enabled,
                                repack_policy=spec.controller.repack.policy,
                                repack_target=max(1, repack_target),
                                expert_relayout=dyncfg.expert_relayout,
                                expert_watermark=dyncfg.expert_watermark,
                                expert_min_tokens=dyncfg.expert_min_tokens)
        if spec.controller.repack.enabled:
            # per-worker memory budget: the capacity factor x the per-stage
            # footprint of the UNPRUNED model under a uniform split, so a
            # consolidation becomes feasible once dynamism shrinks the model
            from repro_torch.core.cost_model import stage_memory_budget
            ccfg.repack_mem_cap = stage_memory_budget(
                cfg, tokens_per_step, seq, dcfg.bytes_per_param, stages,
                cap_factor=spec.controller.repack.mem_cap)
        if resume_idx is not None and rmeta.get("repack_enabled") is False:
            # the crashed run had latched repack off (a grow keeps the
            # granted workers): the resumed one must not plan a shrink
            ccfg.repack = False
        det = StragglerDetector(stages) \
            if (straggler or measure_stage_times) else None
        ctrl = DynMoController(cfg, dcfg, dyncfg, ccfg, straggler=det,
                               mesh=engine.mesh)
        if (mesh is not None and spec.controller.async_decide
                and not spec.controller.async_drain):
            # every rank applies each plan at rank 0's step, deciding it on
            # its own thread
            cp = RankControlPlane(ctrl, comm=mesh.comm, rank=mesh.rank,
                                  epoch_fn=lambda: engine.epoch)
        else:
            cp = ControlPlane(ctrl, async_mode=spec.controller.async_decide,
                              epoch_fn=lambda: engine.epoch)
        self._cp = cp
        if resume_idx is not None:
            cp.rebind(engine.dcfg_for(state.stages), state.lps)

        # ---- autoscaler: heartbeats (+ the throughput watermark); the
        # monitor runs on a step-granular clock, so a run is deterministic
        monitor = scaler = None
        sim_clock = [0.0]
        if spec.cluster.autoscale:
            monitor = HeartbeatMonitor(
                stages, timeout_s=spec.cluster.heartbeat_timeout,
                clock=lambda: sim_clock[0])
            scaler = Autoscaler(
                AutoscalerConfig(min_stages=max(1, repack_target),
                                 max_stages=stages,
                                 watermark=spec.cluster.autoscale_watermark),
                monitor)
            if resume_idx is not None and rmeta.get("scaler"):
                scaler.load_state(rmeta["scaler"])

        loader = make_loader(cfg, DataConfig(spec.parallel.num_micro,
                                             spec.parallel.mb_global, seq,
                                             seed=spec.seed),
                             start_step=start_step)
        ckpt = safept = None
        if spec.ckpt_every:
            from repro_torch.checkpoint.safepoint import SafepointManager
            safept = SafepointManager(spec.ckpt_dir, every=spec.ckpt_every)
        elif spec.ckpt_dir:
            from repro_torch.checkpoint.checkpoint import CheckpointManager
            ckpt = CheckpointManager(spec.ckpt_dir,
                                     every=max(10, steps // 5))
        resize_mem: List[Dict[str, Any]] = []

        def after_resize(step: int, kind: str, mem_before) -> None:
            cp.rebind(engine.dcfg_for(state.stages), state.lps,
                      mesh=engine.mesh)
            if scaler is not None:
                scaler.note_resize(step, state.stages)
            rz = engine.resizes[-1]
            if monitor is not None and rz.kind == "shrink":
                # released workers leave the heartbeat set deliberately; a
                # later revive is the recovery signal the autoscaler grows
                # on
                for w in rz.workers:
                    monitor.expire(w)
            if monitor is not None and rz.kind == "grow":
                # regranted workers must beat again (a later real death of
                # the same worker would otherwise go unseen)
                for w in rz.workers:
                    monitor.revive(w)
            self._emit("resize", step, resize_kind=kind,
                       from_stages=rz.from_stages, to_stages=rz.to_stages,
                       workers=list(rz.workers),
                       ticks_before=rz.ticks_before,
                       ticks_after=rz.ticks_after)
            after = self._mem()
            entry = {"step": step, "kind": rz.kind,
                     "allocated_before": mem_before["allocated"],
                     "allocated_after": after["allocated"]}
            if mesh is not None:
                # every rank's memory and transfers around the resize
                mine = {"rank": mesh.rank, "role": engine.role(),
                        "held_bytes": engine.held_bytes(state),
                        "seconds": rz.seconds,
                        **{f"{k}_before": mem_before[k]
                           for k in ("allocated", "reserved")},
                        **{f"{k}_after": after[k]
                           for k in ("allocated", "reserved")},
                        **{k: after[k] - mem_before[k]
                           for k in ("rows_sent", "rows_recv",
                                     "bytes_sent", "bytes_recv")}}
                entry["ranks"] = mesh.comm.all_gather_object(mine)
                check_agreement(mesh, step, state.lps, state.assignment,
                                engine, injector, ctrl.expert_layout)
            resize_mem.append(entry)
            active = engine.pool_active()      # every rank: a broadcast
            print(f"step {step:4d} {kind.upper()} {rz.from_stages}->"
                  f"{rz.to_stages} stages; workers {rz.workers}; "
                  f"pool active={active}; schedule "
                  f"{rz.ticks_before}->{rz.ticks_after} ticks", flush=True)

        # multi-tenant: poll the cluster scheduler's directive mailbox each
        # step (preempt = shrink at this safe point; offer = absorb free
        # workers back)
        multi_tenant = bool(jm is not None and spec.cluster.tenant_id
                            and getattr(jm, "tenant", None))
        tenant_min = max(1, repack_target)
        last_cluster_resize = start_step - 1
        absorb_cooldown = max(1, spec.controller.rebalance_every)

        losses, gnorms, events, step_times, stages_hist = [], [], [], [], []
        lps_hist: List[List[int]] = []
        # MoE: [step, expert skew, drop fraction] at each applied decision
        moe_hist: List[List[Any]] = []
        # across ranks: the bytes of state this rank held after each step
        held: List[int] = []
        exited_frac: Dict[int, float] = {}
        relayouts: List[Dict[str, Any]] = []
        expert_skew_last = moe_dropped_last = None
        last_measured = stage_time_source = None
        stage_times_log: List[Dict[str, Any]] = []
        safepoint_s: List[float] = []
        # the plans applied: [step, the snapshot's iteration, its epoch]
        applied: List[List[int]] = []
        # ---- step-time accounting: warm-up steps (the first step on each
        # freshly built world) and controller-cadence decide time are kept
        # apart from the steady-state step times
        warmup_steps, warmup_s, decide_s = 0, 0.0, 0.0
        steady_times: List[float] = []
        preempt_ctx = None
        # the step's tracer, and the root span open in it
        tracer = root_span = None
        t0 = time.perf_counter()
        for step in range(start_step, steps):
            cur = step_tracer()
            if cur is not tracer:
                if root_span is not None:
                    root_span.end(steps_run=len(losses))
                tracer = cur
                root_span = (tracer.span("train", cat="session",
                                         steps=steps, stages=stages)
                             if tracer is not None else None)
            with _span(tracer, "train.data", step):
                batch = next(loader)
            t_step = time.perf_counter()
            lr = cosine_schedule(step, steps, 3e-4, warmup=10)
            sp_step = (tracer.span("train.step", cat="train", step=step,
                                   stages=state.stages)
                       if tracer is not None else None)
            loss, stats, gnorm = engine.step(state, batch, lr)
            # one scalar sync for the loss curve; the per-slot stats stay
            # on the device until controller cadence (§3.3.1)
            with _span(tracer, "train.sync", step):
                losses.append(float(loss))
            if sp_step is not None:
                engine.read_step_spans(state)
                sp_step.end(compiled=engine.last_step_compiled)
            dt = time.perf_counter() - t_step
            step_times.append(dt)
            stages_hist.append(state.stages)
            lps_hist.append(list(state.lps))
            if engine.last_step_compiled:
                warmup_steps += 1
                warmup_s += dt
            else:
                steady_times.append(dt)
                mreg.observe("dynmo_step_seconds", dt,
                             help="steady-state train step wall seconds")
            mreg.inc("dynmo_train_steps_total",
                     help="train steps executed")
            mreg.set("dynmo_stages", state.stages,
                     help="current pipeline stage count")

            # ---- dynamism events (black-box to the controller)
            if dynamism == "pruning" and step and step % 10 == 0:
                with _span(tracer, "train.prune", step):
                    sp = zhu_gupta_sparsity(
                        step * 100, dataclasses.replace(
                            dyncfg, prune_start_iter=0,
                            prune_end_iter=steps * 100, prune_frequency=1))
                    keep = prn.target_keep_blocks(cfg, cfg.total_blocks(),
                                                  sp)
                    if engine.active():
                        state.dyn = {**state.dyn,
                                     "ff_mask": prn.global_block_prune(
                                         cfg, state.params["stages"],
                                         state.assignment["tags"], keep,
                                         mesh=engine.mesh)}
            if dynamism == "freezing" and step and step % 10 == 0:
                with _span(tracer, "train.freeze", step):
                    front = int(cfg.total_blocks() * min(0.6, step / steps))
                    tags_np = state.assignment["tags"].numpy()
                    fr = np.zeros(tags_np.shape, np.float32)
                    g = 0
                    for s in range(tags_np.shape[0]):
                        for l in range(tags_np.shape[1]):
                            if tags_np[s, l] != 0:
                                if g < front:
                                    fr[s, l] = 1.0
                                g += 1
                    if engine.active():
                        if mesh is not None:
                            fr = fr[engine.mesh.stage:engine.mesh.stage + 1]
                        state.dyn = {**state.dyn, "frozen":
                                     state.dyn["frozen"].new_tensor(fr)}

            # ---- heartbeats (simulated per-step liveness: active workers
            # beat; released / dead ones go silent and time out)
            if monitor is not None:
                with _span(tracer, "train.heartbeat", step):
                    sim_clock[0] = float(step)
                    beat = engine.stage_workers if injector is None \
                        else injector.heartbeat_workers(engine.stage_workers)
                    for w in beat:
                        monitor.beat(w)
                    if (spec.cluster.simulate_recover is not None
                            and step == spec.cluster.simulate_recover):
                        for w in range(stages):
                            if w not in engine.stage_workers:
                                monitor.revive(w)

            # ---- publish stats to the control plane on cadence (the only
            # device -> host stats sync; in async mode a pointer swap)
            if ctrl.cadence(step + 1):
                t_decide = time.perf_counter()
                wall_dt = leader_dt()
                sp_dec = (tracer.span("controller.decide", cat="controller",
                                      step=step)
                          if tracer is not None else None)
                measured = src = None
                if obs.in_step_timing:
                    # per-stage seconds of the live step's stage calls: no
                    # extra execution (the probe below stays available as
                    # the parity oracle)
                    measured = engine.in_step_stage_times(state)
                    if measured is not None:
                        src = "in_step"
                if measured is None and measure_stage_times:
                    # the isolated probe: a host sync per stage, so on
                    # cadence only
                    measured = engine.measure_stage_times(state, batch)
                    src = "probe"
                if measured is not None:
                    last_measured, stage_time_source = measured, src
                    stage_times_log.append({
                        "step": step, "source": src, "stages": state.stages,
                        "seconds": [float(x) for x in measured]})
                    for s in range(len(measured)):
                        mreg.set("dynmo_stage_time_seconds",
                                 float(measured[s]),
                                 help="per-stage busy seconds per step",
                                 stage=s, source=src)
                if straggler:
                    # simulation knob: a straggling WORKER multiplies its
                    # stage's time (the measured one when there is one,
                    # else the wall time split by layer counts); keyed by
                    # worker id, which keeps its slowness across resizes
                    if measured is None:
                        share = np.asarray(state.lps, np.float64)
                        measured = share / share.sum() * wall_dt
                    measured = measured * np.array(
                        [straggler.get(engine.stage_workers[s], 1.0)
                         for s in range(state.stages)])
                if injector is not None:
                    # chaos straggler spikes: the simulation knob's
                    # per-worker multiplier shape, from the fault plan
                    mult = injector.spike_for(engine.stage_workers)
                    if mult is not None:
                        if measured is None:
                            share = np.asarray(state.lps, np.float64)
                            measured = share / share.sum() * wall_dt
                        measured = measured * np.asarray(mult)
                with _span(tracer, "controller.stats", step,
                           cat="controller"):
                    host_stats = engine.stats_to_host(state, stats)
                    tags = state.assignment["tags"].numpy()
                    frozen = engine.gather_state(
                        state.dyn and state.dyn["frozen"]).cpu().numpy()
                cp.publish(StatsSnapshot(
                    iteration=step + 1, epoch=engine.epoch,
                    stats=host_stats, tags=tags,
                    num_micro=shapes.num_micro, tokens=tokens_per_step,
                    seq=seq, frozen=frozen, stage_times=measured))
                if spec.controller.async_drain:
                    cp.drain()
                if stage_times_log and stage_times_log[-1]["step"] == step \
                        and (spec.controller.async_drain
                             or not spec.controller.async_decide):
                    # the cost model's per-stage loads of this decision
                    stage_times_log[-1]["expected"] = cp.with_ctrl(
                        lambda c: c.expected_loads)
                decide_s += time.perf_counter() - t_decide
                if sp_dec is not None:
                    sp_dec.end(source=src)

            # ---- cluster-scheduler directives (multi-tenant): a steal by
            # a higher-priority tenant arrives as a preemption and becomes
            # an externally originated shrink in the same epoch-fenced
            # mailbox, applied at this step's safe point just below.
            # Level-triggered: a directive fenced off is re-delivered
            if multi_tenant:
                from repro_torch.cluster.rpc import JobManagerUnavailable
                try:
                    directives = jm.poll_cluster()
                except (JobManagerUnavailable, RuntimeError):
                    directives = None
                if directives and directives["preempt"] > 0:
                    target = max(tenant_min,
                                 state.stages - directives["preempt"])
                    if target < state.stages:
                        cp.inject_resize(engine.epoch, target)
                        last_cluster_resize = step
                        # the scheduler forwards the thief's span context
                        # ("cause"): parent this preemption on it so the
                        # cross-process steal→preempt→shrink chain
                        # correlates in the merged trace
                        cause = (directives.get("cause")
                                 if isinstance(directives, dict) else None)
                        self._emit("preempt", step, cause_ctx=cause,
                                   due=directives["preempt"],
                                   target_stages=target)
                        if tracer is not None:
                            preempt_ctx = tracer.instant(
                                "cluster.preempt", cat="cluster",
                                parent_id=(cause or {}).get("span_id"),
                                cause_trace_id=(cause or {}).get(
                                    "trace_id"),
                                due=directives["preempt"],
                                target_stages=target)
                elif (directives and directives["offer"] > 0
                        and state.stages < stages
                        and step - last_cluster_resize >= absorb_cooldown):
                    prev = state.stages
                    mem_before = self._mem()
                    state = engine.grow(
                        state, min(directives["offer"],
                                   stages - state.stages), step=step)
                    if state.stages > prev:   # the scheduler may grant none
                        cp.with_ctrl(
                            lambda c: setattr(c.ccfg, "repack", False))
                        after_resize(step, "absorb", mem_before)
                        self._emit("absorb", step,
                                   workers=state.stages - prev)
                        last_cluster_resize = step

            # ---- safe point: apply the newest finished plan (epoch-
            # fenced: a plan decided against a pre-resize world is
            # rejected)
            plan = cp.poll(engine.epoch)
            if plan is not None:
                applied.append([step, plan.iteration, plan.epoch])
                if plan.event is not None:
                    expert_skew_last = plan.event.expert_skew
                    moe_dropped_last = plan.event.expert_dropped
                    if cfg.num_experts:
                        moe_hist.append([step, expert_skew_last,
                                         moe_dropped_last])
                if plan.event is not None and plan.event.rebalanced:
                    events.append(plan.event)
                    self._emit("rebalance", step,
                               iteration=plan.event.iteration,
                               imbalance_before=plan.event.imbalance_before,
                               imbalance_after=plan.event.imbalance_after,
                               moved_layers=plan.event.moved_layers)
                if (plan.resize is not None
                        and plan.resize.target_stages < state.stages):
                    sp_rz = None
                    if tracer is not None:
                        parent = ((preempt_ctx or {}).get("span_id")
                                  if plan.resize.policy == "preempt"
                                  else None)
                        sp_rz = tracer.span(
                            "resize.shrink", cat="resize",
                            parent_id=parent, step=step,
                            policy=plan.resize.policy,
                            target=plan.resize.target_stages)
                    mem_before = self._mem()
                    state = engine.shrink(state, plan.resize.target_stages,
                                          plan.resize.layers_per_stage,
                                          step=step)
                    after_resize(step, f"shrink[{plan.resize.policy}]",
                                 mem_before)
                    mreg.inc("dynmo_resizes_total", kind="shrink",
                             policy=plan.resize.policy,
                             help="engine resizes by kind")
                    if sp_rz is not None:
                        sp_rz.end(stages=state.stages)
                        if plan.resize.policy == "preempt":
                            preempt_ctx = None
                elif plan.new_lps is not None:
                    with _span(tracer, "controlplane.apply", step,
                               cat="controller"):
                        (state.params, state.opt_state, state.dyn,
                         state.assignment, _) = cp.apply(
                            plan, state.params, state.opt_state, state.dyn)
                        state.lps = cp.with_ctrl(lambda c: list(c.lps))
                # expert re-layout: orthogonal to the stage plan above (it
                # rewrites only the expert_map dyn leaf).  Every rank
                # commits it to its controller and records it; only a rank
                # holding rows (a released one's dyn is None) rewrites its
                # expert_map row
                if plan.expert_relayout is not None:
                    rl = plan.expert_relayout
                    with _span(tracer, "moe.relayout", step,
                               cat="controller"):
                        if (state.dyn is not None
                                and "expert_map" in state.dyn):
                            em = state.dyn["expert_map"]
                            state.dyn = {**state.dyn,
                                         "expert_map": em.new_tensor(
                                             rl.new.as_array()).expand_as(
                                                 em).clone()}
                        cp.with_ctrl(lambda c: c.commit_relayout(rl))
                    rec = {"iteration": rl.iteration, "skew": rl.skew,
                           "tokens": rl.total_tokens,
                           "moved_experts": rl.moved_experts,
                           "placement": list(rl.new.placement)}
                    relayouts.append({"step": step, **rec})
                    # the step goes once, as the event's own field
                    self._emit("relayout", step, **rec)
                    print(f"step {step:4d} RELAYOUT skew {rl.skew:.2f} moved "
                          f"{rl.moved_experts} experts -> "
                          f"{list(rl.new.placement)}", flush=True)
            if mesh is not None and ctrl.cadence(step + 1):
                check_agreement(mesh, step, state.lps, state.assignment,
                                engine, injector, ctrl.expert_layout)

            # ---- autoscaler: heartbeat + watermark signals
            if scaler is not None:
                # "logical" clock: a schedule-derived step time (the tick
                # count) instead of the wall clock — deterministic
                if spec.cluster.watermark_clock == "logical":
                    wm_dt = engine.ticks(state.stages) * 1e-3
                else:
                    wm_dt = leader_dt()
                d = scaler.observe(step, wm_dt, state.stages,
                                   engine.stage_workers, tokens_per_step)
                if d.action != "none":
                    self._emit("autoscale", step, action=d.action,
                               workers=d.workers, reason=d.reason,
                               ids=list(d.ids))
                if d.action == "evict":
                    mem_before = self._mem()
                    state = engine.evict(state, d.ids, step=step)
                    after_resize(step, "evict", mem_before)
                elif d.action == "grow" and state.stages < stages:
                    prev = state.stages
                    mem_before = self._mem()
                    state = engine.grow(state, d.workers, step=step)
                    if state.stages > prev:   # the pool may grant nothing
                        # granted workers stay for this job: stop planning
                        # resizes so ordinary rebalancing keeps running
                        cp.with_ctrl(
                            lambda c: setattr(c.ccfg, "repack", False))
                        after_resize(step, "grow", mem_before)
                elif (d.action == "shrink"
                        and state.stages > max(1, repack_target)):
                    mem_before = self._mem()
                    state = engine.shrink(
                        state, max(max(1, repack_target),
                                   state.stages - d.workers), step=step)
                    after_resize(step, "shrink[watermark]", mem_before)

            # ---- legacy fixed-step growth (deprecated; superseded by
            # cluster.autoscale)
            if (grow_back and engine.last_shrink_step is not None
                    and state.stages < stages
                    and step >= engine.last_shrink_step + grow_back):
                prev_stages = state.stages
                mem_before = self._mem()
                state = engine.grow(state, stages - state.stages, step=step)
                if state.stages > prev_stages:
                    cp.with_ctrl(lambda c: setattr(c.ccfg, "repack", False))
                    after_resize(step, "grow", mem_before)
            # ---- checkpoints: after the step's resize and grow decisions
            if ckpt is not None:
                ckpt.maybe_save(step, state.params, state.opt_state,
                                state.dyn, state.lps,
                                mesh=None if mesh is None else engine.mesh)
            if safept is not None and safept.due(step):
                sp_ck = (tracer.span("safepoint", cat="checkpoint",
                                     step=step)
                         if tracer is not None else None)
                t_sp = time.perf_counter()
                path = safept.save(
                    step, state, spec=spec, engine=engine, scaler=scaler,
                    repack_enabled=cp.with_ctrl(
                        lambda c: bool(c.ccfg.repack)),
                    jm_dir=self._jm_dir)
                safepoint_s.append(time.perf_counter() - t_sp)
                if sp_ck is not None:
                    sp_ck.end(path=path)
                self._emit("safepoint", step, path=path,
                           stages=state.stages)
            if injector is not None:
                # fire scheduled faults AFTER the safe point: a trainer
                # kill at step k leaves the k-aligned safe point on disk
                # for Session.resume
                injector.on_step(step, workers=engine.stage_workers)
            if on_step is not None:
                with _span(tracer, "train.hook", step):
                    on_step(step, self)
            if mesh is not None:
                held.append(engine.held_bytes(state))
            with _span(tracer, "train.log", step):
                gnorms.append(float(gnorm))
                if step % spec.log_every == 0:
                    self._emit("log", step, loss=float(loss),
                               gnorm=float(gnorm), stages=state.stages,
                               lps=list(state.lps))
                    ee = ""
                    if "exited_frac" in stats:
                        # early exit's share of exited tokens: a host read
                        # on the log cadence only
                        exited_frac[step] = float(stats["exited_frac"])
                        ee = f" exited {exited_frac[step]:.4f}"
                    print(f"step {step:4d} loss {float(loss):.4f} "
                          f"gnorm {float(gnorm):.3f} S={state.stages} "
                          f"lps={state.lps}{ee}", flush=True)
        wall = time.perf_counter() - t0
        if root_span is not None:
            root_span.end(steps_run=len(losses))
        release_profile_tracer()
        if mesh is not None:
            # this rank's final rows and replicated leaves, as digests
            # (rank_train(digest=True))
            self._final = (engine.mesh, state.params, state.opt_state)
            # whole trees for the report (collective: every rank gathers)
            state.dyn = engine.gather_state(state.dyn)
            if self.gather:
                state.params = engine.gather_state(state.params, "params")
                state.opt_state = engine.gather_state(state.opt_state,
                                                      "opt")
            else:
                state.params = state.opt_state = None
        steady_s = float(sum(steady_times))
        steady_tok_s = (tokens_per_step * len(steady_times) / steady_s
                        if steady_s > 0 else None)
        if steady_tok_s is not None:
            mreg.set("dynmo_tokens_per_s", steady_tok_s,
                     help="steady-state training throughput")
        timing = {
            "warmup_steps": warmup_steps, "warmup_s": warmup_s,
            "decide_s": decide_s,
            "steady_steps": len(steady_times), "steady_s": steady_s,
            "steady_step_mean_s": (steady_s / len(steady_times)
                                   if steady_times else None),
            "steady_step_p50_s": (float(np.percentile(steady_times, 50))
                                  if steady_times else None),
            "steady_step_p95_s": (float(np.percentile(steady_times, 95))
                                  if steady_times else None),
            "steady_tokens_per_s": steady_tok_s,
            # safe points: seconds of each save (device -> host, npz,
            # sha256) and of the restore (verify, load, host -> device),
            # and torch.cuda.memory_allocated just after the restore
            "safepoint_s": safepoint_s, "restore_s": restore_s,
            "restore_allocated": restore_mem,
            # the safe point's files the restore read (across ranks: common
            # and this rank's own stage shard) and what this rank wrote of
            # each safe point (files, bytes, seconds)
            "restore_files": (list(engine.restored_files)
                              if resume_idx is not None else None),
            "safepoint_writes": (list(safept.writes)
                                 if safept is not None else []),
        }
        report = {
            "losses": losses, "gnorms": gnorms, "events": events,
            "wall_s": wall, "final_lps": list(state.lps),
            "params": state.params, "assignment": state.assignment,
            "dyn": state.dyn, "opt_state": state.opt_state,
            "tokens_per_step": tokens_per_step,
            "step_times": step_times, "stages_history": stages_hist,
            # the split each step ran on
            "lps_history": lps_hist,
            "resizes": [dataclasses.asdict(e) for e in engine.resizes],
            # the pool's transitions; behind an RPC boundary, the client's
            # mirror of them
            "pool_log": list(engine.jm.log),
            "final_stages": state.stages,
            # torch.cuda.memory_allocated around each resize (None on the
            # CPU)
            "resize_memory": resize_mem,
            "exited_frac": exited_frac,
            "steady_tokens_per_s": steady_tok_s,
            "measured_stage_times": (list(map(float, last_measured))
                                     if last_measured is not None else None),
            "stage_time_source": stage_time_source,
            # every cadence's measured per-stage seconds (and, when the
            # decision was waited for, the cost model's per-stage loads)
            "stage_times": stage_times_log,
            "timing": timing,
            "controller": {
                "mode": ("async" if spec.controller.async_decide
                         else "inline"),
                "published": cp.published, "decided": cp.decided,
                "dropped": cp.dropped,
                "stale_rejected": cp.stale_rejected, "applied": applied},
            # ---- expert-parallel telemetry (MoE archs; None otherwise)
            "relayouts": relayouts,
            "expert_skew_last": expert_skew_last,
            "moe_dropped_last": moe_dropped_last,
            "moe_history": moe_hist,
            "expert_layout": (list(ctrl.expert_layout.placement)
                              if ctrl.expert_layout is not None else None),
            "autoscale_decisions": ([dataclasses.asdict(d)
                                     for d in scaler.decisions]
                                    if scaler is not None else []),
            "spec": spec.to_dict(),
            # ---- fault tolerance
            "start_step": start_step,
            "resumed_from": (int(resume_idx["step"])
                             if resume_idx is not None else None),
            "safepoints": list(safept.saved) if safept is not None else [],
            "faults": injector.report() if injector is not None else [],
            "fault_plan": fplan.to_dict() if fplan is not None else None,
            "degraded_events": list(engine.degraded_events),
            "rpc": ({"stats": dict(jm.rpc_stats),
                     "breaker": jm.breaker.state_dict()}
                    if jm is not None else None),
            "device": str(self.device),
            # across ranks: this rank's role at the end and the bytes of
            # state it held after each step
            "role": engine.role() if mesh is not None else None,
            "held_bytes": held,
        }
        self._emit("train_summary", steps - 1,
                   loss_first=losses[0] if losses else None,
                   loss_last=losses[-1] if losses else None,
                   wall_s=wall, resizes=len(engine.resizes),
                   final_stages=state.stages)
        return report

    def _train_across(self, steps, on_step) -> Dict[str, Any]:
        """``train`` as ``procs`` ranks (``launch.dist.launch``): rank 0's
        report, its event stream as this Session's, and every rank's
        counters under ``ranks``."""
        from repro_torch.configs.base import get_config
        from repro_torch.launch.dist import launch
        resume = (None if self._resume_dir is None
                  else (self._resume_dir, self._resume_step))
        res = launch("repro_torch.api.session:rank_train", self.procs,
                     data=self.spec.parallel.data, device=self.device.type,
                     backend=self.dist_backend,
                     kwargs=dict(spec=self.spec, steps=steps,
                                 params=self.params, on_step=on_step,
                                 gather=self.gather, resume=resume,
                                 arch=get_config(self.spec.model.arch)))
        rep = res[0]["report"]
        self.events = res[0]["events"]
        rep["ranks"] = [r["rank"] for r in res]
        return rep

    # =======================================================================
    # Serving
    # =======================================================================
    def make_trace(self):
        """The request trace described by ``spec.serve`` (bursty square-wave
        arrivals, mixed prompt / gen lengths, optional early-exit
        fraction)."""
        from repro_torch.serve.requests import make_trace
        s = self.spec.serve
        cfg = self._model_config()
        return make_trace(s.requests, prompt_len=s.prompt_len,
                          max_gen=s.gen, vocab_size=cfg.vocab_size,
                          seed=self.spec.seed,
                          min_prompt=s.min_prompt or max(1,
                                                         s.prompt_len // 2),
                          burst_period=s.burst_period, burst_len=s.burst_len,
                          burst_rate=s.burst_rate, lull_rate=s.lull_rate,
                          early_exit_frac=s.early_exit_frac)

    def serve(self, trace=None, *, resize_at: Optional[Dict[int, int]] = None
              ) -> Dict[str, Any]:
        """Serve ``trace`` (default: the spec's generated trace) through the
        continuous-batching scheduler on elastic engine worlds.  Returns the
        server's report dict."""
        from repro_torch.cluster.autoscaler import Autoscaler, AutoscalerConfig
        from repro_torch.pipeline.pipeline import PipelineShapes
        from repro_torch.serve.server import ElasticServer

        spec = self.spec
        s = spec.serve
        if self.procs > 1 and self._mesh is None:
            return self._serve_across(trace, resize_at)
        mesh = self._mesh
        tracer = self._obs_begin("serve")
        cfg = self._model_config()
        dcfg = self._dist_config()
        dyncfg = spec.dynamics.to_config()
        shapes = PipelineShapes(spec.parallel.num_micro,
                                spec.parallel.mb_global, s.prompt_len,
                                cache_len=s.prompt_len + s.gen)
        paged = None
        if s.kv_page_size > 0:
            from repro_torch.serve.kv import PagedKVConfig
            # kv_pool_pages=0 auto-sizes to the dense-equivalent footprint
            # (every lane could hold a full cache line)
            lanes = spec.parallel.num_micro * spec.parallel.mb_global
            pool = s.kv_pool_pages or lanes * (shapes.cache_len
                                               // s.kv_page_size)
            paged = PagedKVConfig(page_size=s.kv_page_size, pool_pages=pool,
                                  prefix_cache=s.prefix_cache)
        if trace is None:
            trace = self.make_trace()

        # ---- chaos: the fault horizon is the trace's expected drain time
        # (arrival span + tokens / lanes), not max_ticks — derived events
        # must land while requests are in flight
        plan = injector = None
        if spec.faults.enabled:
            from repro_torch.faults import ChaosInjector, resolve_plan
            lanes = spec.parallel.num_micro * spec.parallel.mb_global
            est = (max((r.arrival for r in trace), default=0)
                   + sum(r.gen for r in trace) // max(1, lanes)
                   + len(trace))
            plan = resolve_plan(spec.faults,
                                horizon=max(8, min(s.max_ticks, est)),
                                workers=spec.parallel.stages,
                                file_manager=spec.cluster.job_manager
                                == "file")
            injector = ChaosInjector(plan)
            self.injector = injector

        scaler = None
        if spec.cluster.autoscale:
            scaler = Autoscaler(AutoscalerConfig(
                min_stages=max(1, s.min_stages),
                max_stages=spec.parallel.stages,
                patience=s.patience, cooldown=s.cooldown,
                queue_high=s.queue_high, occupancy_low=s.occupancy_low,
                latency_slo_s=s.latency_slo_s))
        jm = self._connect_job_manager(plan=plan, injector=injector)
        # multi-tenant: start on the scheduler's grant (min_stages: serve
        # small, steal under load) instead of the spec's maximum
        granted = self._register_tenant(
            jm, kind="serve", workers=s.min_stages,
            max_workers=spec.parallel.stages, min_workers=s.min_stages)
        if injector is not None and spec.cluster.job_manager == "file":
            injector.bind(kill_manager=self.kill_manager,
                          respawn_manager=self.respawn_manager)
        srv = ElasticServer(cfg, dcfg, dyncfg, shapes, job_manager=jm,
                            scaler=scaler, min_stages=s.min_stages,
                            seed=spec.seed, defrag_every=s.defrag_every,
                            measure_stage_times=spec.controller
                            .measure_stage_times,
                            initial_workers=granted, paged=paged,
                            temperature=s.temperature,
                            in_step_timing=spec.obs.in_step_timing,
                            tracer=tracer,
                            metrics=(self.metrics if mesh is None
                                     or mesh.rank == 0 else None),
                            device=self.device, params=self.params,
                            mesh=mesh)
        self._server = srv
        root_span = (tracer.span("serve", cat="session",
                                 requests=len(trace))
                     if tracer is not None else None)
        report = srv.serve(trace, autoscale=spec.cluster.autoscale,
                           resize_at=resize_at, max_ticks=s.max_ticks,
                           injector=injector)
        if root_span is not None:
            root_span.end(ticks=report["ticks"],
                          completions=len(report["completions"]))
        self.metrics.set("dynmo_tokens_per_s", report["tokens_per_s"],
                         help="serving throughput")
        self.metrics.set("dynmo_latency_p95_s", report["latency_p95_s"],
                         help="serving p95 request latency")
        report["spec"] = spec.to_dict()
        report["faults"] = injector.report() if injector is not None else []
        report["fault_plan"] = plan.to_dict() if plan is not None else None
        report["degraded_events"] = list(srv.engine.degraded_events)
        report["rpc"] = ({"stats": dict(jm.rpc_stats),
                          "breaker": jm.breaker.state_dict()}
                         if jm is not None else None)
        for rz in report["resizes"]:
            self._emit("resize", rz["step"], resize_kind=rz["kind"],
                       from_stages=rz["from_stages"],
                       to_stages=rz["to_stages"],
                       workers=list(rz["workers"]))
            if granted is not None and rz["kind"] == "shrink":
                # a tenant-scoped release is a yield: the freed workers go
                # back through the scheduler to whoever is owed or offered
                self._emit("yield", rz["step"],
                           workers=list(rz["workers"]),
                           tenant=spec.cluster.tenant_id)
        for d in report["autoscale_decisions"]:
            self._emit("autoscale", d["step"], action=d["action"],
                       workers=d["workers"], reason=d["reason"],
                       ids=list(d["ids"]))
            if (granted is not None and d["action"] == "grow"
                    and d.get("urgent")):
                self._emit("steal", d["step"], workers=d["workers"],
                           reason=d["reason"],
                           tenant=spec.cluster.tenant_id)
        self._emit("serve_summary", report["ticks"],
                   completions=len(report["completions"]),
                   total_tokens=report["total_tokens"],
                   tokens_per_s=report["tokens_per_s"],
                   latency_p95_s=report["latency_p95_s"])
        if mesh is not None:
            report["role"] = srv.engine.role()
            if self.gather:
                # the page pool (or dense cache) whole, for the report
                report["cache"] = srv.engine.gather_state(srv.state.cache)
        return report

    def _serve_across(self, trace, resize_at) -> Dict[str, Any]:
        """``serve`` as ``procs`` ranks, one per stage (``launch.dist``):
        rank 0's report, its event stream as this Session's, and every
        rank's counters under ``ranks``.  The reference's ``Session.serve``
        builds its server at data 1, so the ranks are the stages."""
        from repro_torch.configs.base import get_config
        from repro_torch.launch.dist import launch
        if self.spec.parallel.stages != self.procs:
            raise ValueError(
                f"the elastic server across ranks runs one rank per stage "
                f"at data 1 (as the reference's Session.serve builds its "
                f"server): parallel.stages={self.spec.parallel.stages} must "
                f"equal procs={self.procs}")
        spec = dataclasses.replace(self.spec, parallel=dataclasses.replace(
            self.spec.parallel, data=1))
        res = launch("repro_torch.api.session:rank_serve_elastic",
                     self.procs, data=1, device=self.device.type,
                     backend=self.dist_backend,
                     kwargs=dict(spec=spec, trace=trace, resize_at=resize_at,
                                 params=self.params, gather=self.gather,
                                 arch=get_config(self.spec.model.arch)))
        rep = res[0]["report"]
        self.events = res[0]["events"]
        rep["ranks"] = [r["rank"] for r in res]
        return rep


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------
def check_agreement(mesh, step: int, lps, assignment, engine=None,
                    injector=None, layout=None) -> None:
    """Every rank's split and assignment — and with the ``engine``, its
    epoch, stage -> worker map and pool, with the ``injector`` its fault
    log, with the ``layout`` its controller's logical expert placement —
    must be the same bytes after a cadence, a resize and a restore (the
    ranks decide independently from gathered inputs)."""
    import hashlib
    h = hashlib.sha256(repr(list(lps)).encode())
    if layout is not None:
        h.update(repr(list(layout.placement)).encode())
    for k in sorted(assignment):
        h.update(assignment[k].cpu().numpy().tobytes())
    if engine is not None:
        pool = (engine.pool.state_dict() if engine.pool is not None
                else None)
        h.update(repr((engine.epoch, list(engine.stage_workers),
                       list(engine.jm.log), pool)).encode())
    if injector is not None:
        h.update(repr([(r.step, r.kind, sorted(r.detail.items()))
                       for r in injector.records]).encode())
    seen = mesh.comm.all_gather_object(h.hexdigest())
    if len(set(seen)) != 1:
        raise RuntimeError(f"step {step}: the ranks' assignments, worlds, "
                           f"pools, fault logs or expert layouts differ "
                           f"({seen})")


def _rank_spec(mesh, spec: RunSpec) -> RunSpec:
    """Rank 0 keeps the observability outputs; the other ranks' are off."""
    if mesh.rank == 0:
        return spec
    return dataclasses.replace(spec, obs=dataclasses.replace(
        spec.obs, trace=False, trace_out=None, metrics_port=None,
        metrics_out=None))


def _rank_info(mesh, **extra) -> Dict[str, Any]:
    """A rank's counters for the report's ``ranks``."""
    import torch

    from repro_torch.launch.dist import foreign_modules, launch_counts
    cuda = mesh.device.type == "cuda"
    return {"rank": mesh.rank, "stage": mesh.stage,
            "replica": mesh.replica, "device": str(mesh.device),
            "backend": mesh.backend, "launches": launch_counts(),
            "peak_allocated": (torch.cuda.max_memory_allocated(mesh.device)
                               if cuda else None),
            "peak_reserved": (torch.cuda.max_memory_reserved(mesh.device)
                              if cuda else None),
            "comm": dict(mesh.comm.stats), **extra,
            "foreign_modules": foreign_modules()}


def rank_serve_elastic(mesh, spec: RunSpec, trace=None, resize_at=None,
                       params=None, gather: bool = False,
                       arch=None) -> Dict[str, Any]:
    """One rank of ``Session(procs=N).serve`` (run by ``launch.dist``), in
    the manner of ``rank_train``: rank 0 returns the report."""
    import torch

    from repro_torch.launch.dist import ensure_arch
    ensure_arch(arch)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    with Session(_rank_spec(mesh, spec), device=mesh.device, params=params,
                 gather=gather, mesh=mesh) as s:
        rep = s.serve(trace, resize_at=resize_at)
        srv = s.server
        info = _rank_info(mesh, role=rep["role"],
                          resize_memory=list(srv.resize_memory),
                          tick_wall_s=list(rep["tick_wall_s"]))
    if mesh.rank != 0:
        return {"rank": info}
    return {"rank": info, "report": rep, "events": s.events}


def state_digest(world, params, opt_state) -> Dict[str, Any]:
    """sha256 of a rank's final state, to hold runs bitwise without
    gathering it: ``rows`` (its stage's rows of the params and both
    moments) at data 0 of the world, ``rest`` (the replicated leaves and
    their moments) on the world's leader; None elsewhere.  One process's
    state gives the same digests row by row (``chip_smoke.state_digests``
    slices ``[s:s + 1]``)."""
    from repro_torch.launch.sharding import split_stages, tree_digest
    out: Dict[str, Any] = {"stage": None, "rows": None, "rest": None}
    if world.member and world.replica == 0 and params is not None:
        p_rows, p_rest = split_stages(params)
        o_rows, o_rest = split_stages(opt_state)
        out.update(stage=world.stage,
                   rows=tree_digest({"params": p_rows, "opt": o_rows}))
        if world.rank == world.leader:
            out["rest"] = tree_digest({"params": p_rest, "opt": o_rest})
    return out


def rank_train(mesh, spec: RunSpec, steps=None, params=None, on_step=None,
               gather: bool = False, arch=None, resume=None,
               digest=False) -> Dict[str, Any]:
    """One rank of ``Session(procs=N).train`` (run by ``launch.dist``):
    rank 0 keeps the observability outputs and returns the report.
    ``arch``: the parent's ``ModelConfig`` of ``spec.model.arch``, which
    the rank registers when its registry lacks it (a config registered at
    run time in the parent).  ``resume``: (safe-point directory, step) as
    the parent's ``Session.resume`` resolved it.  ``digest`` adds the
    rank's ``state_digest`` to its counters (a callable takes its place:
    ``digest(world, params, opt_state)``)."""
    import torch

    from repro_torch.launch.dist import ensure_arch
    ensure_arch(arch)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    with Session(_rank_spec(mesh, spec), device=mesh.device, params=params,
                 gather=gather, mesh=mesh) as s:
        if resume is not None:
            s._resume_dir, s._resume_step = resume
        rep = s.train(steps, on_step=on_step)
    t = rep["timing"]
    extra = ({"digest": (digest if callable(digest) else state_digest)(
        *s._final)} if digest else {})
    info = _rank_info(mesh, step_times=list(rep["step_times"]),
                      role=rep["role"], held_bytes=list(rep["held_bytes"]),
                      safepoint_writes=t["safepoint_writes"],
                      applied=rep["controller"]["applied"],
                      expert_layout=rep["expert_layout"],
                      relayouts=list(rep["relayouts"]),
                      restore={"seconds": t["restore_s"],
                               "allocated": t["restore_allocated"],
                               "files": t["restore_files"]}, **extra,
                      resize_memory=[
                          next(r for r in m["ranks"]
                               if r["rank"] == mesh.rank)
                          for m in rep["resize_memory"]])
    if mesh.rank != 0:
        return {"rank": info}
    return {"rank": info, "report": rep, "events": s.events}
