"""Elastic training and serving engine (paper §3.4, Alg. 2 — live
consolidation), ported from ``repro.launch.engine.ElasticEngine``.

The engine owns one execution *world* per stage count — the stage count's
``DistConfig``, its train step, loss, prefill and decode fns — built lazily
and cached.  A repack decision from the controller triggers a **live
shrink** in the same process: the stage-keyed state (params, optimizer
moments, dyn state and any serving KV cache) is flattened to global layer
order and re-split for the smaller stage count by one gather per leaf
(``checkpoint.elastic``), and training continues in the smaller world.
All stage buffers live on one card, so a world is a stage-buffer count,
not a device subset: a worker id names a stage buffer, and a shrink frees
the old ``[S, L_max, ...]`` buffers (nothing keeps them: the worlds cache
functions only) and releases the tail of the stage -> worker map to the
``WorkerPool``.  ``grow`` requests workers back; ``evict`` drops failed
ones wherever they sit.  Every resize bumps ``epoch``, which fences the
control plane's plans.

The job manager sits behind ``cluster.rpc.JobManagerClient``: the
in-process pool by default, or a file / HTTP client whose pool lives in
another process.  When that manager is unreachable the engine degrades —
a shrink's release and an evict's fail are queued (``degraded_events``)
and replayed in order before its next call, a grow is denied and
training continues — and a grow binds ids the manager minted fresh to a
free stage-buffer slot (``_bind_new_workers``).

A safe point's resume builds the world of the checkpoint's stage count and
split, adopts its stage -> worker map, pool and epoch, and loads the
shards into tensors allocated from the param spec and the optimizer's zero
tree (``restore_state``: no random init is made only to be overwritten);
across ranks each rank of that world loads its own stage's shard and the
replicated leaves, whatever rank count wrote the safe point.
With ``in_step_timing`` each world carries an ``obs.timing.StageTimer``
stamped around every stage's forward call inside the step, and around
each stage's prefill and decode calls when the world serves
(``in_step_stage_times``); ``measure_stage_times`` is the reference's
isolated per-stage probe.

With a ``mesh`` (``launch.mesh.Mesh``: one process per cell of a ``data x
model`` mesh of ranks, the *launch*) the engine is one rank's: its state
holds the rank's stage row of every stage-keyed tree (``launch.sharding``)
on its own device, and the step runs the pipeline across the ranks.  A
worker is a column of ``data`` ranks (rank ``d * S0 + column``, as the
reference's ``_columns``); a world of k stages runs on its k workers'
columns, over a submesh cached per (stages, columns).  A resize moves
every row from its rank in the old world to its rank in the new one
(``checkpoint.elastic.elastic_restore_across``); a rank that leaves the
world drops everything it held (its rows, the replicated leaves and their
moments) and empties the card's cache, a rank that joins receives its
rows and the replicated leaves (``launch.sharding.send_replicated``), whose
digests every rank of the world then compares.  Every rank of the launch
stays in the host loop: a rank outside the world runs no compute, and the
world's results — loss, stats, gradient norm, ids, logprobs, stage times —
reach it from the world's leader, so every rank's controller, pool and
autoscaler decide from the same bytes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.elastic import (_resplit_stage_tree,
                                            elastic_restore,
                                            elastic_restore_across)
from repro_torch.cluster.rpc import (InProcessJobManager, JobManagerClient,
                                     JobManagerUnavailable)
from repro_torch.configs.base import BLOCK_MOE, DistConfig, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.launch.sharding import (local_params, local_rows,
                                         merge_trees,
                                         row_template, send_replicated,
                                         split_batch, split_stages,
                                         state_bytes, tree_digest, zeros)
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.obs.timing import StageTimer, StepSpans
from repro_torch.obs.trace import current_tracer
from repro_torch.optim.optimizers import OptConfig, make_optimizer
from repro_torch.pipeline.pipeline import (PipelineShapes, _ingest,
                                           _stage_slice, build_decode_fn,
                                           build_loss_fn, build_prefill_fn,
                                           value_and_grad)
from repro_torch.runtime.fault_tolerance import WorkerPool


def make_train_step(cfg: ModelConfig, dcfg: DistConfig,
                    dyncfg: DynamicsConfig, shapes: PipelineShapes,
                    opt_cfg: Optional[OptConfig] = None, *,
                    device: DeviceLike = None, hash_proj=None,
                    stage_timer=None, step_spans=None, mesh=None):
    """Returns (init_opt_fn, train_step) with
    train_step(params, opt_state, assignment, dyn, batch, lr)
      -> (params, opt_state, loss, stats, gnorm);
    params and opt_state are updated in place; the batch is moved to
    ``device`` (the card unless ``"cpu"`` is asked for).  ``stage_timer``
    threads an ``obs.timing.StageTimer`` into the pipelined loss.  With
    ``step_spans`` (an ``obs.timing.StepSpans``), a step run while a
    tracer is current records ``step.batch``, ``step.forward``,
    ``step.backward`` and ``step.optimizer``.  With a ``mesh`` the state
    is the rank's rows, the batch is cut to its replica's lanes, the
    gradients of the leaves replicated over ``model`` are summed over the
    ring and every gradient over ``data``, and the clip norm is the
    mesh's."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or OptConfig(name=dcfg.optimizer)
    loss_fn = build_loss_fn(cfg, dcfg, dyncfg, shapes, hash_proj=hash_proj,
                            stage_timer=stage_timer, mesh=mesh)
    init_fn, update_fn = make_optimizer(opt_cfg, mesh=mesh)

    def train_step(params, opt_state, assignment, dyn, batch, lr):
        tracer = current_tracer() if step_spans is not None else None
        phase = None if tracer is None else step_spans.begin(tracer)
        if phase is not None:
            phase("step.batch")
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in split_batch(batch, mesh).items()}
        if phase is not None:
            phase("step.forward")
        loss, stats, grads = value_and_grad(loss_fn, params, assignment, dyn,
                                            batch, phase=phase)
        if phase is not None:
            phase("step.optimizer")
        params, opt_state, gnorm = update_fn(
            grads, opt_state, params, lr, frozen=dyn.get("frozen"))
        if phase is not None:
            phase(None)
        return params, opt_state, loss, stats, gnorm

    return init_fn, train_step


def _pack_pages(pool, scratch_k, scratch_v, table, mask):
    """Scatter prompt pages from a dense prefill scratch into the pool, in
    place.

    pool: {kp, vp: [S, L, pool+1, page, kv, hd]}; scratch_k/v:
    [S, L, m, B, cap, kv, hd] with cap == J * page; table/mask: [m, B, J].
    Unmasked or unmapped (-1) entries are steered at the trash block.
    Duplicate targets carry identical bytes, so write order cannot matter.
    """
    kp, vp = pool["kp"], pool["vp"]
    page = kp.shape[3]
    trash = kp.shape[2] - 1
    blk = torch.where(mask & (table >= 0), table,
                      torch.full_like(table, trash)).reshape(-1).long()

    def pages(sc):
        s_, l_, m_, b_, cap, kv, hd = sc.shape
        return sc.reshape(s_, l_, m_ * b_ * (cap // page), page, kv, hd)

    kp[:, :, blk] = pages(scratch_k).to(kp.dtype)
    vp[:, :, blk] = pages(scratch_v).to(vp.dtype)
    return pool


def _copy_block(pool, src: int, dst: int):
    """Duplicate one physical block (CoW fork) in every stage-slot pool."""
    for v in pool.values():
        v[:, :, dst] = v[:, :, src]
    return pool


@dataclasses.dataclass
class EngineWorld:
    """Everything tied to one stage count (across ranks: one stage count on
    one set of worker columns), built once and cached: its ``DistConfig``,
    its mesh and functions (no tensors — a world outlives the state it ran
    on).  A rank outside a world's mesh builds no functions for it."""
    stages: int
    dcfg: DistConfig
    init_opt: Any
    step: Any
    mesh: Any = None          # launch.mesh.Mesh of the world (ranks)
    eval_loss: Any = None     # lazily built loss-only fn (no update)
    prefill: Any = None       # lazily built serving prefill
    decode: Any = None        # {live_micros: decode fn}
    stepped: bool = False     # the first step() on this world warms up
    timer: Any = None         # obs.timing.StageTimer (in-step timing on)
    spans: Any = None         # obs.timing.StepSpans (one process)


@dataclasses.dataclass
class EngineState:
    """The training / serving state the engine threads through worlds:
    params, optimizer state, dyn state, host-side assignment and the
    stacked KV cache (``[S, L_max, ...]`` leaves), which re-split with the
    rest on every resize."""
    params: Any
    opt_state: Any
    dyn: Any
    assignment: Any
    lps: List[int]
    stages: int
    cache: Any = None


@dataclasses.dataclass
class ResizeEvent:
    step: int
    kind: str                  # shrink | grow | evict
    from_stages: int
    to_stages: int
    workers: List[int]         # released (shrink), granted (grow) or lost
    seconds: float
    ticks_before: int
    ticks_after: int


class ElasticEngine:
    """Owns the per-stage-count worlds and the live resize paths.  Stage s
    runs on worker ``stage_workers[s]``; shrinking keeps a prefix of the
    map and releases the tail to the job manager, growing requests (or,
    on a multi-tenant manager, steals) workers back."""

    def __init__(self, cfg: ModelConfig, dcfg: DistConfig,
                 dyncfg: DynamicsConfig, shapes: PipelineShapes, *,
                 opt_cfg: Optional[OptConfig] = None,
                 pool: Optional[WorkerPool] = None,
                 job_manager: Optional[JobManagerClient] = None,
                 paged=None, temperature: float = 0.0,
                 device: DeviceLike = None, hash_proj=None,
                 in_step_timing: bool = False, mesh=None):
        M.check_ported(cfg, dyncfg)
        if mesh is not None and dcfg.num_stages != mesh.model:
            raise ValueError(f"{dcfg.num_stages} stages on a model ring of "
                             f"{mesh.model} ranks")
        # the launch's mesh (every rank), and the current world's (a
        # submesh after a resize)
        self.launch = mesh
        self.mesh = mesh
        self.cfg, self.base_dcfg, self.dyncfg = cfg, dcfg, dyncfg
        self.shapes = shapes
        # serving options: ``paged`` is a PagedKVConfig; ``temperature`` > 0
        # builds sampling decode variants (0 keeps the argmax exactly)
        self.paged = paged
        self.temperature = float(temperature)
        self.device = resolve_device(device)
        if hash_proj is None and dyncfg.uses_sparse_attention:
            hash_proj = B.default_hash_projection(
                cfg.d_model, dyncfg.sparse_nbuckets, self.device)
        self.hash_proj = (None if hash_proj is None
                          else hash_proj.to(self.device, torch.float32))
        self.opt_cfg = opt_cfg
        self.in_step_timing = in_step_timing
        self._worlds: Dict[Any, EngineWorld] = {}
        # what the state carries (a rank outside the world holds none of
        # it, yet must know the shapes a grow hands it)
        self._has_opt = self._has_cache = False
        self.last_step_compiled = False
        # the safe point's files the last restore_state read
        self.restored_files: List[str] = []
        # serve telemetry: the last prefill / decode call's mean MoE
        # capacity-drop fraction (a device scalar; None for non-MoE archs)
        self.last_moe_drop = None
        if job_manager is None:
            # in-process default: the pool lives in this process
            self.pool: Optional[WorkerPool] = pool or WorkerPool(
                dcfg.num_stages)
            self.jm: JobManagerClient = InProcessJobManager(self.pool)
        else:
            # the pool lives behind the RPC boundary (its process owns it);
            # release / grant cross it through the client
            self.jm = job_manager
            self.pool = pool
        self.stage_workers: List[int] = list(range(dcfg.num_stages))
        # worker id -> stage-buffer slot ("column").  In one process all
        # stage buffers share the one card, so a column is a slot id;
        # across ranks it is a column of ``data`` ranks.  There are as
        # many as the base world has stages.  A worker granted later under
        # a never-seen id (the manager provisioned a fresh process) is
        # bound to a free column on arrival
        self.num_columns = dcfg.num_stages
        self.worker_column: Dict[int, int] = {
            w: w for w in range(dcfg.num_stages)}
        # ops the job manager must eventually hear about, queued while it
        # is unreachable (degraded mode: training continues, bookkeeping
        # replays in order when the manager comes back)
        self._pending_jm: List[Any] = []
        self.degraded_events: List[str] = []
        self.resizes: List[ResizeEvent] = []
        # workers evicted as dead (a rank of theirs ends the run "dead")
        self.dead_workers: set = set()
        self.last_shrink_step: Optional[int] = None
        # world epoch: bumped by every resize; the control plane fences
        # its plans with it
        self.epoch = 0
        # mirror every pool transition (including ones other engines or
        # the heartbeat path trigger on a shared pool) into a local log
        self.pool_events: List[str] = []
        self._pool_hook = lambda event, worker: self.pool_events.append(
            f"{event}:{worker}")
        if self.pool is not None:
            self.pool.subscribe(self._pool_hook)

    def close(self) -> None:
        """Detach from a (possibly shared) pool: a discarded engine must
        not be pinned alive by the pool's hook list."""
        if self.pool is not None:
            self.pool.unsubscribe(self._pool_hook)

    # -- worlds --------------------------------------------------------------
    def dcfg_for(self, stages: int) -> DistConfig:
        return dataclasses.replace(self.base_dcfg, num_stages=stages)

    def ticks(self, stages: int) -> int:
        return self.shapes.num_micro + stages - 1

    def world(self, stages: int,
              workers: Optional[Sequence[int]] = None) -> EngineWorld:
        """The world of ``stages`` stage buffers, built on first use (with
        its own stage timer when in-step timing is on: a fresh world has no
        window yet).  Across ranks it runs on the columns of ``workers``
        (default: the current stage -> worker map's first ``stages``);
        every rank builds it, in the same order, since its process groups
        are made collectively."""
        key: Any = stages
        cols = None
        if self.launch is not None:
            ws = (self.stage_workers[:stages] if workers is None
                  else list(workers))
            if len(ws) != stages:
                raise ValueError(f"{len(ws)} workers for {stages} stages")
            cols = tuple(self.worker_column[w] for w in ws)
            key = (stages, cols)
        w = self._worlds.get(key)
        if w is None:
            dcfg = self.dcfg_for(stages)
            mesh = None if cols is None else self._submesh(cols)
            init_opt = step = timer = None
            # with a mesh the loss runs its own backward: no phase spans
            spans = StepSpans(self.device) if mesh is None else None
            if mesh is None or mesh.member:
                # across ranks each rank times its own stage (as its
                # stage 0)
                timer = (StageTimer(1 if mesh is not None else stages,
                                    self.device, self.shapes.num_micro)
                         if self.in_step_timing else None)
                init_opt, step = make_train_step(
                    self.cfg, dcfg, self.dyncfg, self.shapes, self.opt_cfg,
                    device=self.device, hash_proj=self.hash_proj,
                    stage_timer=timer, step_spans=spans, mesh=mesh)
            w = EngineWorld(stages=stages, dcfg=dcfg, init_opt=init_opt,
                            step=step, timer=timer, spans=spans, mesh=mesh)
            self._worlds[key] = w
        return w

    def _submesh(self, cols: Sequence[int]):
        """The mesh of the worker columns ``cols`` (stage order): ranks
        ``d * S0 + cols[s]``, data-major; the launch's own mesh when
        ``cols`` is every column in order."""
        from repro_torch.launch.mesh import make_submesh
        launch = self.launch
        S0 = launch.model
        if tuple(cols) == tuple(range(S0)):
            return launch
        ranks = [d * S0 + c for d in range(launch.data) for c in cols]
        return make_submesh(launch.data, len(cols), ranks,
                            device=launch.device, backend=launch.backend,
                            comm=launch.comm)

    def active(self) -> bool:
        """Whether this rank runs a cell of the current world (always, in
        one process)."""
        return self.mesh is None or self.mesh.member

    def _from_world(self, value):
        """``value`` as the current world's leader computed it, on every
        rank of the launch (a rank outside the world passes None); the
        identity while the world is the whole launch."""
        if self.launch is None or self.mesh is self.launch:
            return value
        return self.launch.comm.broadcast_object(value, self.mesh.leader)

    def pool_active(self) -> int:
        """The job manager's count of active workers.  Across ranks under a
        file or HTTP manager it is rank 0's answer, broadcast
        (``jm_proxy.RankJobManager.poll_active``): every rank must call
        it, in the same order."""
        poll = getattr(self.jm, "poll_active", None)
        return poll() if poll is not None else self.jm.num_active

    def role(self) -> str:
        """This rank's part in the current world: ``active``, ``released``
        (its worker went back to the job manager) or ``dead`` (evicted)."""
        if self.active():
            return "active"
        col = self.launch.rank % self.launch.model
        mine = [w for w, c in self.worker_column.items() if c == col]
        return "dead" if set(mine) & self.dead_workers else "released"

    def gather_state(self, tree, kind: str = "rows"):
        """``tree`` whole on every rank: in one process the tree itself;
        across ranks the world's ranks gather it over their ring (``kind``:
        ``rows`` for a stage-keyed tree, ``params`` or ``opt``) and the
        world's leader hands it to the rest of the launch."""
        if self.launch is None:
            return tree
        from repro_torch.launch.sharding import (gather_opt, gather_params,
                                                 gather_rows)
        out = None
        if self.active():
            fn = {"rows": gather_rows, "params": gather_params,
                  "opt": gather_opt}[kind]
            out = fn(tree, self.mesh)
        return self._from_world(out)

    def held_bytes(self, state: "EngineState") -> int:
        """Bytes of the state's tensors this rank holds (0 outside the
        world)."""
        return state_bytes(state.params, state.opt_state, state.dyn,
                           state.cache)

    def _bind_new_workers(self, granted: Sequence[int]) -> tuple:
        """Bind stage-buffer slots for granted workers.  Known ids keep
        their slot; never-seen ids (the manager provisioned a fresh
        process) — or a stale binding whose slot was re-assigned while the
        worker was away — take a free slot.  Returns (accepted, rejected):
        a grant with no free slot behind it cannot be executed and goes
        back to the manager."""
        used = {self.worker_column[w] for w in self.stage_workers
                if w in self.worker_column}
        accepted: List[int] = []
        rejected: List[int] = []
        for w in granted:
            col = self.worker_column.get(w)
            if col is not None and col not in used:
                used.add(col)
                accepted.append(w)
                continue
            free = [c for c in range(self.num_columns) if c not in used]
            if not free:
                rejected.append(w)
                continue
            self.worker_column[w] = free[0]
            used.add(free[0])
            accepted.append(w)
        return accepted, rejected

    def bind_workers(self, workers: Sequence[int]) -> None:
        """Adopt a stage -> worker map (a checkpoint resume, or a tenant's
        initial grant of arbitrary ids): workers take slots positionally,
        replacing the init bindings."""
        if not 1 <= len(workers) <= self.num_columns:
            raise ValueError(f"{len(workers)} workers for "
                             f"{self.num_columns} stage-buffer slots")
        self.stage_workers = [int(w) for w in workers]
        for s, w in enumerate(self.stage_workers):
            self.worker_column[w] = s

    # -- degraded-mode job-manager calls -------------------------------------
    def _flush_pending_jm(self) -> bool:
        """Replay queued release / fail bookkeeping in order; True when the
        queue drained (the manager is reachable again)."""
        while self._pending_jm:
            kind, arg = self._pending_jm[0]
            try:
                if kind == "release":
                    self.jm.release(arg)
                else:
                    self.jm.fail(arg)
            except JobManagerUnavailable:
                return False
            self._pending_jm.pop(0)
            self.degraded_events.append(f"replayed {kind}:{arg}")
        return True

    def _jm_release(self, workers: Sequence[int]) -> None:
        workers = list(workers)
        if self._flush_pending_jm():
            try:
                self.jm.release(workers)
                return
            except JobManagerUnavailable:
                pass
        self._pending_jm.append(("release", workers))
        self.degraded_events.append(f"release deferred: {workers}")

    def _jm_fail(self, worker: int) -> None:
        if self._flush_pending_jm():
            try:
                self.jm.fail(worker)
                return
            except JobManagerUnavailable:
                pass
        self._pending_jm.append(("fail", worker))
        self.degraded_events.append(f"fail deferred: {worker}")

    # -- lifecycle -----------------------------------------------------------
    def init_state(self, seed: int = 0, *, with_opt: bool = False,
                   with_cache: bool = False, params=None,
                   stages: Optional[int] = None,
                   lps: Optional[Sequence[int]] = None) -> EngineState:
        """``with_opt=True`` adds the optimizer state (the reference's tree:
        ``m``, ``v``, ``count`` for AdamW); ``with_cache=True`` allocates the
        stacked decode KV cache (the paged pool when the engine is paged).
        ``params`` (a converted reference tree, see ``repro_torch.convert``)
        replaces the engine's own init, which draws from a torch generator
        seeded with ``seed``.  ``stages`` / ``lps`` override the base world
        (default: its stage count, a uniform split); with ``stages`` the
        caller binds the matching workers first (``bind_workers``)."""
        cfg, dev = self.cfg, self.device
        dcfg = self.dcfg_for(stages if stages is not None
                             else self.base_dcfg.num_stages)
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = M.init_params(gen, cfg, dcfg, dev)
        else:
            expect = M.param_spec(cfg, dcfg)
            _check_tree(params, expect)
            params = _to(params, dev)
        lps = (list(lps) if lps is not None
               else M.uniform_boundaries(cfg.total_blocks(), dcfg.num_stages))
        assignment = M.make_assignment(cfg, dcfg, lps)
        dyn = M.init_dyn(cfg, dcfg, self.dyncfg, dev)
        self._has_opt, self._has_cache = with_opt, with_cache
        world = self.world(dcfg.num_stages)
        cache = None
        if with_cache:
            assert self.shapes.cache_len > 0, "shapes.cache_len required"
            if world.mesh is not None:
                # zero rows of the world's shapes, allocated as rows
                cache = (zeros(self._row_templates(dcfg)["cache"], dev)
                         if world.mesh.member else None)
            elif self.paged is not None:
                cache = M.init_paged_cache(cfg, dcfg, self.paged.pool_pages,
                                           self.paged.page_size, dev)
            else:
                cache = self.make_dense_scratch(dcfg.num_stages)
        if world.mesh is not None:
            self.mesh = world.mesh
            if world.mesh.member:
                # this rank's rows; the whole trees are dropped here
                params = local_params(params, world.mesh)
                dyn = local_rows(dyn, world.mesh)
            else:
                params = dyn = None
        opt_state = (world.init_opt(params)
                     if with_opt and params is not None else None)
        return EngineState(params, opt_state, dyn, assignment, lps,
                           dcfg.num_stages, cache)

    # -- training ------------------------------------------------------------
    def _batch(self, batch):
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def step(self, state: EngineState, batch, lr):
        """One train step in the state's world; updates ``state.params`` /
        ``state.opt_state`` in place and returns (loss, stats, gnorm) on the
        device (the caller decides when to pay the host sync)."""
        w = self.world(state.stages)
        self.last_step_compiled = not w.stepped
        w.stepped = True
        out = None
        if w.step is not None:
            params, opt_state, loss, stats, gnorm = w.step(
                state.params, state.opt_state, state.assignment, state.dyn,
                batch, lr)
            state.params, state.opt_state = params, opt_state
            out = (loss, stats, gnorm)
        return self._from_world(out)

    def read_step_spans(self, state: EngineState) -> None:
        """The device ms of the last traced step's phase spans: call after
        the step's own loss sync."""
        spans = self.world(state.stages).spans
        if spans is not None:
            spans.resolve()

    @staticmethod
    def stats_to_host(state: EngineState, stats):
        """The per-slot stats tree ([S, L_max, ...]) on the host: a full
        device -> host sync — call it on controller cadence only."""
        return {k: v.detach().cpu().numpy() for k, v in stats.items()}

    @torch.no_grad()
    def eval_loss(self, state: EngineState, batch):
        """Loss only (no update) in the state's world."""
        w = self.world(state.stages)
        loss = None
        if self.active():
            if w.eval_loss is None:
                w.eval_loss = build_loss_fn(
                    self.cfg, w.dcfg, self.dyncfg, self.shapes,
                    hash_proj=self.hash_proj, mesh=w.mesh)
            loss, _ = w.eval_loss(state.params, state.assignment, state.dyn,
                                  self._batch(split_batch(batch, w.mesh)))
        return self._from_world(loss)

    # -- safe-point resume ---------------------------------------------------
    def state_templates(self, stages: int):
        """(params, opt_state, dyn) of the world of ``stages`` as tensors on
        the ``meta`` device: the shapes and dtypes a checkpoint restores
        into, from the param spec and the optimizer's zero tree, with no
        memory behind them."""
        w = self.world(stages)
        params = _meta(M.param_spec(self.cfg, w.dcfg))
        dyn = M.init_dyn(self.cfg, w.dcfg, self.dyncfg, torch.device("meta"))
        return params, w.init_opt(params), dyn

    def restore_state(self, path: str, index: dict) -> EngineState:
        """Resume from the safe point under ``path`` whose ``index``
        (``safepoint.peek``) names it: adopt its pool, stage -> worker map
        and epoch, and load its shards into the world of its stage count
        and split on this engine's device.  Across ranks the world runs on
        the safe point's workers' columns, whatever rank count wrote it: a
        rank of that world reads ``common.npz`` and its own stage's shard
        alone (``restored_files``), a rank outside it (a safe point of
        fewer stages than the launch has columns) starts released and holds
        nothing."""
        from repro_torch.checkpoint.checkpoint import load_rows
        from repro_torch.checkpoint.safepoint import restore
        meta = index["meta"]
        if meta.get("pool") and isinstance(self.jm, InProcessJobManager):
            # the in-process pool resumes here; a pool behind an RPC
            # boundary was seeded into its manager's journal by the caller
            self.close()
            self.pool = WorkerPool.from_state(meta["pool"])
            self.pool.subscribe(self._pool_hook)
            self.jm = InProcessJobManager(self.pool)
        self.bind_workers(meta["stage_workers"])
        stages = int(index["num_stages"])
        lps = [int(x) for x in index["layers_per_stage"]]
        step = int(index["step"])
        assignment = M.make_assignment(self.cfg, self.dcfg_for(stages), lps)
        self.epoch = int(meta.get("epoch", 0))
        self._has_opt = True
        if self.launch is None:
            params, opt, dyn, _ = restore(path, self.state_templates(stages),
                                          step, device=self.device)
            self.restored_files = list(index["files"])
            return EngineState(params, opt, dyn, assignment, lps, stages)
        world = self.world(stages)
        self.mesh = world.mesh
        params = opt = dyn = None
        self.restored_files = []
        if world.mesh.member:
            t = self._row_templates(world.dcfg)
            rest = t["replicated"]
            params, opt, dyn, self.restored_files = load_rows(
                path, (merge_trees(rest["params"], {"stages": t["params"]}),
                       merge_trees(rest["opt"], t["opt"]), t["dyn"]),
                step, world.mesh.stage, device=self.device)
        return EngineState(params, opt, dyn, assignment, lps, stages)

    # -- measured per-stage times ----------------------------------------------
    def in_step_stage_times(self, state: EngineState):
        """Per-stage busy seconds per step from the live pipelined step —
        no extra execution: reads and resets the current world's
        ``StageTimer``.  A stage runs ``num_micro`` forward calls a step
        (the port skips the schedule's invalid ticks), so that is the
        scale.  None when in-step timing is off or the world has no full
        window yet (e.g. right after a resize onto a fresh world)."""
        if not self.in_step_timing:
            return None
        w = self.world(state.stages)
        t = (None if w.timer is None
             else w.timer.snapshot(ticks_per_step=self.shapes.num_micro))
        if self.launch is None:
            return t
        return self._gather_times(None if t is None else float(t[0]))

    def _gather_times(self, mine: Optional[float]):
        """Every stage's time from its rank ([S] numpy on every rank of the
        launch, the world's first replica's; None when any stage has none
        yet).  A rank outside the world adds a blank."""
        v = torch.tensor([float("nan") if mine is None else mine],
                         dtype=torch.float64)
        full = self.launch.comm.all_gather(v, None).reshape(-1).numpy()
        mesh = self.mesh
        times = full[[mesh.rank_of(s, 0) for s in range(mesh.model)]]
        if np.isnan(times).any():
            return None
        return times.copy()

    @torch.no_grad()
    def measure_stage_times(self, state: EngineState, batch):
        """Measured per-stage forward wall seconds ([S] numpy): each
        stage's forward alone over the first microbatch (live slots only:
        the PAD slots are skipped), one warm pass, then a timed pass in
        which the carry flows stage to stage; each call is bracketed by a
        ``torch.cuda.synchronize`` on the card.  A host sync per stage: the
        trainer gates it on controller cadence."""
        if self.launch is not None:
            if not self.active():
                return self._gather_times(None)
            return self._measure_stage_times_across(state, batch)
        w = self.world(state.stages)
        cfg, dev = self.cfg, self.device
        tokens = torch.as_tensor(batch["tokens"][0], device=dev)
        carry = _ingest(state.params, cfg, self.dyncfg, tokens,
                        M.param_dtype(w.dcfg))
        pos = torch.arange(tokens.shape[-1], device=dev)
        tags = state.assignment["tags"].tolist()
        starts = np.concatenate([[0], np.cumsum(state.lps)[:-1]])
        times = np.zeros(state.stages)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        for warm in (True, False):
            for s in range(state.stages):
                sync()
                t0 = time.perf_counter()
                out = M.stage_forward(
                    cfg, w.dcfg, self.dyncfg, "train",
                    _stage_slice(state.params["stages"], s),
                    state.params["shared"], tags[s],
                    _stage_slice(state.dyn, s), carry, None, pos,
                    int(starts[s]), hash_proj=self.hash_proj)[0]
                sync()
                if not warm:
                    times[s] = time.perf_counter() - t0
                    carry = out          # the carry flows stage to stage
        return times

    def _measure_stage_times_across(self, state: EngineState, batch):
        """The probe across ranks: each rank times its own stage's forward
        over the first microbatch of its lanes, the carry handed on by
        point-to-point transfer (outside the timed span), then the times
        are all-gathered."""
        from repro_torch.launch.sharding import replica_shapes
        from repro_torch.pipeline.pipeline import (_carry_spec, _recv_carry,
                                                   _send_carry)
        w = self.world(state.stages)
        cfg, dev, mesh = self.cfg, self.device, self.mesh
        s = mesh.stage
        tokens = torch.as_tensor(split_batch(batch, mesh)["tokens"][0],
                                 device=dev)
        pos = torch.arange(tokens.shape[-1], device=dev)
        starts = np.concatenate([[0], np.cumsum(state.lps)[:-1]])
        dt = M.param_dtype(w.dcfg)
        spec = _carry_spec(cfg, self.dyncfg,
                           replica_shapes(self.shapes, mesh), dt)
        took = 0.0
        for warm in (True, False):
            if s == 0:
                carry = _ingest(state.params, cfg, self.dyncfg, tokens, dt)
            else:
                carry = _recv_carry(mesh.comm, spec, mesh.rank_of(s - 1),
                                    dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = M.stage_forward(
                cfg, w.dcfg, self.dyncfg, "train",
                _stage_slice(state.params["stages"], 0),
                state.params["shared"], state.assignment["tags"].tolist()[s],
                _stage_slice(state.dyn, 0), carry, None, pos,
                int(starts[s]), hash_proj=self.hash_proj)[0]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if not warm:
                took = time.perf_counter() - t0
            if s < mesh.model - 1:
                _send_carry(mesh.comm, out, spec, mesh.rank_of(s + 1))
        return self._gather_times(took)

    # -- serving -------------------------------------------------------------
    def serve_fns(self, stages: int, live_micros: Optional[int] = None):
        """(prefill, decode) for the world of ``stages``, built lazily next
        to its train step.  Decode variants are kept per (stage count, live
        microbatch count): a variant for ``live_micros < num_micro`` runs
        ``live + S - 1`` ticks."""
        w = self.world(stages)
        mv = self.shapes.num_micro if live_micros is None else live_micros
        if w.prefill is None:
            w.prefill = build_prefill_fn(
                self.cfg, w.dcfg, self.dyncfg, self.shapes,
                hash_proj=self.hash_proj, stage_timer=w.timer,
                mesh=w.mesh)
            w.decode = {}
        if mv not in w.decode:
            w.decode[mv] = build_decode_fn(
                self.cfg, w.dcfg, self.dyncfg, self.shapes,
                paged=self.paged is not None, temperature=self.temperature,
                num_micro=mv, hash_proj=self.hash_proj,
                stage_timer=w.timer, mesh=w.mesh)
        return w.prefill, w.decode[mv]

    def prefill(self, state: EngineState, batch, cache=None):
        """Run prefill; returns (last_ids, cache).  The target cache
        (``cache``, else ``state.cache``) is written in place for EVERY lane
        of the batch, so the server prefills into a scratch and merges the
        admitted lanes (dense) or packs their pages (paged).
        ``self.last_moe_drop`` holds the call's mean MoE capacity-drop
        fraction.  A rank outside the world runs nothing: it gets the ids
        from the world."""
        target = state.cache if cache is None else cache
        ids = None
        if self.active():
            pf, _ = self.serve_fns(state.stages)
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch.items()}
            ids, target, drop = pf(state.params, state.assignment,
                                   state.dyn, target, batch)
            self._note_moe_drop(drop)
        return self._from_world(ids), target

    def decode(self, state: EngineState, tokens, pos, *, page_table=None,
               seeds=None, live_micros: Optional[int] = None):
        """One decode step; updates ``state.cache`` in place and returns
        (ids, logprobs).  ``page_table`` [m, B, J] is required iff the
        engine is paged; ``seeds`` [m, B] int32 iff temperature > 0;
        ``live_micros`` selects the decode variant; ``self.last_moe_drop``
        as in :meth:`prefill`."""
        if not self.active():
            return self._from_world(None)
        _, dec = self.serve_fns(state.stages, live_micros)
        tokens = torch.as_tensor(tokens, device=self.device)
        pos = torch.as_tensor(pos, device=self.device)
        pt = None
        if self.paged is not None:
            assert page_table is not None, "paged decode needs a page table"
            pt = torch.as_tensor(page_table, dtype=torch.int32,
                                 device=self.device)
        sd = None
        if self.temperature > 0.0:
            if seeds is None:
                raise ValueError("sampling decode needs per-lane seeds")
            sd = torch.as_tensor(seeds, dtype=torch.int32,
                                 device=self.device)
        ids, lp, state.cache, drop = dec(state.params, state.assignment,
                                         state.dyn, state.cache, tokens, pos,
                                         pt, sd)
        self._note_moe_drop(drop)
        return self._from_world((ids, lp))

    def _note_moe_drop(self, drop):
        """A serve call's summed MoE drop signal as a mean fraction over
        the MoE layers and the microbatches (the reference normalizes by
        the full microbatch count, live or not).  Stays a device scalar:
        the server pays the host sync when it reads the telemetry."""
        n_moe = sum(1 for t in self.cfg.block_pattern() if t == BLOCK_MOE)
        self.last_moe_drop = (None if n_moe == 0 else
                              drop / float(n_moe * self.shapes.num_micro))

    # -- KV helpers ----------------------------------------------------------
    def make_dense_scratch(self, stages: int):
        """A dense stacked decode cache (zeros) — the paged server's prefill
        scratch and the dense server's cache and scratch; across ranks the
        rank's rows of its replica's lanes (None outside the world)."""
        dcfg = dataclasses.replace(self.base_dcfg, num_stages=stages)
        if self.launch is None:
            return M.init_cache(self.cfg, dcfg, self.shapes.num_micro,
                                self.shapes.mb_global, self.shapes.cache_len,
                                self.device)
        if not self.active():
            return None
        from repro_torch.launch.sharding import replica_shapes
        rs = replica_shapes(self.shapes, self.mesh)
        return zeros(row_template(_meta(M.cache_spec(
            self.cfg, dcfg, rs.num_micro, rs.mb_global, rs.cache_len))),
            self.device)

    def pack_pages(self, state: EngineState, scratch, table, mask):
        """Scatter the admitted lanes' prompt pages from the dense prefill
        scratch into the block pool (``table``/``mask``: [m, B, J]); a rank
        outside the world holds no pool."""
        if state.cache is None:
            return None
        dev = self.device
        return _pack_pages(state.cache, scratch["k"], scratch["v"],
                           torch.as_tensor(table, dtype=torch.int32,
                                           device=dev),
                           torch.as_tensor(mask, dtype=torch.bool,
                                           device=dev))

    def copy_block(self, state: EngineState, src: int, dst: int):
        """Copy-on-write fork: duplicate one physical block across every
        stage-slot pool (the rank's rows across ranks)."""
        if state.cache is None:
            return None
        return _copy_block(state.cache, int(src), int(dst))

    # -- live resize ---------------------------------------------------------
    def resize(self, state: EngineState, new_stages: int,
               new_lps: Optional[Sequence[int]] = None,
               workers: Optional[Sequence[int]] = None) -> EngineState:
        """Re-split all stage-keyed state to ``new_stages`` stage buffers
        — no checkpoint, no restart, no host round trip.  A serving cache
        rides the same re-split plan (its [S, L_max] leading dims gather
        like params), so in-flight KV state survives bit for bit.  Falls
        back to a uniform split when ``new_lps`` does not fit the target
        world's slot capacity.  Returns a new state; the caller drops the
        old one, and with it the old buffers.  Across ranks the new world
        runs on the columns of ``workers`` (default: the current map's
        first ``new_stages``) and the old state is consumed: its trees are
        cleared, and a rank outside the new world holds nothing."""
        world = self.world(new_stages, workers)
        L_new = world.dcfg.slots_for(self.cfg)
        if new_lps is not None and (len(new_lps) != new_stages
                                    or max(new_lps) > L_new):
            new_lps = None
        if self.launch is not None:
            return self._resize_across(state, world, new_lps)
        params, opt_state, dyn, assignment, lps = elastic_restore(
            self.cfg, self.dcfg_for(state.stages), world.dcfg,
            state.params, state.opt_state, state.dyn, state.lps, new_lps)
        cache = state.cache
        if cache is not None:
            cache = _resplit_stage_tree(cache, state.lps, lps, L_new)
        self.epoch += 1
        return EngineState(params, opt_state, dyn, assignment, lps,
                           new_stages, cache)

    def _row_templates(self, dcfg: DistConfig) -> Dict[str, Any]:
        """The ``meta`` shapes a rank of the world of ``dcfg`` holds: its
        stage rows (``params``, the optimizer's ``opt``, ``dyn``, the
        serving ``cache``) and the replicated leaves with their moments
        (``replicated``)."""
        from repro_torch.optim.optimizers import OptConfig, make_optimizer
        meta = torch.device("meta")
        rows, rest = split_stages(_meta(M.param_spec(self.cfg, dcfg)))
        rows = {"stages": row_template(rows["stages"])}
        out: Dict[str, Any] = {
            "params": rows["stages"], "replicated": rest,
            "dyn": row_template(M.init_dyn(self.cfg, dcfg, self.dyncfg,
                                           meta))}
        if self._has_opt:
            init, _ = make_optimizer(self.opt_cfg
                                     or OptConfig(name=dcfg.optimizer))
            opt_rows, opt_rest = split_stages(init(merge_trees(rest, rows)))
            out["opt"] = opt_rows
            out["replicated"] = {"params": rest, "opt": opt_rest}
        else:
            out["replicated"] = {"params": rest}
        if self._has_cache:
            spec = (M.paged_cache_spec(self.cfg, dcfg, self.paged.pool_pages,
                                       self.paged.page_size)
                    if self.paged is not None else
                    M.cache_spec(self.cfg, dcfg, self.shapes.num_micro,
                                 self.shapes.mb_global,
                                 self.shapes.cache_len))
            out["cache"] = row_template(_meta(spec))
        return out

    def _resize_across(self, state: EngineState, world: EngineWorld,
                       new_lps) -> EngineState:
        """``resize`` across ranks: every row moves from its rank in the
        current world to its rank in ``world``; a rank new to the world
        receives the replicated leaves from its data row's stage-0 rank
        (their digests then compared over the world); a rank that left
        drops everything and empties the card's cache."""
        src, dst = self.world(state.stages).mesh, world.mesh
        tmpl = self._row_templates(world.dcfg)
        opt_rows = opt_rest = None
        if state.opt_state is not None:
            opt_rows, opt_rest = split_stages(state.opt_state)
        params_rest = (None if state.params is None
                       else split_stages(state.params)[1])
        stages, opt_rows, dyn, cache, assignment, lps = \
            elastic_restore_across(
                self.cfg, world.dcfg, state.params, opt_rows, state.dyn,
                state.cache, state.lps, new_lps, src=src, dst=dst,
                templates=tmpl, replica=self.launch.replica,
                device=self.device)
        rest = send_replicated(
            {"params": params_rest, "opt": opt_rest}
            if self._has_opt else {"params": params_rest},
            tmpl["replicated"], src, dst, self.device)
        joined = any(r not in src.ranks for r in dst.ranks)
        # the old state is consumed: its buffers go with it
        state.params = state.opt_state = state.dyn = state.cache = None
        params_rest = opt_rest = None
        params = opt_state = None
        if dst.member:
            params = merge_trees(rest["params"], {"stages": stages})
            if self._has_opt:
                opt_state = merge_trees(rest["opt"], opt_rows)
        elif self.device.type == "cuda":
            # nothing of the state is left here: hand the blocks back, the
            # cuBLAS workspaces too (64 MiB on this card; the next matmul
            # after a grow allocates them again)
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()
        if joined:
            self._check_replicated(dst, rest)
        self.mesh = dst
        self.epoch += 1
        return EngineState(params, opt_state, dyn, assignment, lps,
                           world.stages, cache)

    def _check_replicated(self, dst, rest) -> None:
        """After a rank joined the world: the replicated leaves and their
        moments are the same bytes on every rank of it (digests gathered
        over the launch)."""
        seen = self.launch.comm.all_gather_object(
            tree_digest(rest) if dst.member else None)
        got = {seen[r] for r in dst.ranks}
        if len(got) != 1:
            raise RuntimeError(f"the replicated leaves differ across the "
                               f"world's ranks {dst.ranks}: {seen}")

    def _event(self, step: int, kind: str, state: EngineState, to: int,
               workers: Sequence[int], t0: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # the gathers are done
        self.resizes.append(ResizeEvent(
            step=step, kind=kind, from_stages=state.stages, to_stages=to,
            workers=list(workers), seconds=time.perf_counter() - t0,
            ticks_before=self.ticks(state.stages),
            ticks_after=self.ticks(to)))

    def shrink(self, state: EngineState, target_stages: int,
               new_lps: Optional[Sequence[int]] = None,
               step: int = -1) -> EngineState:
        """Live consolidation: rebuild on fewer stage buffers and release
        the tail of the stage -> worker map to the job manager."""
        assert target_stages < state.stages
        t0 = time.perf_counter()
        new_state = self.resize(state, target_stages, new_lps,
                                workers=self.stage_workers[:target_stages])
        released = self.stage_workers[target_stages:]
        self.stage_workers = self.stage_workers[:target_stages]
        self._jm_release(released)
        self._event(step, "shrink", state, target_stages, released, t0)
        self.last_shrink_step = step
        return new_state

    def evict(self, state: EngineState, workers: Sequence[int],
              step: int = -1) -> EngineState:
        """Failure path: rebuild WITHOUT ``workers`` (reported to the job
        manager as failed, not released: they are not grantable until the
        manager revives them).  The lost workers may sit anywhere in the
        stage -> worker map; the survivors keep their order."""
        lost = [w for w in workers if w in self.stage_workers]
        if not lost:
            return state
        target = len(self.stage_workers) - len(lost)
        assert target >= 1, "cannot evict every worker"
        t0 = time.perf_counter()
        survivors = [w for w in self.stage_workers if w not in set(lost)]
        # across ranks the new world runs on the survivors' columns; the
        # lost workers' ranks send their rows, then hold nothing
        new_state = self.resize(state, target, workers=survivors)
        self.stage_workers = survivors
        self.dead_workers.update(lost)
        for w in lost:
            self._jm_fail(w)
        self._event(step, "evict", state, target, lost, t0)
        self.last_shrink_step = step
        return new_state

    def grow(self, state: EngineState, n_workers: int,
             step: int = -1, steal: bool = False) -> EngineState:
        """Re-expansion: request workers back from the job manager and
        rebuild over more stage buffers.  Grows by however many the manager
        grants (possibly none); each takes a slot (``_bind_new_workers``)
        and a stage buffer at the tail.  An unreachable manager degrades to
        "no grant, training continues"; a granted id with no free slot is
        handed back.  ``steal=True`` asks through the cluster scheduler's
        steal verb (free capacity now, the shortfall preempts a
        lower-priority tenant) on a tenant-registered manager, and is a
        plain request elsewhere."""
        t0 = time.perf_counter()
        self._flush_pending_jm()
        ask = (self.jm.steal if steal and hasattr(self.jm, "steal")
               else self.jm.request)
        try:
            granted = ask(n_workers)
            if not granted and self._pending_jm and self._flush_pending_jm():
                # the request got through, so the manager is back — but its
                # pool had not heard our deferred releases yet (the breaker
                # blocked the flush; the request was the probe that closed
                # it).  The bookkeeping is settled now: ask once more
                granted = ask(n_workers)
        except JobManagerUnavailable:
            self.degraded_events.append(
                f"grow denied at step {step}: manager unreachable")
            return state
        granted, rejected = self._bind_new_workers(granted)
        if rejected:
            self.degraded_events.append(
                f"grant rejected (no free stage-buffer slot): {rejected}")
            self._jm_release(rejected)
        if not granted:
            return state
        target = state.stages + len(granted)
        new_state = self.resize(state, target,
                                workers=self.stage_workers + granted)
        self.stage_workers = self.stage_workers + granted
        self.dead_workers.difference_update(granted)
        self._event(step, "grow", state, target, granted, t0)
        return new_state


def _check_tree(tree, spec, path="params"):
    """A converted tree must have the spec's keys, shapes and dtypes."""
    if isinstance(spec, dict):
        if set(tree) != set(spec):
            raise ValueError(f"{path}: keys {sorted(tree)} != "
                             f"{sorted(spec)}")
        for k in spec:
            _check_tree(tree[k], spec[k], f"{path}.{k}")
        return
    if tuple(tree.shape) != tuple(spec.shape) or tree.dtype != spec.dtype:
        raise ValueError(f"{path}: {tuple(tree.shape)} {tree.dtype} != "
                         f"{tuple(spec.shape)} {spec.dtype}")


def _meta(spec):
    """A spec tree as empty tensors on the ``meta`` device."""
    if isinstance(spec, dict):
        return {k: _meta(v) for k, v in spec.items()}
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
