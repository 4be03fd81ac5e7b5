"""Elastic continuous-batching server on ``ElasticEngine`` worlds, ported
from ``repro.serve.server.ElasticServer``.

The server owns one ``EngineState`` whose ``cache`` is the live KV state.
Each tick admits queued requests (prefill into a dense scratch, then a merge
of the admitted lanes' lines — dense — or a scatter of their prompt pages
into the block pool — paged), applies copy-on-write forks, decodes every
live lane at its own position and, on cadence, defragments the lanes.
Resizes happen at the safe point between ticks: no microbatch is in
flight, so the engine's re-split carries every lane's KV (dense lines or
the page pool; the page tables are host-side and stay) onto the new stage
count bit for bit.  ``serve(resize_at=...)`` scripts them;
``serve(autoscale=True)`` lets the attached ``cluster.autoscaler`` drive
them from load (queue depth, lane and page occupancy, an optional latency
SLO): a grow asks the job manager for workers (an urgent one steals on a
multi-tenant manager), a shrink releases them through the same
``JobManagerClient`` boundary the trainer uses.  At temperature > 0 every
lane samples with its own seed (the scheduler's ``sample_seed``).

A worker that dies mid-flight (``crash_worker``, fired by a
``faults.ChaosInjector`` at the tick safe point) loses its stage's KV
shard: every in-flight request is requeued with its generated tokens
carried (re-admission replays them), the worker is evicted, and the next
tick re-admits onto the smaller world.  ``tracer`` records ``serve.tick``
/ ``serve.admit`` / ``serve.resize`` spans, ``metrics`` the KV, token,
queue and tick series, and with ``in_step_timing`` the engine's stage
timer brackets each stage's prefill and decode calls, read once after the
trace drains.  The report keeps every key of the reference's.

With a ``mesh`` (one rank per stage, data 1) the server is one rank's:
the engine holds the rank's stage rows of the params and of the KV page
pool and launches its layers' work (the paged decode attention among it);
every rank runs the scheduler and the page allocator on the same ids, and
resizes — scripted or the autoscaler's — move rows across ranks
(``launch.engine``): a released rank holds nothing and keeps scheduling.
The autoscaler's latency signal is the world leader's tick wall; only rank
0 prints.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.cluster.autoscaler import Autoscaler
from repro_torch.cluster.rpc import JobManagerClient
from repro_torch.configs.base import DistConfig, ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.kernels.paged_attention import paged_tile_work
from repro_torch.launch.engine import ElasticEngine
from repro_torch.pipeline.pipeline import PipelineShapes
from repro_torch.serve.requests import Request, RequestQueue
from repro_torch.serve.scheduler import Scheduler


def _merge_lanes(old, new, mask: np.ndarray):
    """Copy admitted lanes' KV lines from ``new`` into ``old`` in place.
    Leaves are [S, L_max, m, B, ...]; ``mask`` is [m, B]."""
    mi, bi = np.nonzero(mask)
    mi, bi = torch.as_tensor(mi), torch.as_tensor(bi)
    for k in old:
        old[k][:, :, mi, bi] = new[k][:, :, mi, bi]
    return old


def _permute_lanes(cache, src_of_dst: np.ndarray, m: int, B: int):
    """Apply a defrag lane permutation to every cache leaf, in place."""
    perm = torch.as_tensor(src_of_dst)
    for k, a in cache.items():
        flat = a.reshape(a.shape[:2] + (m * B,) + a.shape[4:])
        flat.copy_(flat[:, :, perm.to(a.device)])
    return cache


def _memory(device) -> Dict[str, Optional[int]]:
    """``memory_allocated`` / ``memory_reserved`` (None off the card)."""
    if device.type != "cuda":
        return {"allocated": None, "reserved": None}
    return {"allocated": torch.cuda.memory_allocated(device),
            "reserved": torch.cuda.memory_reserved(device)}


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


class ElasticServer:
    """Continuous-batching inference with live worker elasticity."""

    def __init__(self, cfg: ModelConfig, dcfg: DistConfig,
                 dyncfg: DynamicsConfig, shapes: PipelineShapes, *,
                 job_manager: Optional[JobManagerClient] = None,
                 scaler: Optional[Autoscaler] = None, min_stages: int = 1,
                 initial_workers: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, defrag_every: int = 0,
                 seed: int = 0, paged=None, temperature: float = 0.0,
                 measure_stage_times: bool = False,
                 in_step_timing: bool = False, tracer=None, metrics=None,
                 device: DeviceLike = None, params=None, mesh=None):
        assert shapes.cache_len >= shapes.seq, "cache must hold the prompt"
        self.paged = paged
        self.measure_stage_times = measure_stage_times
        self.in_step_timing = in_step_timing
        self.tracer = tracer     # obs.trace.Tracer (None = tracing off)
        self.metrics = metrics   # obs.metrics.MetricsRegistry (optional)
        self.temperature = float(temperature)
        self.seed = seed
        self.engine = ElasticEngine(cfg, dcfg, dyncfg, shapes, paged=paged,
                                    job_manager=job_manager,
                                    temperature=temperature, device=device,
                                    in_step_timing=in_step_timing,
                                    mesh=mesh)
        self.mesh = mesh
        self._quiet = mesh is not None and mesh.rank != 0
        # memory around each resize (None on the CPU)
        self.resize_memory: List[Dict[str, Any]] = []
        stages = None
        if initial_workers is not None:
            # multi-tenant start: serve on exactly the workers the cluster
            # scheduler granted (arbitrary ids, possibly fewer than the
            # maximum stage count)
            self.engine.bind_workers([int(w) for w in initial_workers])
            stages = len(list(initial_workers))
        self.state = self.engine.init_state(seed, with_cache=True,
                                            params=params, stages=stages)
        self.shapes = shapes
        self.scaler = scaler
        self.min_stages = max(1, min_stages)
        self.max_stages = dcfg.num_stages
        self.eos_id = eos_id
        self.defrag_every = defrag_every
        # prefill scratch: a dense cache prefill writes whole lanes into
        # before the admitted lanes are merged (dense) or packed (paged);
        # rebuilt when the stage count changes
        self._scratch = None
        self._sched: Optional[Scheduler] = None

    def close(self) -> None:
        self.engine.close()

    # -- fault path ----------------------------------------------------------
    def crash_worker(self, worker: int, tick: int) -> None:
        """A serving worker died mid-flight: its stage's KV shard is gone,
        and every live lane's KV line passed through it.  Requeue every
        in-flight request (generated tokens carried — re-admission rebuilds
        their KV from the token prefix) and evict the worker; the next tick
        re-admits onto the smaller world.  The degraded run completes the
        same request set with the same tokens, later."""
        if worker not in self.engine.stage_workers:
            return
        if self.state.stages <= 1:
            raise RuntimeError(
                "last serving worker crashed — nothing to rebuild on")
        requeued = (self._sched.requeue_live(tick)
                    if self._sched is not None else [])
        self.state = self.engine.evict(self.state, [worker], step=tick)
        self._scratch = None          # the old world's scratch goes too
        if self.scaler is not None:
            self.scaler.note_resize(tick, self.state.stages)
        if not self._quiet:
            print(f"tick {tick:4d} CRASH worker {worker}: requeued "
                  f"{len(requeued)} in-flight requests, serving on "
                  f"{self.state.stages} stages", flush=True)

    # -- safe-point resize ---------------------------------------------------
    def resize(self, target_stages: int, tick: int, reason: str,
               steal: bool = False) -> bool:
        """Shrink or grow between decode ticks.  Returns True if the world
        changed (the job manager may deny a grow).  ``steal`` lets an
        urgent grow preempt a lower-priority tenant through the cluster
        scheduler (a plain request on a single-tenant manager)."""
        prev = self.state.stages
        mem_before = _memory(self.engine.device)
        sp = (self.tracer.span("serve.resize", cat="resize", tick=tick,
                               target=target_stages, reason=reason,
                               steal=steal)
              if self.tracer is not None else None)
        if target_stages < prev:
            self.state = self.engine.shrink(self.state, target_stages,
                                            step=tick)
        elif target_stages > prev:
            # an urgent steal goes through jm.steal inside grow(); the RPC
            # transport ships this span's context, so the victim's preempt
            # chains onto it across processes
            self.state = self.engine.grow(self.state, target_stages - prev,
                                          step=tick, steal=steal)
        changed = self.state.stages != prev
        if sp is not None:
            sp.end(stages=self.state.stages, changed=changed)
        if self.metrics is not None and changed:
            rz = self.engine.resizes[-1]
            self.metrics.inc("dynmo_resizes_total", kind=rz.kind,
                             policy="steal" if steal else reason,
                             help="engine resizes by kind")
        if changed:
            self._scratch = None      # the old world's scratch goes too
            rz = self.engine.resizes[-1]
            after = _memory(self.engine.device)
            self.resize_memory.append({
                "tick": tick, "kind": rz.kind, "seconds": rz.seconds,
                "role": self.engine.role(),
                **{f"{k}_before": v for k, v in mem_before.items()},
                **{f"{k}_after": v for k, v in after.items()}})
            active = self.engine.pool_active()  # every rank: a broadcast
            if not self._quiet:
                print(f"tick {tick:4d} {rz.kind.upper()} {rz.from_stages}->"
                      f"{rz.to_stages} stages ({reason}); workers "
                      f"{rz.workers}; pool active={active}")
            if self.scaler is not None:
                self.scaler.note_resize(tick, self.state.stages)
        return changed

    # -- main loop ------------------------------------------------------------
    def serve(self, requests: List[Request], *, max_ticks: int = 100000,
              resize_at: Optional[Dict[int, int]] = None,
              autoscale: bool = False, injector=None) -> Dict[str, Any]:
        """Drive the request trace to completion.  ``resize_at`` scripts
        {tick: target_stages} safe-point resizes; ``autoscale`` lets the
        attached scaler drive them from load; ``injector``
        (``faults.ChaosInjector``) fires scheduled faults at the tick safe
        points — a crashed worker goes through ``crash_worker``."""
        alloc = None
        if self.paged is not None:
            from repro_torch.serve.kv import PageAllocator
            alloc = PageAllocator(
                self.paged.pool_pages, self.paged.page_size,
                max_pages_per_req=(self.shapes.cache_len
                                   // self.paged.page_size),
                prefix_cache=self.paged.prefix_cache)
        sched = Scheduler(self.shapes.num_micro, self.shapes.mb_global,
                          self.shapes.seq, self.shapes.cache_len,
                          RequestQueue(requests), eos_id=self.eos_id,
                          defrag_every=self.defrag_every, allocator=alloc,
                          sample_seed=(self.seed if self.temperature > 0
                                       else None))
        self._sched = sched
        if injector is not None:
            injector.bind(crash_worker=self.crash_worker)
        m, B = self.shapes.num_micro, self.shapes.mb_global
        resizes_before = len(self.engine.resizes)
        tick = 0
        tick_wall: List[float] = []
        tick_tokens: List[int] = []
        token_lat: List[float] = []
        stages_hist: List[int] = []
        depth_hist: List[int] = []
        occ_hist: List[float] = []
        page_occ_hist: List[float] = []
        peak_lanes = 0
        peak_pages = 0
        tiles_live = tiles_total = 0
        moe_drops = []   # device scalars; synced once after the trace drains
        t_run = time.perf_counter()
        while tick < max_ticks and not sched.done:
            t0 = time.perf_counter()
            emitted = 0
            sp_tick = (self.tracer.span("serve.tick", cat="serve",
                                        tick=tick,
                                        stages=self.state.stages)
                       if self.tracer is not None else None)
            adm = sched.plan_admissions(tick)
            if adm is not None and self.tracer is not None:
                self.tracer.instant("serve.admit", cat="serve", tick=tick,
                                    lanes=len(adm.full_len_lanes))
            if adm is not None:
                batch = {"tokens": adm.prefill_tokens}
                if self._scratch is None:
                    self._scratch = self.engine.make_dense_scratch(
                        self.state.stages)
                ids, self._scratch = self.engine.prefill(
                    self.state, batch, cache=self._scratch)
                if alloc is not None:
                    self.engine.pack_pages(self.state, self._scratch,
                                           adm.page_table, adm.pack_mask)
                elif self.state.cache is not None:
                    _merge_lanes(self.state.cache, self._scratch,
                                 adm.admit_mask)
                sched.note_prefill(adm, ids.cpu().numpy(), tick)
                emitted += len(adm.full_len_lanes)
                if self.engine.last_moe_drop is not None:
                    moe_drops.append(self.engine.last_moe_drop)
            dec = sched.plan_decode()
            if dec is not None:
                for src, dst in dec.copies:      # CoW forks land on device
                    self.engine.copy_block(self.state, src, dst)
                # the decode variant for the live microbatch rows: drained
                # trailing rows skip their pipeline ticks
                mlive = max(dec.lanes) // B + 1
                ids, _lp = self.engine.decode(self.state, dec.tokens,
                                              dec.pos,
                                              page_table=dec.page_table,
                                              seeds=dec.seeds,
                                              live_micros=mlive)
                sched.note_decode(dec, ids.cpu().numpy(), tick)
                emitted += len(dec.lanes)
                peak_lanes = max(peak_lanes, len(dec.lanes))
                if alloc is not None:
                    lv, tt = paged_tile_work(
                        dec.page_table,
                        dec.pos.reshape(-1) + 1, alloc.page_size)
                    tiles_live += lv
                    tiles_total += tt
                if self.engine.last_moe_drop is not None:
                    moe_drops.append(self.engine.last_moe_drop)
            perm = sched.maybe_defrag(tick)
            if (perm is not None and alloc is None
                    and self.state.cache is not None):
                # dense lines move with their lanes; the paged pool never
                # moves — lanes only carry table rows, rebuilt every tick
                _permute_lanes(self.state.cache, perm, m, B)
            wall = time.perf_counter() - t0
            if self.mesh is not None:
                # every rank's latency signal is the world leader's clock
                wall = float(self.mesh.comm.all_gather_object(wall)[
                    self.engine.mesh.leader])
            if sp_tick is not None:
                sp_tick.end(tokens=emitted, queue=sched.queue_depth)
            tick_wall.append(wall)
            tick_tokens.append(emitted)
            token_lat.extend([wall] * emitted)
            stages_hist.append(self.state.stages)
            depth_hist.append(sched.queue_depth)
            occ_hist.append(sched.occupancy)
            if alloc is not None:
                page_occ_hist.append(alloc.occupancy)
                peak_pages = max(peak_pages, alloc.live_pages)
                if self.metrics is not None:
                    self.metrics.set("dynmo_kv_page_occupancy",
                                     alloc.occupancy,
                                     help="KV pool occupancy fraction")
                    self.metrics.set("dynmo_kv_pages_live",
                                     alloc.live_pages,
                                     help="KV pool pages in use")
                    self.metrics.set("dynmo_kv_pages_free", alloc.num_free,
                                     help="KV pool pages free")
            if self.metrics is not None:
                self.metrics.inc("dynmo_serve_ticks_total",
                                 help="decode ticks executed")
                self.metrics.inc("dynmo_serve_tokens_total", emitted,
                                 help="tokens emitted")
                self.metrics.set("dynmo_queue_depth", sched.queue_depth,
                                 help="waiting requests")
                self.metrics.set("dynmo_occupancy", sched.occupancy,
                                 help="lane occupancy fraction")
                self.metrics.observe("dynmo_tick_seconds", wall,
                                     help="serve tick wall seconds")
            # ---- safe point: the tick's flight is fully retired
            if resize_at and tick in resize_at:
                self.resize(resize_at[tick], tick, "scripted")
            elif autoscale and self.scaler is not None:
                # latency signal = p95 per-token over the recent window
                # (what AutoscalerConfig.latency_slo_s is specified
                # against), never the raw tick wall
                recent = token_lat[-64:]
                d = self.scaler.observe_load(
                    tick, self.state.stages, queue_depth=sched.queue_depth,
                    occupancy=sched.occupancy,
                    latency_s=_pct(recent, 95) if recent else 0.0,
                    page_occupancy=sched.page_occupancy)
                if d.action == "shrink":
                    self.resize(max(self.min_stages,
                                    self.state.stages - d.workers),
                                tick, d.reason)
                elif d.action == "grow":
                    self.resize(min(self.max_stages,
                                    self.state.stages + d.workers),
                                tick, d.reason, steal=d.urgent)
            if injector is not None:
                # scheduled faults fire at the same safe point resizes do:
                # the tick's flight is fully retired, so a crash loses KV
                # state only — never an in-flight microbatch
                injector.on_step(tick, workers=self.engine.stage_workers)
            tick += 1
        wall_s = time.perf_counter() - t_run
        total_tokens = sum(len(r.tokens) for r in sched.completions)
        measured = src = None
        if self.in_step_timing:
            # per-stage seconds from the stage timer's events around the
            # trace's prefill and decode calls — no probe execution
            ist = self.engine.in_step_stage_times(self.state)
            if ist is not None:
                measured = list(map(float, ist))
                src = "in_step"
        if measured is None and self.measure_stage_times:
            # per-stage prefill-shaped wall times from the engine's stage
            # probe, once after the trace drains, on the world the server
            # ended up holding (off the serving loop)
            probe = {"tokens": np.zeros((self.shapes.num_micro,
                                         self.shapes.mb_global,
                                         self.shapes.seq), np.int64)}
            measured = list(map(float, self.engine.measure_stage_times(
                self.state, probe)))
            src = "probe"
        report = {
            "completions": [
                {"rid": r.rid, "kind": r.kind, "arrival": r.arrival,
                 "admitted": r.admitted, "finished": r.finished,
                 "plen": r.plen, "requeues": r.requeues,
                 "tokens": list(map(int, r.tokens))}
                for r in sorted(sched.completions, key=lambda r: r.rid)],
            "ticks": tick,
            "tick_wall_s": tick_wall,
            "tick_tokens": tick_tokens,
            "stages_history": stages_hist,
            "queue_depth_history": depth_hist,
            "occupancy_history": occ_hist,
            "resizes": [dataclasses.asdict(e)
                        for e in self.engine.resizes[resizes_before:]],
            "pool_log": list(self.engine.jm.log),
            "autoscale_decisions": (
                [dataclasses.asdict(d) for d in self.scaler.decisions]
                if self.scaler is not None else []),
            "requeued_total": sched.requeued_total,
            "total_tokens": total_tokens,
            "wall_s": wall_s,
            "tokens_per_s": total_tokens / max(1e-9, wall_s),
            "latency_p50_s": _pct(token_lat, 50),
            "latency_p95_s": _pct(token_lat, 95),
            "measured_stage_times": measured,
            "stage_time_source": src,
            # MoE capacity-overflow telemetry: mean drop fraction over every
            # prefill / decode call of the trace (None for non-MoE archs)
            "moe_dropped_mean": (float(np.mean([float(d)
                                                for d in moe_drops]))
                                 if moe_drops else None),
            "peak_live_lanes": peak_lanes,
            "page_occupancy_history": page_occ_hist,
            "kv_page_size": alloc.page_size if alloc is not None else 0,
            "kv_pages_total": alloc.pool_pages if alloc is not None else 0,
            "peak_live_pages": peak_pages,
            "prefix_hits": alloc.prefix_hits if alloc is not None else 0,
            "cow_forks": alloc.cow_forks if alloc is not None else 0,
            "page_tile_live": tiles_live,
            "page_tile_total": tiles_total,
        }
        if alloc is not None and self.metrics is not None:
            self.metrics.inc("dynmo_prefix_hits_total", alloc.prefix_hits,
                             help="prompt pages shared via prefix cache")
            self.metrics.inc("dynmo_cow_forks_total", alloc.cow_forks,
                             help="copy-on-write page forks")
        return report
