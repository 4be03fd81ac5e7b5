"""Continuous-batching server on one ``ElasticEngine`` world — the fixed-world
part of ``repro.serve.server.ElasticServer``.

The server owns one ``EngineState`` whose ``cache`` is the live KV state.
Each tick admits queued requests (prefill into a dense scratch, then a merge
of the admitted lanes' lines — dense — or a scatter of their prompt pages
into the block pool — paged), applies copy-on-write forks, decodes every
live lane at its own position and, on cadence, defragments the lanes.  The
report keeps every key of the reference's; resizes, autoscaling and the
job-manager pool are not in this slice, so their entries stay empty.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

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


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


class ElasticServer:
    """Continuous-batching inference on one fixed stage count."""

    def __init__(self, cfg: ModelConfig, dcfg: DistConfig,
                 dyncfg: DynamicsConfig, shapes: PipelineShapes, *,
                 eos_id: Optional[int] = None, defrag_every: int = 0,
                 seed: int = 0, paged=None, temperature: float = 0.0,
                 device: DeviceLike = None, params=None):
        assert shapes.cache_len >= shapes.seq, "cache must hold the prompt"
        self.paged = paged
        self.engine = ElasticEngine(cfg, dcfg, dyncfg, shapes, paged=paged,
                                    temperature=temperature, device=device)
        self.state = self.engine.init_state(seed, with_cache=True,
                                            params=params)
        self.shapes = shapes
        self.eos_id = eos_id
        self.defrag_every = defrag_every
        # prefill scratch: a dense cache prefill writes whole lanes into
        # before the admitted lanes are merged (dense) or packed (paged)
        self._scratch = None

    # -- main loop ------------------------------------------------------------
    def serve(self, requests: List[Request], *, max_ticks: int = 100000,
              resize_at: Optional[Dict[int, int]] = None,
              autoscale: bool = False) -> Dict[str, Any]:
        """Drive the request trace to completion."""
        if resize_at or autoscale:
            raise NotImplementedError(
                "serving resizes and autoscaling are not in repro_torch yet "
                "(ROADMAP Queue 1 [serve-elastic])")
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
                          defrag_every=self.defrag_every, allocator=alloc)
        m, B = self.shapes.num_micro, self.shapes.mb_global
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
            adm = sched.plan_admissions(tick)
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
                else:
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
            if perm is not None and alloc is None:
                # dense lines move with their lanes; the paged pool never
                # moves — lanes only carry table rows, rebuilt every tick
                _permute_lanes(self.state.cache, perm, m, B)
            wall = time.perf_counter() - t0
            tick_wall.append(wall)
            tick_tokens.append(emitted)
            token_lat.extend([wall] * emitted)
            stages_hist.append(self.state.stages)
            depth_hist.append(sched.queue_depth)
            occ_hist.append(sched.occupancy)
            if alloc is not None:
                page_occ_hist.append(alloc.occupancy)
                peak_pages = max(peak_pages, alloc.live_pages)
            tick += 1
        wall_s = time.perf_counter() - t_run
        total_tokens = sum(len(r.tokens) for r in sched.completions)
        return {
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
            "resizes": [],
            "pool_log": [],
            "autoscale_decisions": [],
            "requeued_total": sched.requeued_total,
            "total_tokens": total_tokens,
            "wall_s": wall_s,
            "tokens_per_s": total_tokens / max(1e-9, wall_s),
            "latency_p50_s": _pct(token_lat, 50),
            "latency_p95_s": _pct(token_lat, 95),
            "measured_stage_times": None,
            "stage_time_source": None,
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
