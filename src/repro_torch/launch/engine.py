"""Training and serving engine on one fixed execution world — the
one-world subset of ``repro.launch.engine.ElasticEngine``.

The reference's engine owns one execution world per stage count (a mesh
over a device subset, jitted step/serving fns) and resizes live between
them.  This port trains and serves on ONE world: ``dcfg.num_stages`` stage
buffers on one card.  The state keeps the reference's stacked ``[S, L_max,
...]`` layout, which the controller's migration gathers along.  Resizes
(shrink / grow / evict) and in-step timing raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import BLOCK_MOE, DistConfig, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.optim.optimizers import OptConfig, make_optimizer
from repro_torch.pipeline.pipeline import (PipelineShapes, build_decode_fn,
                                           build_loss_fn, build_prefill_fn,
                                           value_and_grad)


def make_train_step(cfg: ModelConfig, dcfg: DistConfig,
                    dyncfg: DynamicsConfig, shapes: PipelineShapes,
                    opt_cfg: Optional[OptConfig] = None, *,
                    device: DeviceLike = None, hash_proj=None):
    """Returns (init_opt_fn, train_step) with
    train_step(params, opt_state, assignment, dyn, batch, lr)
      -> (params, opt_state, loss, stats, gnorm);
    params and opt_state are updated in place; the batch is moved to
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or OptConfig(name=dcfg.optimizer)
    loss_fn = build_loss_fn(cfg, dcfg, dyncfg, shapes, hash_proj=hash_proj)
    init_fn, update_fn = make_optimizer(opt_cfg)

    def train_step(params, opt_state, assignment, dyn, batch, lr):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, stats, grads = value_and_grad(loss_fn, params, assignment, dyn,
                                            batch)
        params, opt_state, gnorm = update_fn(
            grads, opt_state, params, lr, frozen=dyn.get("frozen"))
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
class EngineState:
    """The serving state: params, dyn state, host-side assignment and the
    stacked KV cache (``[S, L_max, ...]`` leaves)."""
    params: Any
    opt_state: Any
    dyn: Any
    assignment: Any
    lps: List[int]
    stages: int
    cache: Any = None


class ElasticEngine:
    """Train step, serving fns and device helpers for one fixed stage
    count."""

    def __init__(self, cfg: ModelConfig, dcfg: DistConfig,
                 dyncfg: DynamicsConfig, shapes: PipelineShapes, *,
                 opt_cfg: Optional[OptConfig] = None,
                 paged=None, temperature: float = 0.0,
                 device: DeviceLike = None, hash_proj=None):
        M.check_ported(cfg, dyncfg)
        if temperature > 0.0:
            raise NotImplementedError(
                "temperature > 0 sampling is not in repro_torch yet (ROADMAP "
                "Queue 1 [serve-sampling]: a Philox sampler replaces jax's "
                "PRNG)")
        self.cfg, self.base_dcfg, self.dyncfg = cfg, dcfg, dyncfg
        self.shapes = shapes
        self.paged = paged
        self.device = resolve_device(device)
        if hash_proj is None and dyncfg.uses_sparse_attention:
            hash_proj = B.default_hash_projection(
                cfg.d_model, dyncfg.sparse_nbuckets, self.device)
        self.hash_proj = (None if hash_proj is None
                          else hash_proj.to(self.device, torch.float32))
        self.opt_cfg = opt_cfg
        self._prefill = None
        self._decode: Dict[int, Any] = {}
        self._train = None
        self._eval_loss = None
        # world epoch (the control plane fences its plans with it); a
        # resize would bump it — one world here, so it stays 0
        self.epoch = 0
        self.stepped = False
        self.last_step_compiled = False
        # serve telemetry: the last prefill / decode call's mean MoE
        # capacity-drop fraction (a device scalar; None for non-MoE archs)
        self.last_moe_drop = None

    # -- lifecycle -----------------------------------------------------------
    def init_state(self, seed: int = 0, *, with_opt: bool = False,
                   with_cache: bool = False, params=None) -> EngineState:
        """``with_opt=True`` adds the optimizer state (the reference's tree:
        ``m``, ``v``, ``count`` for AdamW); ``with_cache=True`` allocates the
        stacked decode KV cache (the paged pool when the engine is paged).
        ``params`` (a converted reference tree, see ``repro_torch.convert``)
        replaces the engine's own init, which draws from a torch generator
        seeded with ``seed``."""
        cfg, dcfg, dev = self.cfg, self.base_dcfg, self.device
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = M.init_params(gen, cfg, dcfg, dev)
        else:
            expect = M.param_spec(cfg, dcfg)
            _check_tree(params, expect)
            params = _to(params, dev)
        lps = M.uniform_boundaries(cfg.total_blocks(), dcfg.num_stages)
        assignment = M.make_assignment(cfg, dcfg, lps)
        dyn = M.init_dyn(cfg, dcfg, self.dyncfg, dev)
        cache = None
        if with_cache:
            assert self.shapes.cache_len > 0, "shapes.cache_len required"
            if self.paged is not None:
                cache = M.init_paged_cache(cfg, dcfg, self.paged.pool_pages,
                                           self.paged.page_size, dev)
            else:
                cache = self.make_dense_scratch(dcfg.num_stages)
        opt_state = self.train_fns()[0](params) if with_opt else None
        return EngineState(params, opt_state, dyn, assignment, lps,
                           dcfg.num_stages, cache)

    # -- training ------------------------------------------------------------
    def train_fns(self):
        """(init_opt, train_step) of this engine's world, built once."""
        if self._train is None:
            self._train = make_train_step(
                self.cfg, self.base_dcfg, self.dyncfg, self.shapes,
                self.opt_cfg, device=self.device, hash_proj=self.hash_proj)
        return self._train

    def _batch(self, batch):
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def step(self, state: EngineState, batch, lr):
        """One train step; updates ``state.params`` / ``state.opt_state``
        in place and returns (loss, stats, gnorm) on the device (the caller
        decides when to pay the host sync)."""
        if state.stages != self.base_dcfg.num_stages:
            raise NotImplementedError(
                "training on another stage count needs live resizes, not in "
                "repro_torch yet (ROADMAP Queue 1 [training]: live resize)")
        _, train_step = self.train_fns()
        self.last_step_compiled = not self.stepped
        self.stepped = True
        params, opt_state, loss, stats, gnorm = train_step(
            state.params, state.opt_state, state.assignment, state.dyn,
            batch, lr)
        state.params, state.opt_state = params, opt_state
        return loss, stats, gnorm

    @staticmethod
    def stats_to_host(state: EngineState, stats):
        """The per-slot stats tree ([S, L_max, ...]) on the host: a full
        device -> host sync — call it on controller cadence only."""
        return {k: v.detach().cpu().numpy() for k, v in stats.items()}

    @torch.no_grad()
    def eval_loss(self, state: EngineState, batch):
        """Loss only (no update) in the current world."""
        if self._eval_loss is None:
            self._eval_loss = build_loss_fn(
                self.cfg, self.base_dcfg, self.dyncfg, self.shapes,
                hash_proj=self.hash_proj)
        loss, _ = self._eval_loss(state.params, state.assignment, state.dyn,
                                  self._batch(batch))
        return loss

    # -- serving -------------------------------------------------------------
    def serve_fns(self, stages: int, live_micros: Optional[int] = None):
        """(prefill, decode) for this engine's world.  Decode variants are
        kept per live microbatch count: a variant for ``live_micros <
        num_micro`` runs ``live + S - 1`` ticks."""
        if stages != self.base_dcfg.num_stages:
            raise NotImplementedError(
                "serving on another stage count needs live resizes, not in "
                "repro_torch yet (ROADMAP Queue 1 [serve-elastic])")
        mv = self.shapes.num_micro if live_micros is None else live_micros
        if self._prefill is None:
            self._prefill = build_prefill_fn(
                self.cfg, self.base_dcfg, self.dyncfg, self.shapes,
                hash_proj=self.hash_proj)
        if mv not in self._decode:
            self._decode[mv] = build_decode_fn(
                self.cfg, self.base_dcfg, self.dyncfg, self.shapes,
                paged=self.paged is not None, num_micro=mv,
                hash_proj=self.hash_proj)
        return self._prefill, self._decode[mv]

    def prefill(self, state: EngineState, batch, cache=None):
        """Run prefill; returns (last_ids, cache).  The target cache
        (``cache``, else ``state.cache``) is written in place for EVERY lane
        of the batch, so the server prefills into a scratch and merges the
        admitted lanes (dense) or packs their pages (paged).
        ``self.last_moe_drop`` holds the call's mean MoE capacity-drop
        fraction."""
        pf, _ = self.serve_fns(state.stages)
        target = state.cache if cache is None else cache
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        ids, cache, drop = pf(state.params, state.assignment, state.dyn,
                              target, batch)
        self._note_moe_drop(drop)
        return ids, cache

    def decode(self, state: EngineState, tokens, pos, *, page_table=None,
               seeds=None, live_micros: Optional[int] = None):
        """One decode step; updates ``state.cache`` in place and returns
        (ids, logprobs).  ``page_table`` [m, B, J] is required iff the
        engine is paged; ``live_micros`` selects the decode variant;
        ``self.last_moe_drop`` as in :meth:`prefill`."""
        if seeds is not None:
            raise NotImplementedError(
                "per-lane sampling seeds need temperature > 0 (ROADMAP "
                "Queue 1 [serve-sampling])")
        _, dec = self.serve_fns(state.stages, live_micros)
        tokens = torch.as_tensor(tokens, device=self.device)
        pos = torch.as_tensor(pos, device=self.device)
        pt = None
        if self.paged is not None:
            assert page_table is not None, "paged decode needs a page table"
            pt = torch.as_tensor(page_table, dtype=torch.int32,
                                 device=self.device)
        ids, lp, state.cache, drop = dec(state.params, state.assignment,
                                         state.dyn, state.cache, tokens, pos,
                                         pt)
        self._note_moe_drop(drop)
        return ids, lp

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
        scratch and the dense server's cache and scratch."""
        dcfg = dataclasses.replace(self.base_dcfg, num_stages=stages)
        return M.init_cache(self.cfg, dcfg, self.shapes.num_micro,
                            self.shapes.mb_global, self.shapes.cache_len,
                            self.device)

    def pack_pages(self, state: EngineState, scratch, table, mask):
        """Scatter the admitted lanes' prompt pages from the dense prefill
        scratch into the block pool (``table``/``mask``: [m, B, J])."""
        dev = self.device
        return _pack_pages(state.cache, scratch["k"], scratch["v"],
                           torch.as_tensor(table, dtype=torch.int32,
                                           device=dev),
                           torch.as_tensor(mask, dtype=torch.bool,
                                           device=dev))

    def copy_block(self, state: EngineState, src: int, dst: int):
        """Copy-on-write fork: duplicate one physical block across every
        stage-slot pool."""
        return _copy_block(state.cache, int(src), int(dst))


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


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
