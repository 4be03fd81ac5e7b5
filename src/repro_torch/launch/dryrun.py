"""The dry run: memory, FLOPs, bytes and a roofline for every (arch x
shape x mesh) cell, without a card — the port of ``repro.launch.dryrun``.

Nothing is computed on any device.  The reference lowers and compiles
each cell's step on 512 placeholder devices; the port builds the step's
inputs as stand-ins (``launch.specs``: shapes, dtypes and partition
tuples over a ``LogicalMesh``) and, with ``--probes``, runs one piece of
the step on ``meta`` tensors under a counting mode.  Per cell (a JSON under
``results/dryrun_torch/``):

  * ``memory`` — per card: ``argument_bytes_per_chip`` (exact: every
    input leaf's shard under its placement); the bytes of the whole
    cell's parameters and optimizer state, each leaf once
    (``params_bytes``, ``opt_bytes``); ``output_bytes_per_chip`` and
    ``alias_bytes_per_chip`` under the port's donation convention: a
    train step updates the parameters and the optimizer state in place
    and a serve step the cache, so each of those outputs is its argument
    (alias), and the step's new outputs are the loss, the clip norm and
    the per-slot stats (train) or the token ids, log-probs and the MoE
    drop sum (serve); ``temp_bytes_per_chip``: the probes' live peak
    scaled to the step's ``m`` microbatches where they ran, else None;
    ``peak_bytes_per_chip`` = argument + output + temp - alias and
    ``fits_80GB`` (against 80e9 bytes, the card's data-sheet size), both
    None without a probe: the arguments alone are no verdict.
  * ``roofline`` — the reference's analytic terms (``analytic_roofline``,
    ``analytic_hbm``, line for line: the hottest stage's cost-model FLOPs,
    HBM bytes, the structural collective bytes and the model FLOPs) with
    an H100's constants (``launch.roofline``).
  * ``probe`` (``--probes``) — the counted terms: the last stage's slots
    (the stage the analytic term takes, the one with the head) for two
    and three microbatches, every forward and then, for a train cell,
    one backward (the cell's remat recomputes the forward in it), as the
    port's step runs them, on ``meta`` tensors under
    ``counting.CountingMode``: FLOPs by ``torch.utils.flop_counter``'s
    formulas, bytes in and out per op, the live-bytes peak, and K1-K5 by
    their own formulas (``kernels.accounting``).  A step runs ``m``
    microbatches on a stage and no bubble ticks (``pipeline._ticks``),
    and keeps what each microbatch's backward needs until the backward:
    the two probes give what one more microbatch adds (``per_micro``), and
    ``roofline.extrapolate`` takes the terms to ``m`` (``per_step``, the
    temp peak) and to the reference's schedule form ``T_real = m + S -
    1`` ticks, printed beside it.  The assignment is
    host-side Python and the ``frozen`` leaf, which the host reads, a
    small CPU tensor; everything the math touches is on ``meta``.  A cell
    whose probe cannot run records the reason under ``probe.error`` (an
    xLSTM prefill over more than ``PROBE_RECURRENT_POSITIONS`` positions,
    whose per-position recurrence would take minutes on ``meta``).

``cell_terms`` gives the same for a configuration that is not in
``SHAPES`` (a ``ModelConfig``, ``DistConfig``, ``PipelineShapes`` and mesh).

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k \\
      --probes
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--probes]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (BLOCK_MLSTM, BLOCK_PAD, BLOCK_SLSTM,
                                      SHAPES,
                                      DistConfig, ModelConfig, get_config)
from repro_torch.core import cost_model as CM
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as SH
from repro_torch.launch.counting import CountingMode
from repro_torch.launch.mesh import dp_degree, make_production_mesh
from repro_torch.launch.specs import (CellSpec, arch_dist_config,
                                      cell_inputs, cell_skip_reason,
                                      input_specs)
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.pipeline.pipeline import PipelineShapes

ARCHS = [
    "mixtral-8x7b", "mixtral-8x22b", "llama3-405b", "command-r-plus-104b",
    "smollm-360m", "deepseek-coder-33b", "internvl2-26b", "zamba2-1.2b",
    "xlstm-1.3b", "whisper-large-v3",
]
RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
CARD_BYTES = 80e9
# an xLSTM prefill steps its recurrences one position at a time (~17 ms a
# position on meta; a 32k-position prefill takes ~10 minutes), so a longer
# prefill of an xLSTM stage is not probed
PROBE_RECURRENT_POSITIONS = 1024


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.axis_sizes)


# ---------------------------------------------------------------------------
# Analytic terms (the reference's, line for line)
# ---------------------------------------------------------------------------
def analytic_roofline(cell, chips: int, T_real: int, *,
                      peak_flops: Optional[float] = None,
                      hbm_bw: float = RL.HBM_BW,
                      link_bw: Optional[float] = None) -> Dict[str, Any]:
    """Cost-model roofline terms: the hottest stage's FLOPs, analytic HBM
    bytes, and a structural collective estimate (ppermute carries + DP
    gradient all-reduce + FSDP weight all-gathers when enabled).  The
    constants default to the H100's (``roofline``; the peak by the cell's
    parameter dtype, the link by the mesh size)."""
    cfg, shapes, dcfg = cell.cfg, cell.shapes, cell.dcfg
    S = dcfg.num_stages
    dp = chips // S
    pattern = cfg.block_pattern()
    per_stage = (len(pattern) + S - 1) // S
    L_max = dcfg.slots_for(cfg)
    stage_pattern = pattern[-per_stage:]
    train = cell.kind == "train"
    if cell.kind == "decode":
        tokens_tick = max(1, shapes.mb_global // dp)
        seq = shapes.seq
    else:
        tokens_tick = max(1, shapes.mb_global // dp) * shapes.seq_total
        seq = shapes.seq_total
    slot_mult = L_max / max(1, per_stage)      # masked_scan pad overhead
    fwd = sum(CM.layer_flops(cfg, bt, tokens_tick, seq)
              for bt in stage_pattern) * slot_mult
    per_tick = fwd * (4.0 if train else 1.0)   # fwd + bwd(2) + remat(1)
    flops = T_real * per_tick
    if train:                                  # vocab head on last stage
        flops += (shapes.num_micro * 2 * tokens_tick * cfg.d_model
                  * cfg.vocab_size * 3)
    hbm = analytic_hbm(cell, chips, T_real)
    # collectives per chip: ppermute carry each tick + grad psum + FSDP
    carry = tokens_tick * cfg.d_model * 2
    if cfg.is_encdec:
        carry += max(1, shapes.mb_global // dp) * cfg.encoder_seq \
            * cfg.d_model * 2
    coll = T_real * carry
    stage_params = sum(cfg.params_per_block(bt) for bt in stage_pattern) \
        * slot_mult
    if train:
        coll += 2 * stage_params * 4 * (dp - 1) / dp       # DP grad reduce
        if dcfg.fsdp:
            coll += T_real * 3 * stage_params * 2 / dp     # AG fwd/bwd/remat
        emb_head = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings
                                                   else 2)
        coll += 2 * emb_head * 4 / chips                   # psum over model
    mf = CM.model_flops(
        cfg, shapes.num_micro * shapes.mb_global
        * (1 if cell.kind == "decode" else shapes.seq), train=train)
    terms = RL.RooflineTerms(
        flops=flops, hbm_bytes=hbm, coll_bytes=coll, chips=chips,
        model_flops=mf,
        peak_flops=(RL.peak_flops(dcfg.param_dtype) if peak_flops is None
                    else peak_flops),
        hbm_bw=hbm_bw,
        link_bw=RL.link_bandwidth(chips) if link_bw is None else link_bw)
    d = terms.as_dict()
    d["analytic"] = True
    d["t_memory_analytic_s"] = hbm / hbm_bw
    return d


def analytic_hbm(cell, chips: int, T_real: int) -> float:
    """Analytic per-chip HBM bytes for one step (hottest stage)."""
    cfg, shapes = cell.cfg, cell.shapes
    S = cell.dcfg.num_stages
    dp = chips // S
    pattern = cfg.block_pattern()
    per_stage = (len(pattern) + S - 1) // S
    stage_pattern = pattern[-per_stage:]          # last stage (has the head)
    if cell.kind == "decode":
        tokens_tick = max(1, shapes.mb_global // dp)
        seq = shapes.seq
    else:
        tokens_tick = max(1, shapes.mb_global // dp) * shapes.seq_total
        seq = shapes.seq_total
    per_tick = sum(CM.layer_bytes(cfg, bt, tokens_tick, seq)
                   for bt in stage_pattern)
    mult = 3.0 if cell.kind == "train" else 1.0   # fwd + bwd + remat
    total = T_real * per_tick * mult
    # head + embed traffic (last stage / stage 0)
    head_bytes = cfg.d_model * cfg.vocab_size * 4 / max(1, dp)
    if cell.kind == "train":
        tok_total = shapes.num_micro * max(1, shapes.mb_global // dp) \
            * shapes.seq
        total += shapes.num_micro * head_bytes * 3
        total += tok_total * cfg.vocab_size * 4 / 32   # logit stream, fused
        # optimizer: read+write params + 2 moments on this stage's shard
        stage_params = sum(cfg.params_per_block(bt) for bt in stage_pattern)
        total += stage_params / max(1, dp) * (2 + 4 + 4) * 2
    else:
        total += head_bytes * shapes.num_micro
    return float(total)


# ---------------------------------------------------------------------------
# Memory
# ---------------------------------------------------------------------------
def _stats_bytes_per_chip(cfg: ModelConfig, dcfg: DistConfig) -> int:
    """The per-slot stats a train step returns, [S, L_max, ...] each,
    one stage row a card."""
    L_max = dcfg.slots_for(cfg)
    n = 0
    for s in B.stats_spec(cfg).values():
        k = L_max * s.dtype.itemsize
        for d in s.shape:
            k *= d
        n += k
    return n


def memory_terms(cell, mesh, temp: Optional[int] = None) -> Dict[str, Any]:
    """The ``memory`` entry of a cell (module docstring)."""
    args = cell.args
    arg = sum(SH.tree_bytes(a, mesh) for a in args)
    params = args[0]
    out_new = 0
    if cell.kind == "train":
        opt = args[1]
        alias = SH.tree_bytes(params, mesh) + SH.tree_bytes(opt, mesh)
        out_new = 4 + 4 + _stats_bytes_per_chip(cell.cfg, cell.dcfg)
        opt_bytes = SH.tree_bytes(opt)
    else:
        cache = args[3]
        alias = SH.tree_bytes(cache, mesh)
        tokens = args[4]["tokens"] if cell.kind == "prefill" else args[4]
        ids = SH.Placed(tokens.shape[:2], torch.int32,
                        tokens.placement[:2])
        out_new = SH.shard_bytes(ids, mesh) * (
            2 if cell.kind == "decode" else 1) + 4
        opt_bytes = 0
    out = alias + out_new
    # without a probe nothing counts the activations: no verdict
    peak = None if temp is None else arg + out + temp - alias
    return {
        "argument_bytes_per_chip": arg,
        "params_bytes": SH.tree_bytes(params),
        "opt_bytes": opt_bytes,
        "params_bytes_per_chip": SH.tree_bytes(params, mesh),
        "output_bytes_per_chip": out,
        "alias_bytes_per_chip": alias,
        "temp_bytes_per_chip": temp,
        "peak_bytes_per_chip": peak,
        "fits_80GB": None if peak is None else peak < CARD_BYTES,
    }


# ---------------------------------------------------------------------------
# The counted probe
# ---------------------------------------------------------------------------
def stage_tags(cfg: ModelConfig, dcfg: DistConfig, stage: int):
    """(tags, depth base) of one stage under the uniform split, as host
    ints (``model.make_assignment``'s row, without its tensors)."""
    pattern = cfg.block_pattern()
    lps = M.uniform_boundaries(len(pattern), dcfg.num_stages)
    start = sum(lps[:stage])
    row = pattern[start:start + lps[stage]]
    return row + [BLOCK_PAD] * (dcfg.slots_for(cfg) - len(row)), start


def probe_stage(cfg: ModelConfig, dcfg: DistConfig, dyncfg: DynamicsConfig,
                kind: str, shapes: PipelineShapes, dp: int = 1, *,
                stages: Optional[Sequence[int]] = None, micro: int = 1,
                device="meta", kernel_impl: str = "pallas") -> Dict[str, Any]:
    """Count ``micro`` microbatches through ``stages`` (default: the last
    stage, with the head) as the port's schedule runs them on one card:
    every microbatch's forward, each keeping what its backward needs, then
    one backward for ``kind == "train"``, with the cell's remat.  A
    microbatch's carry into the first of ``stages`` counts in the live
    bytes from its microbatch on (it arrives from the previous stage); the
    parameters, dyn rows, cache and batch are arguments, not counted.
    ``device`` "cpu" runs the same ops on real (zero) tensors, for tests.
    Returns the counting mode's totals."""
    S = dcfg.num_stages
    stages = [S - 1] if stages is None else list(stages)
    dcfg = dataclasses.replace(dcfg, kernel_impl=kernel_impl)
    train = kind == "train"
    dt = M.param_dtype(dcfg)
    b = max(1, shapes.mb_global // dp)
    seq = 1 if kind == "decode" else shapes.seq_total
    rows = {s: stage_tags(cfg, dcfg, s) for s in stages}
    if (kind == "prefill" and seq > PROBE_RECURRENT_POSITIONS and any(
            {BLOCK_MLSTM, BLOCK_SLSTM} & set(t) for t, _ in rows.values())):
        raise ValueError(f"not probed: an xLSTM prefill steps through "
                         f"{seq} positions one by one (over "
                         f"{PROBE_RECURRENT_POSITIONS})")

    def make(shape, dtype, grad=False):
        t = (torch.empty(shape, dtype=dtype, device="meta")
             if device == "meta" else
             torch.zeros(shape, dtype=dtype, device=device))
        return t.requires_grad_(True) if grad else t

    L_max = dcfg.slots_for(cfg)
    dyn0 = M.init_dyn(cfg, dcfg, dyncfg, device)
    args = {}
    for s in stages:
        stage_p = {k: make((L_max,) + v.shape, v.dtype, train)
                   for k, v in B.slot_param_spec(cfg, dt).items()}
        dyn = {k: (torch.zeros(v.shape[1:], dtype=v.dtype) if k == "frozen"
                   else (make(v.shape[1:], v.dtype) if device == "meta"
                         else v[s]))
               for k, v in dyn0.items()}
        cache = None
        if kind != "train":
            cache = {k: make((L_max, b) + v.shape[1:], v.dtype)
                     for k, v in B.slot_cache_spec(
                         cfg, b, shapes.cache_len or shapes.seq).items()}
        args[s] = (stage_p, dyn, cache)
    shared = {k: make(v.shape, v.dtype, train)
              for k, v in B.shared_param_spec(cfg, torch.float32).items()}
    pos = (make((), torch.int32) if kind == "decode"
           else torch.arange(seq, device=device))
    final_norm = make((cfg.d_model,), torch.float32, train)
    head = make((cfg.d_model, cfg.vocab_size), torch.float32, train)
    batch = [(make((b, shapes.seq), torch.int32),
              make((b, shapes.seq), torch.float32)) for _ in range(micro)]

    def make_carry():
        carry = {"x": make((b, seq, cfg.d_model), dt, train)}
        if cfg.is_encdec and kind != "decode":
            carry["enc"] = make((b, shapes.enc_seq, cfg.d_model), dt, train)
        if dyncfg.uses_early_exit and kind != "decode":
            carry["exited"] = make((b, seq), torch.float32)
        return carry

    carries = [make_carry() for _ in range(micro)]
    last = stages[-1] == S - 1

    def stage_fn(carry, s):
        stage_p, dyn, cache = args[s]
        tags, depth = rows[s]
        return M.stage_forward(cfg, dcfg, dyncfg, kind, stage_p, shared,
                               tags, dyn, carry, cache, pos, depth)

    with CountingMode() as mode:
        outs, loss = [], 0.0
        for mi in range(micro):
            carry = carries[mi]
            mode.track(carry)          # live on this card from its arrival
            aux = 0.0
            for s in stages:
                if train and dcfg.remat == "full":
                    carry, _, _, a = checkpoint(stage_fn, carry, s,
                                                use_reentrant=False)
                else:
                    carry, _, _, a = stage_fn(carry, s)
                aux = aux + a
            if not last:
                outs.append(carry["x"])
            elif train:
                from repro_torch.pipeline.pipeline import _micro_loss
                h = carry["x"][:, shapes.prefix:]
                nll, cnt = checkpoint(_micro_loss, final_norm, head, h,
                                      *batch[mi], cfg.norm_eps,
                                      use_reentrant=False)
                loss = loss + nll / torch.clamp(cnt, min=1.0) \
                    + M.AUX_LOSS_COEF * aux / (
                        shapes.num_micro * max(1, cfg.total_blocks()))
            else:
                x = carry["x"][:, -1] if kind == "prefill" else \
                    carry["x"][:, 0]
                hn = M.rms_norm(x, final_norm, cfg.norm_eps)
                torch.argmax(M.matmul(hn, head).float(), dim=-1)
        if train and last:
            loss.backward()
        elif train:
            torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
    res = mode.totals()
    res.update(stages=stages, micro=micro, microbatch_lanes=b,
               kernel_impl=kernel_impl,
               slots=sum(1 for s in stages for t in rows[s][0]
                         if t != BLOCK_PAD))
    return res


def probe_step(cfg: ModelConfig, dcfg: DistConfig, dyncfg: DynamicsConfig,
               kind: str, shapes: PipelineShapes, dp: int = 1, *,
               stages: Optional[Sequence[int]] = None,
               kernel_impl: str = "pallas"):
    """Two probes, of ``k`` and ``k + 1`` microbatches with ``k = min(m,
    2)``: from the second microbatch on each adds the same work and keeps
    the same bytes until the backward (the first one's gradients need no
    sum into another's), so ``scale_probe`` takes them to ``m`` exactly."""
    k = min(shapes.num_micro, 2)
    return tuple(probe_stage(cfg, dcfg, dyncfg, kind, shapes, dp,
                             stages=stages, micro=j, kernel_impl=kernel_impl)
                 for j in (k, k + 1))


def scale_probe(lo: Dict[str, Any], hi: Dict[str, Any], m: int
                ) -> Dict[str, float]:
    """Two probes (``probe_step``) extrapolated to ``m`` microbatches
    (``roofline.extrapolate``): FLOPs, bytes and the live peak."""
    keys = ("flops", "bytes", "peak_bytes")
    return RL.extrapolate({k: lo[k] for k in keys},
                          {k: hi[k] for k in keys}, lo["micro"],
                          hi["micro"], m)


def counted_terms(cell, chips: int, lo: Dict[str, Any],
                  hi: Dict[str, Any]) -> Dict[str, Any]:
    """The probes scaled to a step of the hottest stage: ``m`` microbatches
    (the port's schedule), and the reference's ``m + S - 1`` ticks beside
    it; the roofline of the counted FLOPs and bytes with the analytic
    collective bytes.  ``per_micro`` is what one more microbatch adds."""
    m, S = cell.shapes.num_micro, cell.dcfg.num_stages
    T_real = m + S - 1
    step = scale_probe(lo, hi, m)
    an = analytic_roofline(cell, chips, T_real)
    terms = RL.RooflineTerms(
        flops=step["flops"], hbm_bytes=step["bytes"],
        coll_bytes=an["coll_bytes_per_chip"], chips=chips,
        model_flops=an["model_flops"],
        peak_flops=RL.peak_flops(cell.dcfg.param_dtype),
        link_bw=RL.link_bandwidth(chips))
    return {"per_micro": {k: hi[k] - lo[k] for k in ("flops", "bytes",
                                                     "peak_bytes")},
            "kernels": {name: {k: v - lo["kernels"][name][k]
                               for k, v in w.items()}
                        for name, w in hi["kernels"].items()},
            "num_micro": m, "T_real": T_real,
            "flops_per_step": step["flops"],
            "flops_per_step_T_real": scale_probe(lo, hi, T_real)["flops"],
            "temp_bytes": step["peak_bytes"],
            "roofline": terms.as_dict()}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------
def cell_terms(cell: CellSpec, mesh, *, probes: bool = False,
               kernel_impl: str = "pallas") -> Dict[str, Any]:
    """Memory, analytic roofline and (``probes``) counted terms of a cell
    with its inputs built (``specs.input_specs`` or ``config_cell``)."""
    chips = mesh.size
    S = cell.dcfg.num_stages
    T_real = cell.shapes.num_micro + S - 1
    out: Dict[str, Any] = {
        "num_micro": cell.shapes.num_micro,
        "mb_global": cell.shapes.mb_global, "seq": cell.shapes.seq,
        "kind": cell.kind, "L_max": cell.dcfg.slots_for(cell.cfg),
        "fsdp": cell.dcfg.fsdp, "optimizer": cell.dcfg.optimizer}
    temp = None
    if probes:
        try:
            t0 = time.perf_counter()
            lo, hi = probe_step(cell.cfg, cell.dcfg, cell.dyncfg,
                                cell.kind, cell.shapes, dp_degree(mesh),
                                kernel_impl=kernel_impl)
            out["probe"] = counted_terms(cell, chips, lo, hi)
            out["probe"]["seconds"] = time.perf_counter() - t0
            temp = out["probe"]["temp_bytes"]
        except Exception as e:  # noqa: BLE001 — recorded per cell
            out["probe"] = {"error": f"{type(e).__name__}: {e}"}
    out["memory"] = memory_terms(cell, mesh, temp)
    out["roofline"] = analytic_roofline(cell, chips, T_real)
    return out


def config_cell(cfg: ModelConfig, dcfg: DistConfig, kind: str,
                shapes: PipelineShapes, mesh,
                dyncfg: Optional[DynamicsConfig] = None) -> CellSpec:
    """A cell for a configuration that is not in ``SHAPES``."""
    dyncfg = dyncfg or DynamicsConfig()
    return CellSpec(cfg.name, kind, kind, cfg, dcfg, dyncfg, shapes,
                    cell_inputs(cfg, dcfg, dyncfg, kind, shapes, mesh))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             probes: bool = False, verbose: bool = True,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    mesh = make_production_mesh(multi_pod=multi_pod)
    out: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name(mesh), "chips": mesh.size}
    skip = cell_skip_reason(get_config(arch), shape_name)
    if skip:
        out["skipped"] = skip
        return out
    dcfg = arch_dist_config(arch, shape_name)
    if overrides:
        dcfg = dataclasses.replace(dcfg, **overrides)
        out["overrides"] = dict(overrides)
    cell = input_specs(arch, shape_name, mesh, dcfg=dcfg)
    out.update(cell_terms(cell, mesh, probes=probes))
    if verbose:
        mem, rl = out["memory"], out["roofline"]
        peak = mem["peak_bytes_per_chip"]
        print(f"[{arch} x {shape_name} x {out['mesh']}] arguments/chip "
              f"{mem['argument_bytes_per_chip'] / 2 ** 30:.2f} GiB, peak "
              + ("not probed" if peak is None else
                 f"{peak / 2 ** 30:.2f} GiB")
              + f" fits_80GB={mem['fits_80GB']}; analytic: compute "
              f"{rl['t_compute_s']:.4f}s memory {rl['t_memory_s']:.4f}s "
              f"collective {rl['t_collective_s']:.4f}s -> "
              f"{rl['bottleneck']}-bound")
        pr = out.get("probe")
        if pr and "error" in pr:
            print(f"  probe: {pr['error']}")
        elif pr:
            print(f"  probe: {pr['flops_per_step']:.4e} FLOP a step "
                  f"({pr['num_micro']} micro; T_real form "
                  f"{pr['flops_per_step_T_real']:.4e}), temp "
                  f"{pr['temp_bytes'] / 2 ** 30:.2f} GiB, "
                  f"{pr['roofline']['bottleneck']}-bound")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--force", action="store_true")
    # DistConfig overrides
    ap.add_argument("--slot-slack", type=int, default=None)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--tag", default="",
                    help="suffix for the result file")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    overrides = {}
    if args.slot_slack is not None:
        overrides["slot_slack"] = args.slot_slack
    if args.no_fsdp:
        overrides["fsdp"] = False
    if args.remat:
        overrides["remat"] = args.remat
    if args.optimizer:
        overrides["optimizer"] = args.optimizer
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    name = mesh_name(make_production_mesh(multi_pod=args.multi_pod))
    failures, results = [], []
    for a, s in cells:
        suffix = f"__{args.tag}" if args.tag else ""
        path = os.path.join(args.out, f"{a}__{s}__{name}{suffix}.json")
        if os.path.exists(path) and not args.force:
            print(f"skip (cached): {path}")
            continue
        try:
            res = run_cell(a, s, multi_pod=args.multi_pod,
                           probes=args.probes, overrides=overrides or None)
        except Exception as e:  # noqa: BLE001 — record and continue
            traceback.print_exc()
            res = {"arch": a, "shape": s, "mesh": name,
                   "error": f"{type(e).__name__}: {e}"}
            failures.append((a, s))
        results.append(res)
        with open(path, "w") as fh:
            json.dump(res, fh, indent=2, default=str)
    print(json.dumps(summary(results, name)))
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete")
    return results


def summary(results, name: str) -> Dict[str, Any]:
    """One line per mesh: cells, analysed, skipped, the fits_80GB verdicts
    (probed cells only; ``unprobed`` have none) and the bottleneck
    counts."""
    done = [r for r in results if "memory" in r]
    bott: Dict[str, int] = {}
    for r in done:
        k = r["roofline"]["bottleneck"]
        bott[k] = bott.get(k, 0) + 1
    return {"mesh": name, "cells": len(results), "analysed": len(done),
            "skipped": sum(1 for r in results if "skipped" in r),
            "fits_80GB": sum(1 for r in done
                             if r["memory"]["fits_80GB"] is True),
            "over_80GB": sum(1 for r in done
                             if r["memory"]["fits_80GB"] is False),
            "unprobed": sum(1 for r in done
                            if r["memory"]["fits_80GB"] is None),
            "bottleneck": bott,
            "probes": sum(1 for r in done if "probe" in r
                          and "error" not in r["probe"])}


if __name__ == "__main__":
    main()
