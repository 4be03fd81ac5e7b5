"""``input_specs``: stand-ins for every input of the train / prefill /
decode step of every (arch x shape x mesh) cell — the port of
``repro.launch.specs``.

Each leaf is a ``sharding.Placed`` (shape, dtype, partition tuple over a
``mesh.LogicalMesh``): nothing is allocated, on any device.  The trees are
the reference's: params (``model.param_spec``), the optimizer state
(``optimizers.opt_spec``), the assignment, the dyn state
(``model.dyn_spec``), the batch or the decode cache and tokens, and the
scalars (the learning rate, the decode position).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import (SHAPES, DistConfig, ModelConfig,
                                      get_config)
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import dp_degree
from repro_torch.models import model as M
from repro_torch.models.blocks import TensorSpec
from repro_torch.optim.optimizers import OptConfig, opt_spec
from repro_torch.pipeline.pipeline import PipelineShapes, plan_shapes


def arch_dist_config(arch: str, shape_name: str) -> DistConfig:
    """Per-arch distribution defaults for the production mesh, the
    reference's: llama3-405b takes Adafactor (AdamW's fp32 moments alone
    would not fit its stage shard), and FSDP is on only for archs above
    8e9 parameters (below that, stage-replicated weights and moments fit
    and drop the per-tick weight all-gather)."""
    optimizer = "adafactor" if arch == "llama3-405b" else "adamw"
    fsdp = get_config(arch).param_count() > 8e9
    return DistConfig(num_stages=16, slot_slack=1, remat="full",
                      optimizer=optimizer, fsdp=fsdp, param_dtype="bfloat16")


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape_name: str
    kind: str                        # train | prefill | decode
    cfg: ModelConfig
    dcfg: DistConfig
    dyncfg: DynamicsConfig
    shapes: PipelineShapes
    args: Tuple[Any, ...]            # trees of sharding.Placed
    skip_reason: Optional[str] = None


def cell_skip_reason(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and not cfg.is_subquadratic:
        return ("long_500k needs sub-quadratic attention; "
                f"{cfg.name} is full-attention (DESIGN.md §7)")
    if shape_name == "long_500k" and cfg.is_encdec:
        return "whisper decoder context << 500k (enc-dec); skipped"
    return None


def _spec(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(shape), dtype)


def _stream_specs(cfg: ModelConfig, m: int, B: int, s: int, train: bool):
    """The batch's token (and label) streams and its modality input."""
    out = {"tokens": _spec((m, B, s), torch.int32)}
    if train:
        out["labels"] = _spec((m, B, s), torch.int32)
        out["label_mask"] = _spec((m, B, s), torch.float32)
    if cfg.family == "vlm":
        out["prefix_emb"] = _spec((m, B, cfg.num_patches, cfg.d_model),
                                  torch.float32)
    if cfg.is_encdec:
        out["frames"] = _spec((m, B, cfg.encoder_seq, cfg.d_model),
                              torch.float32)
    return out


def cell_inputs(cfg: ModelConfig, dcfg: DistConfig, dyncfg: DynamicsConfig,
                kind: str, shapes: PipelineShapes, mesh) -> Tuple[Any, ...]:
    """The step's inputs for any configuration, placed on ``mesh``:
    (params, opt_state, assignment, dyn, batch, lr) to train, (params,
    assignment, dyn, cache, batch) to prefill, (params, assignment, dyn,
    cache, tokens, pos) to decode."""
    pspec = M.param_spec(cfg, dcfg)
    pshard = SH.param_shardings(cfg, dcfg, mesh, pspec)
    params = SH.attach(pspec, pshard)
    aspec = M.assignment_spec(cfg, dcfg)
    assignment = SH.attach(aspec, SH.stage_tree_shardings(aspec, mesh))
    dspec = M.dyn_spec(cfg, dcfg, dyncfg)
    dyn = SH.attach(dspec, SH.stage_tree_shardings(dspec, mesh))
    m, B, s = shapes.num_micro, shapes.mb_global, shapes.seq
    if kind == "train":
        otmpl = opt_spec(OptConfig(name=dcfg.optimizer), pspec)
        opt = SH.attach(otmpl, SH.opt_shardings(otmpl, pshard, mesh))
        bspec = _stream_specs(cfg, m, B, s, True)
        batch = SH.attach(bspec, SH.batch_shardings(bspec, mesh))
        lr = SH.Placed((), torch.float32)
        return (params, opt, assignment, dyn, batch, lr)
    cspec = M.cache_spec(cfg, dcfg, m, B, shapes.seq)
    cache = SH.attach(cspec, SH.cache_shardings(cspec, mesh))
    if kind == "prefill":
        bspec = _stream_specs(cfg, m, B, s, False)
        batch = SH.attach(bspec, SH.batch_shardings(bspec, mesh))
        return (params, assignment, dyn, cache, batch)
    tspec = {"tokens": _spec((m, B), torch.int32)}
    tokens = SH.attach(tspec, SH.batch_shardings(tspec, mesh))["tokens"]
    pos = SH.Placed((), torch.int32)
    return (params, assignment, dyn, cache, tokens, pos)


def input_specs(arch: str, shape_name: str, mesh,
                dcfg: Optional[DistConfig] = None) -> CellSpec:
    """The cell's inputs under ``dcfg`` (default ``arch_dist_config``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    dcfg = dcfg or arch_dist_config(arch, shape_name)
    dyncfg = DynamicsConfig()
    skip = cell_skip_reason(cfg, shape_name)
    shapes = plan_shapes(cfg, dcfg, shape.kind, shape.seq_len,
                         shape.global_batch, dp_degree(mesh))
    args = () if skip else cell_inputs(cfg, dcfg, dyncfg, shape.kind,
                                       shapes, mesh)
    return CellSpec(arch, shape_name, shape.kind, cfg, dcfg, dyncfg, shapes,
                    args, skip)
