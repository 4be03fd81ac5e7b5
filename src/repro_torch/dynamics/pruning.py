"""Gradual global magnitude pruning (paper §3.2.1, Algorithm 1) — the
PyTorch port of ``repro.dynamics.pruning``.

Feature blocks of width ``PRUNE_BLOCK`` (128) are pruned from the FFN
projections by an exact global top-k over block magnitude scores computed on
the stacked stage weights.  The resulting ``ff_mask`` [S, L_max, n_blocks]
is the runtime dyn input: the pruned-matmul kernel (K3) skips dead blocks
forward and backward.  This slice ports the dense block's scores; other
block families raise with their ROADMAP item.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import BLOCK_PAD, ModelConfig
from repro_torch.models.blocks import n_prune_blocks


def block_magnitudes(cfg: ModelConfig, stage_params: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
    """L2 magnitude per prunable feature block: [S, L_max, n_blocks] fp32,
    from blocks of d_ff columns of (wi, wg) and rows of wof."""
    if "wi" not in stage_params:
        raise NotImplementedError(
            "block magnitudes of MoE experts and other non-dense block "
            "families are not in repro_torch yet (ROADMAP Queue 1 "
            "[moe-rest], [block-families])")
    npb = n_prune_blocks(cfg)
    tot = None
    for name, axis in (("wi", "col"), ("wg", "col"), ("wof", "row")):
        m = stage_params[name].float()
        S, L = m.shape[0], m.shape[1]
        if axis == "col":
            F = m.shape[3]
            v = m.square().reshape(S, L, m.shape[2], npb, F // npb).sum(
                dim=(2, 4))
        else:
            F = m.shape[2]
            v = m.square().reshape(S, L, npb, F // npb, m.shape[3]).sum(
                dim=(3, 4))
        tot = v if tot is None else tot + v
    return tot.sqrt()


@torch.no_grad()
def global_block_prune(cfg: ModelConfig, stage_params, tags,
                       keep_blocks: int) -> torch.Tensor:
    """Exact global top-k over block magnitudes -> ff_mask [S, L_max, npb]
    (float32, on the params' device).  PAD slots are excluded and always
    masked."""
    mag = block_magnitudes(cfg, stage_params)          # [S, L, npb]
    active = (torch.as_tensor(tags).to(mag.device) != BLOCK_PAD)[..., None]
    mag = torch.where(active, mag, torch.full_like(mag, -float("inf")))
    flat = mag.reshape(-1)
    k = min(keep_blocks, flat.shape[0])
    thresh = torch.topk(flat, k).values[-1]
    mask = (mag >= thresh) & active & torch.isfinite(mag)
    return mask.float()


def target_keep_blocks(cfg: ModelConfig, num_active_layers: int,
                       sparsity: float) -> int:
    npb = n_prune_blocks(cfg)
    total = num_active_layers * npb
    return max(num_active_layers, int(round(total * (1.0 - sparsity))))
