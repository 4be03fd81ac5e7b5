"""Gradual global magnitude pruning (paper §3.2.1, Algorithm 1) — the
PyTorch port of ``repro.dynamics.pruning``.

Feature blocks of width ``PRUNE_BLOCK`` (128) are pruned from the FFN
projections by an exact global top-k over block magnitude scores computed on
the stacked stage weights.  The resulting ``ff_mask`` [S, L_max, n_blocks]
is the runtime dyn input: the pruned-matmul kernel (K3) skips dead blocks
forward and backward.  Every branch of the reference's scores is here:
dense (wi, wg, wof), whisper's encoder / decoder FFNs, the mLSTM
up-projection, and MoE experts summed over the experts (the reference's
``moe_ffn`` reads no ``ff_mask``, so pruning an MoE arch changes the mask
and the controller's costs but no expert's compute — mirrored here).
Hybrid (Mamba2) and sLSTM-only stacks have nothing to prune and raise the
reference's ``ValueError``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import BLOCK_PAD, ModelConfig
from repro_torch.models.blocks import n_prune_blocks


def block_magnitudes(cfg: ModelConfig, stage_params: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
    """L2 magnitude per prunable feature block: [S, L_max, n_blocks] fp32,
    computed one stage row at a time (a rank holding one row computes the
    same bits as one process holding all of them)."""
    S = next(iter(stage_params.values())).shape[0]
    return torch.cat([_row_magnitudes(cfg, {k: v[s:s + 1]
                                             for k, v in stage_params.items()})
                      for s in range(S)])


def _row_magnitudes(cfg: ModelConfig, stage_params: Dict[str, torch.Tensor]
                    ) -> torch.Tensor:
    """``block_magnitudes`` of stacked stage params.

    Dense / enc / dec archs: blocks of d_ff columns of the up-projections
    and rows of the down-projection; mLSTM: blocks of the up-projection's
    columns; MoE: blocks of d_ff columns of every expert's ewi and ewg."""
    npb = n_prune_blocks(cfg)

    def score(*mats):
        tot = None
        for name, axis in mats:
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

    if "wi" in stage_params:        # dense
        return score(("wi", "col"), ("wg", "col"), ("wof", "row"))
    if "e_w1" in stage_params:      # whisper encoder (+ decoder)
        s = score(("e_w1", "col"), ("e_w2", "row"))
        if "d_w1" in stage_params:
            s = s + score(("d_w1", "col"), ("d_w2", "row"))
        return s
    if "x_up" in stage_params:      # mLSTM up-projection
        return score(("x_up", "col"))
    if "ewi" in stage_params:       # MoE experts: summed over the experts
        S, L, E, d, F = stage_params["ewi"].shape
        v = sum(stage_params[k].float().square().reshape(
            S, L, E, d, npb, F // npb).sum(dim=(2, 3, 5))
            for k in ("ewi", "ewg"))
        return v.sqrt()
    raise ValueError("no prunable parameters found")


@torch.no_grad()
def global_block_prune(cfg: ModelConfig, stage_params, tags,
                       keep_blocks: int, mesh=None) -> torch.Tensor:
    """Exact global top-k over block magnitudes -> ff_mask [S, L_max, npb]
    (float32, on the params' device).  PAD slots are excluded and always
    masked.  With a ``mesh`` the params are this rank's row: every rank
    all-gathers the rows' magnitudes, takes the same top-k and returns its
    row of the mask ([1, L_max, npb])."""
    mag = block_magnitudes(cfg, stage_params)          # [S, L, npb]
    if mesh is not None:
        mag = mesh.comm.all_gather(mag[0], mesh.model_group)
        s = mesh.stage
        return _top_k_mask(mag, tags, keep_blocks)[s:s + 1]
    return _top_k_mask(mag, tags, keep_blocks)


def _top_k_mask(mag, tags, keep_blocks: int) -> torch.Tensor:
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
