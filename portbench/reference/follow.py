"""The steps a training cell's check follows, and the readings taken on
them: the reference's, and those of a stand-in that takes the program's
place (the control, a planted fault).

The reference trains from the benchmark's weights through every step the
program ran before its window, ``0 .. last``, in fp32 with TF32 off.  At
the prune step it takes its own block magnitudes and, where a block lies
within a tie of the threshold, the program's choice (``compare.check_mask``),
so that it follows the program through the prune.  The readings, by
step, are those ``compare.judge`` holds the program's to."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from . import compare, dense, schedule


@dataclass(frozen=True)
class Plan:
    """Segment A: steps ``0 .. a_n - 1`` (loss, first gradient, change);
    the prune after ``mask_step`` (keeping ``keep`` blocks of ``npb`` a
    layer); segment B: the state after ``b_from`` and the change from it
    to ``last``."""
    a_n: int
    mask_step: Optional[int]
    b_from: Optional[int]
    last: int
    keep: Optional[int]
    npb: int

    @classmethod
    def of(cls, check: Dict, layers: int, npb: int, total: int,
           prune: Optional[tuple]) -> "Plan":
        """From a traffic file's ``check`` and the spec (``prune``: the
        schedule's initial and final share, or None)."""
        a_n, b_from = int(check["a_steps"]), check.get("b_from")
        mask_step = check.get("mask_step") if prune else None
        last = (b_from + int(check["b_steps"]) if b_from is not None
                else a_n - 1)
        keep = (schedule.keep_blocks(layers, npb, schedule.sparsity(
            mask_step, total, *prune)) if mask_step is not None else None)
        return cls(a_n, mask_step, b_from, last, keep, npb)


def following(prog_mask: torch.Tensor, keep: int) -> Callable:
    """The reference's prune: its own top blocks, the program's choice at
    a tie."""
    return lambda mags: compare.check_mask(prog_mask, mags, keep)[1]


def own_top(keep: int) -> Callable:
    """A stand-in's prune: the top ``keep`` blocks of its own magnitudes."""
    return lambda mags: compare.top_blocks(mags, keep)


def readings(c: Dict, W0: Dict[str, torch.Tensor], batches, lr,
             plan: Plan, choose: Callable, **trainer) -> Dict:
    """A ``dense.Trainer`` from ``W0`` (taken over) through steps
    ``0 .. plan.last``.  ``choose(magnitudes) -> [L, npb] bool`` makes
    the prune's mask.  Returns loss by step, AdamW's step count after
    ``b_from`` and ``last``, per leaf the norms of the first step's
    clipped gradient (``grad0``) and of segment B's first (``grad_b``),
    of the change over segment A (``change_a``), of the change from the
    start to ``b_from`` (``state_b``) and from ``b_from`` to ``last``
    (``change_b``); and the prune's magnitudes and mask."""
    t = dense.Trainer(c, W0, **trainer)
    dev = t.W["embed"].device
    then = {k: v.clone() for k, v in t.leaves().items()}
    out: Dict = {"loss": {}, "count": {}}
    masks = None
    for k in range(plan.last + 1):
        out["loss"][k], gn = t.step(batches[k], lr(k), masks)
        if k == 0:
            out["grad0"] = gn
        if k == plan.a_n - 1:
            out["change_a"] = compare.change_norms(t.leaves(), then)
        if k == plan.mask_step:
            mags = dense.block_magnitudes(t.W, plan.npb).cpu()
            blocks = choose(mags)
            out["mags"], out["mask"] = mags, blocks.cpu()
            masks = dense.masks_from_blocks(blocks.to(dev), c["ff"])
        if k == plan.b_from:
            out["state_b"] = compare.change_norms(t.leaves(), then)
            out["count"][k] = t.count
            then = {n: v.clone() for n, v in t.leaves().items()}
        if plan.b_from is not None and k == plan.b_from + 1:
            out["grad_b"] = gn
        if plan.b_from is not None and k == plan.last:
            out["change_b"] = compare.change_norms(t.leaves(), then)
            out["count"][k] = t.count
    return out
