"""The numbers that decide ``correct`` for a training cell, and their
arithmetic.  ``judge`` holds a run's readings to the reference's: the
program's in every run of the benchmark, a stand-in's (the control, a
planted fault) in ``controls.py``.

A norm is compared leaf by leaf as the gap between the program's norm and
the reference's, over the larger of the reference's norm of that leaf and
of the median leaf; the worst leaf is the number.  Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change (none is, in the dense
decoder); the rule reads the reference's gradient, never a name."""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

import torch

SMALL_GRAD = 1e-3


def worst_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(the worst leaf's gap, its name)."""
    names = sorted(ref) if keep is None else sorted(keep)
    missing = [n for n in names if n not in prog]
    if missing:
        raise KeyError(f"the program has no leaf {missing[:3]}")
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap >= worst:
            worst, at = gap, n
    return worst, at


def moving_leaves(grad_norms: Dict[str, float]):
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= SMALL_GRAD * med]


def change_norms(now: Dict[str, torch.Tensor],
                 then: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{leaf: ||now - then||}, leaf by leaf on ``now``'s device."""
    out = {}
    for k, t in now.items():
        out[k] = float(torch.linalg.vector_norm(
            t.float() - then[k].to(t.device).float()))
    return out


def top_blocks(magnitudes: torch.Tensor, keep: int) -> torch.Tensor:
    """The ``keep`` blocks of the largest magnitude ([L, npb] bool)."""
    flat = magnitudes.reshape(-1)
    return magnitudes >= torch.topk(flat, keep).values[-1]


def check_mask(prog_blocks: torch.Tensor, magnitudes: torch.Tensor,
               keep: int, tie: float = 1e-6):
    """Whether the program's kept FFN blocks are a top-``keep`` of the
    reference's magnitudes ([L, npb], float64).  Returns (blocks in the
    wrong set, the mask the reference follows).  A block whose magnitude
    lies within ``tie`` (relative) of the threshold is a tie the two
    sums may order either way: there the program's choice stands; a kept
    block anywhere else must be above the threshold and a dropped one
    below, and the counts must agree."""
    mag = magnitudes.double().cpu()
    prog = prog_blocks.cpu() > 0
    thresh = float(torch.topk(mag.reshape(-1), keep).values[-1])
    near = (mag - thresh).abs() <= tie * abs(thresh)
    ref = mag >= thresh
    wrong = int(((prog != ref) & ~near).sum())
    wrong += abs(int(prog.sum()) - keep)
    follow = torch.where(near, prog, ref)
    return wrong, follow


def limit_names(plan) -> Tuple[str, ...]:
    """The limits ``judge`` reads for a cell of this plan."""
    return ("a_loss", "a_grad", "a_change") + (
        ("b_loss", "b_state", "b_change") if plan.b_from is not None else ())


def judge(prog: Dict, ref: Dict, limits: Dict[str, float], plan,
          where: Optional[Dict[str, str]] = None
          ) -> Dict[str, Tuple[float, float]]:
    """{number: (value, limit)}: ``prog``'s readings against the
    reference's (both as ``follow.readings`` gives them; ``prog`` may
    also hold ``tokens_wrong``, the batches that were not the frozen
    generator's, and ``migrations``, the entries a migration did not carry
    over bit for bit).  Counts are held to 0.  ``where``, if given,
    receives the worst leaf of each norm's number."""
    out: Dict[str, Tuple[float, float]] = {}
    where = {} if where is None else where
    if "tokens_wrong" in prog:
        out["batches_differ"] = (prog["tokens_wrong"], 0)

    def loss_gap(steps):
        return max(abs(prog["loss"][k] - ref["loss"][k]) for k in steps)

    def norms(name, key, keep=None):
        gap, where[name] = worst_gap(prog[key], ref[key], keep)
        out[name] = (gap, limits[name])

    moving = moving_leaves(ref["grad0"])
    out["a_loss"] = (loss_gap(range(plan.a_n)), limits["a_loss"])
    norms("a_grad", "grad0")
    norms("a_change", "change_a", moving)
    if plan.mask_step is not None:
        out["mask_blocks_wrong"] = (check_mask(prog["mask"], ref["mags"],
                                               plan.keep)[0], 0)
    if plan.b_from is not None:
        out["b_loss"] = (loss_gap(range(plan.a_n, plan.last + 1)),
                         limits["b_loss"])
        norms("b_state", "state_b", moving)
        norms("b_change", "change_b", moving_leaves(ref["grad_b"]))
        out["count_wrong"] = (sum(abs(prog["count"][k] - n)
                                  for k, n in ref["count"].items()), 0)
    if "migrations" in prog:
        out["migration_bits_wrong"] = (sum(n for n, *_ in
                                           prog["migrations"]), 0)
    return out
