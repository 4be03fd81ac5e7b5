"""Safe-point checkpoints, ported from ``repro.checkpoint.safepoint``:
everything a crashed trainer needs to resume bit-identically.

A *safe point* is an ordinary checkpoint (params, optimizer and dynamism
state in stage shards, published by write-then-rename) whose index
metadata also holds the run's control-plane state:

  * ``spec`` — the producing ``RunSpec`` as a dict, as the reference
    stores it, so ``Session.resume(dir)`` (``--resume DIR``) rebuilds the
    run from the safe point alone.  A safe point with the train CLI's
    flags as ``args`` and no ``spec`` predates the RunSpec front door and
    is refused by name (``peek``);
  * the step, the stage count, the split and the stage -> worker map;
  * the world epoch and the worker pool (its sets, spares, provisioned
    ids and log) — read from the file manager's journal when the pool
    lives behind one;
  * ``scaler`` (the autoscaler's hysteresis state, so a resumed run
    decides as the uninterrupted one) and the controller's repack latch
    (``repack_enabled``).

The loader position and the LR schedule are functions of (spec, step),
so restoring the step restores them; the tensors restore bit-exactly from
the shards.  Not in the safe point, as in the reference: the engine's last
shrink step (a resumed run does not grow back), the straggler detector's
EMA and the controller's logical expert layout (it lives only in
``dyn["expert_map"]``).

Across ranks (an engine with a launch mesh) every rank calls ``save`` at
the same step: each writes its share (``checkpoint.save_across``) and the
metadata is rank 0's, which alone reads a file manager's journal.  A
safe point does not record how many processes wrote it: ``procs`` is a
``Session`` keyword, not a RunSpec field, so either kind resumes onto
either.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.checkpoint.checkpoint import (INDEX, latest_index,
                                               load_checkpoint, save_kept)


class SafepointManager:
    """Periodic safe points under ``path``; keeps the newest ``keep``."""

    def __init__(self, path: str, every: int, keep: int = 3):
        assert every > 0
        self.path, self.every, self.keep = path, every, keep
        self.saved: List[str] = []
        # what this process wrote of each safe point (across ranks: its
        # files, bytes and seconds)
        self.writes: List[Dict[str, Any]] = []
        os.makedirs(path, exist_ok=True)

    def due(self, step: int) -> bool:
        return (step + 1) % self.every == 0

    def save(self, step: int, state, *, spec, engine,
             scaler=None, repack_enabled: Optional[bool] = None,
             jm_dir: Optional[str] = None) -> str:
        """Write the safe point of a fully completed ``step`` of the run
        ``spec`` (a ``RunSpec``).  With the pool behind a file manager
        (``jm_dir``), its journal is the authoritative pool state."""
        pool_state = None
        if engine.pool is not None:
            pool_state = engine.pool.state_dict()
        elif jm_dir is not None:
            try:
                with open(os.path.join(jm_dir, "state.json")) as f:
                    pool_state = json.load(f)["pool"]
            except (OSError, ValueError, KeyError):
                pool_state = None       # no journal yet (nothing executed)
        meta: Dict[str, Any] = {
            "kind": "safepoint",
            "spec": spec.to_dict(),
            "step": step,
            "stage_workers": [int(w) for w in engine.stage_workers],
            "epoch": int(engine.epoch),
            "pool": pool_state,
            "scaler": scaler.state_dict() if scaler is not None else None,
            "repack_enabled": repack_enabled,
        }
        out, wrote = save_kept(
            self.path, self.keep, step, state.params, state.opt_state,
            state.dyn, state.lps, meta,
            None if engine.launch is None else engine.mesh)
        if wrote is not None:
            self.writes.append({"step": step, **wrote})
        self.saved.append(out)
        return out


def peek(path: str, step: Optional[int] = None, *,
         verify: bool = True) -> Dict[str, Any]:
    """Index (with the safe-point metadata) of the newest complete safe
    point, or of ``step`` when that one is complete.  A safe point that
    carries the train CLI's flags (``args``) and no ``spec`` predates the
    RunSpec front door and is refused.  ``verify=False`` reads the index
    of ``step`` and no shard (a rank, which verifies only the files it
    restores from)."""
    if verify:
        idx = latest_index(path, step)
    else:
        try:
            with open(os.path.join(path, f"step_{int(step):08d}",
                                   INDEX)) as f:
                idx = json.load(f)
        except (OSError, ValueError):
            idx = None
    if idx is None:
        raise FileNotFoundError(f"no complete safe point under {path}")
    meta = idx.get("meta", {})
    if meta.get("kind") != "safepoint":
        raise ValueError(
            f"checkpoint under {path} is not a safe point (plain "
            f"checkpoints lack the control-plane state resume needs)")
    if "spec" not in meta:
        raise ValueError(
            f"safe point step {idx['step']} under {path} stores the train "
            f"CLI's flags as 'args' and no RunSpec as 'spec': it predates "
            f"the RunSpec front door and cannot be resumed")
    return idx


def restore(path: str, templates, step: Optional[int] = None, device=None):
    """(params, opt_state, dyn, index) of the newest complete safe point
    (or of ``step``), on ``device``."""
    return load_checkpoint(path, templates, step, device)
