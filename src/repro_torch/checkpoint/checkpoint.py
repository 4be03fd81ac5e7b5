"""Fault-tolerant checkpointing, ported from ``repro.checkpoint.checkpoint``.

Layout (the reference's): ``step_%08d/`` holds one ``.npz`` shard per
pipeline stage (``stage_%03d.npz``: the stage-keyed leaves' slice for that
stage) plus ``common.npz`` (everything else), and an index with the step,
the layers per stage, the stage count, the file list, the caller's
metadata and a sha256 per file.  Leaf keys are the reference's ``/``-joined
tree paths (``params/stages/wq``, ``opt/m/embed``, ``opt/count``,
``dyn/ff_mask``), so a shard of either package reads key by key against
the other's.  Writes go to ``step_%08d.tmp`` and are renamed when complete;
a torn or corrupted checkpoint fails its checksums and the loader falls
back to the newest complete one.

Two differences from the reference, both because the card's machine has
neither ``msgpack`` nor ``ml_dtypes``:
  * the index is JSON (``index.json``), not msgpack;
  * a bfloat16 leaf is stored as its raw 16 bits (``uint16``), and the
    index records every key's torch dtype (``dtypes``); the loader views
    the bits back, so a bfloat16 round trip is bitwise.

The saver copies one stage's slices to the host at a time, so the host
holds at most one stage shard; the loader fills tensors allocated on the
target device from each shard in turn.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

INDEX = "index.json"


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(``/``-joined path, leaf) in sorted-key order — jax's flattening
    order of a dict tree, so the npz keys come out in the reference's
    order.  Empty dicts have no leaves; ``None`` has none."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _is_staged(key: str, shape, S: int) -> bool:
    """The reference's split rule: a leaf whose leading dim equals the
    stage count goes into the per-stage shards when it is a stage param,
    a dyn leaf or an optimizer leaf."""
    return (len(shape) >= 1 and shape[0] == S
            and ("stages" in key or "dyn" in key or key.startswith("opt")))


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _from_host(arr: np.ndarray, stored: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")     # keeps 0-d arrays 0-d
    if stored == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def save_checkpoint(path: str, step: int, params, opt_state, dyn,
                    layers_per_stage: Sequence[int],
                    extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Atomic save; returns the checkpoint directory."""
    ckdir = os.path.join(path, f"step_{step:08d}")
    tmp = ckdir + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    state = {"params": params, "opt": opt_state, "dyn": dyn}
    flat = dict(_leaves(state))
    S = len(layers_per_stage)
    staged = [k for k, v in flat.items() if _is_staged(k, v.shape, S)]
    common = {k: _to_host(v) for k, v in flat.items() if k not in staged}
    np.savez(os.path.join(tmp, "common.npz"), **common)
    del common
    for s in range(S):
        np.savez(os.path.join(tmp, f"stage_{s:03d}.npz"),
                 **{k: _to_host(flat[k][s]) for k in staged})
    index = {
        "step": step,
        "layers_per_stage": list(map(int, layers_per_stage)),
        "num_stages": S,
        "files": ["common.npz"] + [f"stage_{s:03d}.npz" for s in range(S)],
        "meta": extra_meta or {},
        "dtypes": {k: str(v.dtype).replace("torch.", "")
                   for k, v in flat.items()},
    }
    index["sha256"] = {f: _sha256(os.path.join(tmp, f))
                       for f in index["files"]}
    with open(os.path.join(tmp, INDEX), "w") as fh:
        json.dump(index, fh)
    if os.path.exists(ckdir):
        shutil.rmtree(ckdir)
    os.rename(tmp, ckdir)
    return ckdir


def _verify(ckdir: str) -> Optional[Dict[str, Any]]:
    """The index of a complete checkpoint (every file present with its
    checksum), else None."""
    ipath = os.path.join(ckdir, INDEX)
    if not os.path.exists(ipath):
        return None
    try:
        with open(ipath) as fh:
            index = json.load(fh)
    except (json.JSONDecodeError, OSError):
        return None
    for f, want in index["sha256"].items():
        fp = os.path.join(ckdir, f)
        if not os.path.exists(fp) or _sha256(fp) != want:
            return None
    return index


def _candidates(path: str, step: Optional[int]) -> List[str]:
    cands = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    if step is not None:
        cands = [d for d in cands if d == f"step_{step:08d}"] or cands
    return cands


def latest_index(path: str, step: Optional[int] = None
                 ) -> Optional[Dict[str, Any]]:
    """Index of the newest *complete* checkpoint (or of ``step`` when it
    exists and is complete) without loading any tensor data — the resume
    path reads this first to learn the stage count and split it must build
    templates for.  None when there is no such checkpoint."""
    for d in reversed(_candidates(path, step)):
        index = _verify(os.path.join(path, d))
        if index is not None:
            return index
    return None


def _fill(template, prefix: str, loaded: Dict[str, torch.Tensor]):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _fill(v, f"{prefix}/{k}" if prefix else k, loaded)
                for k, v in template.items()}
    return loaded[prefix]


def load_checkpoint(path: str, templates: Tuple[Any, Any, Any],
                    step: Optional[int] = None, device=None):
    """Load (params, opt_state, dyn, index) into the shapes and dtypes of
    ``templates`` — trees whose leaves carry ``.shape`` and ``.dtype``
    (tensors, or specs: nothing is read from them) — as tensors on
    ``device`` (default: the CPU).  Loads the newest *complete* checkpoint
    when ``step`` is None or names no checkpoint; a named torn one is not
    loaded (the reference's rule)."""
    dev = torch.device("cpu" if device is None else device)
    for d in reversed(_candidates(path, step)):
        ckdir = os.path.join(path, d)
        index = _verify(ckdir)
        if index is None:
            continue
        state_t = {"params": templates[0], "opt": templates[1],
                   "dyn": templates[2]}
        want = dict(_leaves(state_t))
        stored = index["dtypes"]
        missing = sorted(set(want) - set(stored))
        if missing:
            raise KeyError(f"{ckdir} lacks {missing}")
        out = {k: torch.empty(tuple(t.shape), dtype=t.dtype, device=dev)
               for k, t in want.items()}

        def put(key: str, arr: np.ndarray, dst: torch.Tensor) -> None:
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{ckdir}: {key} has shape "
                                 f"{tuple(arr.shape)}, the template "
                                 f"{tuple(dst.shape)}")
            dst.copy_(_from_host(arr, stored[key]))

        with np.load(os.path.join(ckdir, "common.npz")) as z:
            for k in z.files:
                if k in out:
                    put(k, z[k], out[k])
        S = index["num_stages"]
        for s in range(S):
            with np.load(os.path.join(ckdir, f"stage_{s:03d}.npz")) as z:
                for k in z.files:
                    if k in out:
                        if out[k].shape[0] != S:
                            raise ValueError(
                                f"{ckdir}: {k} has {S} stages, the "
                                f"template {out[k].shape[0]}")
                        put(k, z[k], out[k][s])
        state = _fill(state_t, "", out)
        return state["params"], state["opt"], state["dyn"], index
    raise FileNotFoundError(f"no complete checkpoint under {path}")


def _gc(path: str, keep: int) -> None:
    cands = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in cands[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


class CheckpointManager:
    """Checkpoints every ``every`` steps under ``path``; keeps the newest
    ``keep``."""

    def __init__(self, path: str, keep: int = 3, every: int = 100):
        self.path, self.keep, self.every = path, keep, every
        os.makedirs(path, exist_ok=True)

    def maybe_save(self, step: int, params, opt_state, dyn,
                   layers_per_stage, extra_meta=None) -> Optional[str]:
        if step % self.every:
            return None
        out = save_checkpoint(self.path, step, params, opt_state, dyn,
                              layers_per_stage, extra_meta)
        self._gc()
        return out

    def _gc(self) -> None:
        _gc(self.path, self.keep)

    def restore(self, templates, step=None, device=None):
        return load_checkpoint(self.path, templates, step, device)
