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

Across ranks (``mesh``: the world's ``launch.mesh.Mesh``, every rank of
the launch calling in the same order) the layout and the bytes are the
same: the rank at (data 0, stage s) of the world writes ``stage_{s:03d}``
from its own ``[1, L_max, ...]`` row, the world's leader writes
``common.npz`` (the replicated leaves and their moments), gathers every
shard's sha256 and rank 0's metadata, writes the index and makes the
rename; data replicas above 0 and ranks outside the world write nothing.
So a safe point written by ranks and one written by one process at the
same step hold the same keys, dtypes, shapes, index and array bytes —
only the checksums differ, with the zip entries' timestamps.  A rank
restores from ``common.npz`` and its own stage's shard alone
(``load_rows``), verifying those two files.
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


def _row_key(key: str) -> bool:
    """Whether a leaf of a rank's state is a ``[1, L_max, ...]`` stage row
    (params' and the moments' ``stages`` subtrees, every dyn leaf) rather
    than a leaf replicated over the model ring."""
    return key.startswith("dyn/") or "/stages/" in key


def _index(step: int, layers_per_stage, flat, meta, sha) -> Dict[str, Any]:
    S = len(layers_per_stage)
    files = ["common.npz"] + [f"stage_{s:03d}.npz" for s in range(S)]
    return {
        "step": step,
        "layers_per_stage": list(map(int, layers_per_stage)),
        "num_stages": S,
        "files": files,
        "meta": meta or {},
        "dtypes": {k: str(v.dtype).replace("torch.", "")
                   for k, v in flat.items()},
        "sha256": {f: sha[f] for f in files},
    }


def _publish(tmp: str, ckdir: str, index) -> None:
    with open(os.path.join(tmp, INDEX), "w") as fh:
        json.dump(index, fh)
    if os.path.exists(ckdir):
        shutil.rmtree(ckdir)
    os.rename(tmp, ckdir)


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
    sha = {f: _sha256(os.path.join(tmp, f)) for f in os.listdir(tmp)}
    _publish(tmp, ckdir, _index(step, layers_per_stage, flat, extra_meta,
                                sha))
    return ckdir


def save_across(path: str, step: int, params, opt_state, dyn,
                layers_per_stage: Sequence[int],
                extra_meta: Optional[Dict[str, Any]], mesh
                ) -> Tuple[str, Dict[str, Any]]:
    """``save_checkpoint`` as one rank of the launch (``mesh``: the world's
    mesh; every rank of the launch calls, a rank outside the world with
    None trees).  Returns (the directory, what this rank wrote: its files,
    bytes and seconds).  ``extra_meta`` is rank 0's, whatever it holds
    elsewhere (rank 0 reads a file manager's journal)."""
    import time
    comm, me = mesh.comm, mesh.rank
    ckdir = os.path.join(path, f"step_{step:08d}")
    tmp = ckdir + ".tmp"
    leader = mesh.leader
    if me == leader:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    comm.broadcast_object(None, leader)           # the directory is there
    t0 = time.perf_counter()
    mine: Dict[str, str] = {}
    leader_flat = None
    if mesh.member and mesh.replica == 0:
        flat = dict(_leaves({"params": params, "opt": opt_state,
                             "dyn": dyn}))
        S = len(layers_per_stage)
        for k, v in flat.items():
            whole = ((S,) + tuple(v.shape[1:]) if _row_key(k)
                     else tuple(v.shape))
            if _is_staged(k, whole, S) != _row_key(k):
                raise ValueError(
                    f"{k} {tuple(v.shape)}: the one-process layout would "
                    f"shard it otherwise than the ranks hold it")
        staged = [k for k in flat if _row_key(k)]
        names = [f"stage_{mesh.stage:03d}.npz"]
        np.savez(os.path.join(tmp, names[0]),
                 **{k: _to_host(flat[k][0]) for k in staged})
        if me == leader:
            names.append("common.npz")
            np.savez(os.path.join(tmp, "common.npz"),
                     **{k: _to_host(v) for k, v in flat.items()
                        if k not in staged})
            leader_flat = flat
        mine = {f: _sha256(os.path.join(tmp, f)) for f in names}
    wrote = {"files": sorted(mine),
             "bytes": sum(os.path.getsize(os.path.join(tmp, f))
                          for f in mine),
             "seconds": time.perf_counter() - t0}
    seen = comm.all_gather_object(
        {"sha": mine, "meta": extra_meta if me == 0 else None})
    if me == leader:
        sha = {f: h for got in seen for f, h in got["sha"].items()}
        _publish(tmp, ckdir, _index(step, layers_per_stage, leader_flat,
                                    seen[0]["meta"], sha))
    # no rank goes on before the safe point is complete on disk
    comm.broadcast_object(None, leader)
    return ckdir, wrote


def _verify(ckdir: str, files: Optional[Sequence[str]] = None
            ) -> Optional[Dict[str, Any]]:
    """The index of a complete checkpoint (every file present with its
    checksum; only ``files`` when given), else None."""
    ipath = os.path.join(ckdir, INDEX)
    if not os.path.exists(ipath):
        return None
    try:
        with open(ipath) as fh:
            index = json.load(fh)
    except (json.JSONDecodeError, OSError):
        return None
    for f, want in index["sha256"].items():
        if files is not None and f not in files:
            continue
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


def _put(ckdir: str, stored, key: str, arr: np.ndarray,
         dst: torch.Tensor) -> None:
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{ckdir}: {key} has shape {tuple(arr.shape)}, "
                         f"the template {tuple(dst.shape)}")
    dst.copy_(_from_host(arr, stored[key]))


def _allocate(ckdir: str, index, templates, dev):
    state_t = {"params": templates[0], "opt": templates[1],
               "dyn": templates[2]}
    want = dict(_leaves(state_t))
    missing = sorted(set(want) - set(index["dtypes"]))
    if missing:
        raise KeyError(f"{ckdir} lacks {missing}")
    return state_t, {k: torch.empty(tuple(t.shape), dtype=t.dtype,
                                    device=dev) for k, t in want.items()}


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
        state_t, out = _allocate(ckdir, index, templates, dev)
        stored = index["dtypes"]
        with np.load(os.path.join(ckdir, "common.npz")) as z:
            for k in z.files:
                if k in out:
                    _put(ckdir, stored, k, z[k], out[k])
        S = index["num_stages"]
        for s in range(S):
            with np.load(os.path.join(ckdir, f"stage_{s:03d}.npz")) as z:
                for k in z.files:
                    if k in out:
                        if out[k].shape[0] != S:
                            raise ValueError(
                                f"{ckdir}: {k} has {S} stages, the "
                                f"template {out[k].shape[0]}")
                        _put(ckdir, stored, k, z[k], out[k][s])
        state = _fill(state_t, "", out)
        return state["params"], state["opt"], state["dyn"], index
    raise FileNotFoundError(f"no complete checkpoint under {path}")


def load_rows(path: str, templates: Tuple[Any, Any, Any], step: int,
              stage: int, device=None):
    """One rank's restore: (params, opt_state, dyn, the files read) of the
    checkpoint of ``step``, with ``templates``' stage rows (``[1, L_max,
    ...]``) from ``stage_{stage:03d}.npz`` and the replicated leaves from
    ``common.npz``.  Only those two files are read, and verified against
    the index first."""
    dev = torch.device("cpu" if device is None else device)
    ckdir = os.path.join(path, f"step_{step:08d}")
    files = ["common.npz", f"stage_{stage:03d}.npz"]
    index = _verify(ckdir, files)
    if index is None:
        raise FileNotFoundError(f"{ckdir}: {files} missing or failing "
                                f"their checksums")
    state_t, out = _allocate(ckdir, index, templates, dev)
    for f in files:
        with np.load(os.path.join(ckdir, f)) as z:
            for k in z.files:
                if k not in out:
                    continue
                if f != "common.npz" and out[k].shape[0] != 1:
                    raise ValueError(f"{ckdir}: {k} is a stage row, the "
                                     f"template {tuple(out[k].shape)}")
                _put(ckdir, index["dtypes"], k, z[k],
                     out[k][0] if f != "common.npz" else out[k])
    state = _fill(state_t, "", out)
    return state["params"], state["opt"], state["dyn"], files


def _gc(path: str, keep: int) -> None:
    cands = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in cands[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def save_kept(path: str, keep: int, step: int, params, opt_state, dyn,
              layers_per_stage, extra_meta=None, mesh=None
              ) -> Tuple[str, Optional[Dict[str, Any]]]:
    """Save, then keep the newest ``keep`` under ``path``; returns (the
    directory, what this rank wrote or None).  With ``mesh`` (the world's
    mesh of ranks) every rank of the launch calls it (``save_across``),
    the world's leader collects the old ones, and no rank returns before
    it has."""
    if mesh is None:
        out = save_checkpoint(path, step, params, opt_state, dyn,
                              layers_per_stage, extra_meta)
        _gc(path, keep)
        return out, None
    out, wrote = save_across(path, step, params, opt_state, dyn,
                             layers_per_stage, extra_meta, mesh)
    if mesh.rank == mesh.leader:
        _gc(path, keep)
    mesh.comm.broadcast_object(None, mesh.leader)
    return out, wrote


class CheckpointManager:
    """Checkpoints every ``every`` steps under ``path``; keeps the newest
    ``keep``."""

    def __init__(self, path: str, keep: int = 3, every: int = 100):
        self.path, self.keep, self.every = path, keep, every
        os.makedirs(path, exist_ok=True)

    def maybe_save(self, step: int, params, opt_state, dyn,
                   layers_per_stage, extra_meta=None,
                   mesh=None) -> Optional[str]:
        """Across ranks (``mesh``: the world's) every rank of the launch
        calls it; the world's leader collects the old checkpoints."""
        if step % self.every:
            return None
        return save_kept(self.path, self.keep, step, params, opt_state, dyn,
                         layers_per_stage, extra_meta, mesh)[0]

    def restore(self, templates, step=None, device=None):
        return load_checkpoint(self.path, templates, step, device)
