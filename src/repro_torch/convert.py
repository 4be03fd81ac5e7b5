"""Trees of numpy arrays (as the JAX package hands them over: params, dyn,
assignment, dense or paged caches, the hash projection) to the port's
tensors, and back.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects; they go through float32, which holds every
bf16 value exactly, so the round trip is bit-exact.  Nothing here imports
the JAX package or jax: the caller turns its arrays into numpy first.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def to_torch(tree: Any, device: DeviceLike) -> Any:
    """Nested dicts of numpy arrays -> the same tree of tensors
    on ``device``; bf16 stays bf16, everything else keeps its dtype."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if _is_bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def to_numpy(tree: Any, like: Any = None) -> Any:
    """Tensors -> numpy arrays (bf16 leaves come back as float32 holding the
    same values).  With ``like`` (a tree of arrays of the target dtypes,
    e.g. the original reference tree) every leaf is cast to its twin's
    dtype, which restores ``ml_dtypes.bfloat16`` without importing it."""
    if isinstance(tree, dict):
        return {k: to_numpy(v, None if like is None else like[k])
                for k, v in tree.items()}
    t = tree.detach().cpu()
    a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if like is not None:
        a = a.astype(np.asarray(like).dtype)
    return a
