"""The dry run's counting mode: FLOPs, bytes and the live-bytes peak of
the ops a piece of the port runs, on ``meta`` tensors (nothing computed)
or on the CPU.

``CountingMode`` is a ``TorchDispatchMode``.  For each op outside a
kernel it adds

  * the FLOPs of ``torch.utils.flop_counter``'s formulas (matmuls,
    convolutions, attention; elementwise ops count none);
  * the bytes of its tensor inputs and outputs, each once (a view moves
    none);
  * to the live bytes, the storages it creates, until they are freed
    (``peak_bytes`` is the largest sum; storages made before the mode do
    not count).

A kernel wrapper (``kernels.accounting.plain``) hands in its own work by
formula instead, per kernel id (``kernels``), and its outputs to the live
bytes; the ops of its plain version are not counted.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import accounting


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class CountingMode(TorchDispatchMode):
    counts_kernels = True        # ``accounting.active`` finds it

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak_bytes = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._inside = 0
        self._refs: Dict[int, Any] = {}

    # -- the kernels' side ---------------------------------------------------
    @contextlib.contextmanager
    def kernel(self, work: accounting.Work):
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1
        for name, (flops, nbytes) in work.items():
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                               "bytes": 0.0})
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            self.flops += flops
            self.bytes += nbytes

    def track(self, out) -> None:
        """Add the storages of ``out`` not yet live to the live bytes."""
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            ref = self._refs.get(key)
            if ref is not None and ref[0]() is st:
                continue
            n = st.nbytes()
            self._refs[key] = (weakref.ref(st, self._freer(key, n)), n)
            self.live += n
            self.peak_bytes = max(self.peak_bytes, self.live)

    def _freer(self, key: int, n: int):
        def free(_ref):
            if self._refs.get(key, (None,))[0] is _ref:
                del self._refs[key]
                self.live -= n
        return free

    # -- every op --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        from torch.utils.flop_counter import flop_registry
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += f(*args, **kwargs, out_val=out)
        ins = list(_tensors((args, kwargs)))
        if not _is_view(func):
            self.bytes += accounting.nbytes(*ins, *_tensors(out))
        # an output on an input's storage (a view, an in-place op)
        # allocates nothing
        seen = {id(t.untyped_storage()) for t in ins}
        self.track([t for t in _tensors(out)
                    if id(t.untyped_storage()) not in seen])
        return out

    def totals(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_bytes": self.peak_bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}
