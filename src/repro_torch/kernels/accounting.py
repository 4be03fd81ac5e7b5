"""The kernels' side of the dry run's counting mode (``launch.counting``).

A wrapper's off-card body goes through ``plain``: on a CPU tensor it runs
the kernel's plain version, on a ``meta`` tensor it computes nothing and
returns empty outputs of the kernel's shapes.  Under a counting mode the
kernel's work is what its own formula says (``work()``, built on the
accounting helpers: ``attention_tile_work``, ``matmul_tile_work``, the
grouped capacity), not what the ops of its plain version would add up to,
so a count on ``meta`` equals the count of the same call on the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

# a kernel's work: {kernel id: (flops, bytes)}
Work = Dict[str, Tuple[float, float]]


def active():
    """The innermost active counting mode (a dispatch mode that takes
    kernels' work, ``counts_kernels``), or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "counts_kernels", False):
            return mode
    return None


def plain(work: Callable[[], Work], run: Callable, meta: Callable, probe):
    """A wrapper's body off the card: ``run()`` (the plain version) on a
    CPU tensor, ``meta()`` (empty outputs) when ``probe`` is on the
    ``meta`` device; under a counting mode, ``work()`` is recorded and the
    ops inside are not counted."""
    body = meta if probe.is_meta else run
    mode = active()
    if mode is None:
        return body()
    with mode.kernel(work()):
        # the kernels write dense outputs: so do both bodies here, so the
        # ops after them see the same strides on meta and on the CPU
        out = _contiguous(body())
    mode.track(out)
    return out


def _contiguous(out):
    if isinstance(out, tuple):
        return tuple(_contiguous(t) for t in out)
    return out.contiguous() if out is not None else None


def nbytes(*ts) -> float:
    """Bytes of tensors (None skipped): what a kernel reads or writes once
    each."""
    return float(sum(t.numel() * t.element_size() for t in ts
                     if t is not None))
