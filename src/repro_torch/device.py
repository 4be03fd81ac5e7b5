"""Device resolution for every entry point of the port.

The port runs on the CUDA card.  The CPU is taken only when the caller asks
for it (``device="cpu"``), as the tests do: there each kernel wrapper runs
its plain PyTorch version.  Without a card and without an explicit
``"cpu"`` the port raises instead of carrying on quietly on the host.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` or ``"cuda[:i]"`` -> that CUDA device (raises without a
    card); ``"cpu"`` -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         f"'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card and none is available; pass "
            "device='cpu' (--device cpu) to run the plain PyTorch versions "
            "of the kernels on the CPU")
    return dev

