"""Roofline terms of a dry-run cell — the port of
``repro.launch.roofline`` with an H100's constants.

Terms per (arch x shape x mesh), per card:

    compute    = FLOPs / peak FLOP/s
    memory     = HBM bytes / HBM bandwidth
    collective = collective bytes / link bandwidth

The constants are parameters of ``RooflineTerms``.  Their defaults are the
published peaks of an H100 SXM at 700 W (the data sheet, not a measurement
of any card): 989e12 dense bf16 FLOP/s (``PEAK_FLOPS``; 67e12 for an fp32
cell, ``PEAK_FLOPS_FP32``), 3.35e12 B/s of HBM3, and NVLink 4 at 450e9 B/s
each way between the 8 cards of a host.  A mesh of more than one host
also crosses the network between hosts; its rate is an assumption, named
here: one 400 Gb/s port per card, 50e9 B/s each way (``INTER_HOST_BW``).
``link_bandwidth(mesh)`` gives the collective term its rate: NVLink when
the whole mesh fits one host, else the inter-host rate, since every
collective of a 16 x 16 mesh laid out data-major (8 cards a host) has a hop
between hosts (the model ring crosses one every 8 stages; a data axis
crosses on every hop).

The reference reads XLA's artifacts: ``cost_dict(compiled)`` (the
compiler's FLOP and byte counts) and ``collective_bytes(hlo_text)`` (the
census of the collectives in the HLO text).  The port compiles no HLO and
has neither.  Their counterparts are the dry run's counting mode
(``launch.counting``: FLOPs and bytes of the hottest stage's ops, counted
as they run on ``meta`` tensors) and the analytic collective term
(``launch.dryrun.analytic_roofline``).  ``extrapolate`` stays: it turns
two counts at two schedule lengths into the count at a third.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12          # H100 SXM, dense bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12      # H100 SXM, fp32 on the CUDA cores
HBM_BW = 3.35e12             # H100 SXM, HBM3
NVLINK_BW = 450e9            # NVLink 4, each way, within a host of 8
INTER_HOST_BW = 50e9         # assumption: one 400 Gb/s port per card
CARDS_PER_HOST = 8


def peak_flops(param_dtype: str) -> float:
    """The peak for a cell's parameter dtype."""
    return PEAK_FLOPS_FP32 if param_dtype == "float32" else PEAK_FLOPS


def link_bandwidth(chips: int) -> float:
    """The collective term's rate for a mesh of ``chips`` cards."""
    return NVLINK_BW if chips <= CARDS_PER_HOST else INTER_HOST_BW


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # whole step, per card
    hbm_bytes: float             # whole step, per card
    coll_bytes: float            # whole step, per card
    chips: int
    model_flops: float = 0.0     # 6·N·D convention, global
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = INTER_HOST_BW

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs x chips): how much of the counted compute
        is useful (catches remat and padding waste)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """The MFU the terms allow: useful FLOPs per card-second at the
        bound time, over the peak."""
        if self.t_bound <= 0:
            return 0.0
        return (self.model_flops / self.chips / self.t_bound) \
            / self.peak_flops

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "chips": self.chips,
        }


def extrapolate(probe1: Dict[str, float], probe2: Dict[str, float],
                t1: int, t2: int, t_real: int) -> Dict[str, float]:
    """Two-point linear extrapolation in tick count (exact when the cost
    is affine in ticks)."""
    out = {}
    for k in set(probe1) | set(probe2):
        a, b = probe1.get(k, 0.0), probe2.get(k, 0.0)
        per_tick = (b - a) / max(1, (t2 - t1))
        out[k] = a + per_tick * (t_real - t1)
    return out
