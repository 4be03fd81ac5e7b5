"""Static configuration of the dynamism scheme applied during training.

One ``kind`` at a time, mirroring the paper's six example cases (MoE routing
imbalance is intrinsic to moe-family archs and needs no kind).  The fields
here are *static* (hashable, part of the jit signature); the *state* of the
dynamism (masks, frozen flags, schedules) lives in the ``dyn`` pytree that is
an input to train_step — so dynamism steps never recompile.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    kind: str = "none"   # none | moe | pruning | freezing | sparse_attention
                         # | early_exit | mod
    # gradual pruning (Zhu–Gupta schedule, paper Eq. 3)
    prune_initial_sparsity: float = 0.0
    prune_final_sparsity: float = 0.9
    prune_start_iter: int = 3000
    prune_end_iter: int = 7000
    prune_frequency: int = 1000
    # layer freezing (Egeria-style)
    freeze_check_every: int = 50
    freeze_loss_slope_threshold: float = 0.02
    # dynamic sparse flash attention
    sparse_nbuckets: int = 8
    sparse_block: int = 512
    # early exit (CALM-style confidence)
    ee_threshold: float = 0.98
    ee_min_layer_frac: float = 0.25   # no exits before this depth fraction
    # mixture of depths: routing applies around EVERY block (paper §2.6 —
    # tokens may skip both intermediate and final layers; the router+MoE
    # hybrid of Raposo et al. as used by the paper)
    mod_capacity: float = 0.5         # fraction of tokens processed
    mod_every: int = 1                # MoD routing on every k-th block
    # live expert re-layout (LAER-style): when the controller measures
    # hot/cold skew above the watermark it re-places logical experts over
    # physical kernel groups at the next safe point.  Only meaningful for
    # moe-family archs with kernel_impl="pallas".
    expert_relayout: bool = False
    expert_watermark: float = 2.0     # max(load)/mean(load) trigger
    expert_min_tokens: int = 16       # ignore skew below this routed total

    @property
    def uses_sparse_attention(self) -> bool:
        return self.kind == "sparse_attention"

    @property
    def uses_mod(self) -> bool:
        return self.kind == "mod"

    @property
    def uses_early_exit(self) -> bool:
        return self.kind == "early_exit"

    @property
    def uses_freezing(self) -> bool:
        return self.kind == "freezing"


NONE = DynamicsConfig()
