"""Config dataclasses + registry for every assigned architecture.

A single ``ModelConfig`` describes any arch in the pool; family-specific
fields are optional.  ``ShapeConfig`` describes one input-shape cell,
``DistConfig`` the parallelism layout.  Configs are pure data — no torch
imports here, so importing a config never touches device state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Block types inside the padded-slot pipeline.  Each slot carries a type tag;
# the stage executor lax.switch-es on it.  Integer values are stable (they
# appear in checkpoints and migration plans).
# ---------------------------------------------------------------------------
BLOCK_PAD = 0          # inactive slot
BLOCK_DENSE = 1        # attention + dense MLP
BLOCK_MOE = 2          # attention + MoE FFN
BLOCK_MAMBA = 3        # Mamba2 SSM block
BLOCK_HYBRID_ATTN = 4  # Mamba block + shared-attention invocation (Zamba2)
BLOCK_MLSTM = 5        # xLSTM mLSTM block
BLOCK_SLSTM = 6        # xLSTM sLSTM block
BLOCK_ENC = 7          # encoder self-attn block (Whisper)
BLOCK_DEC = 8          # decoder self+cross-attn block (Whisper)

BLOCK_TYPE_NAMES = {
    BLOCK_PAD: "pad", BLOCK_DENSE: "dense", BLOCK_MOE: "moe",
    BLOCK_MAMBA: "mamba", BLOCK_HYBRID_ATTN: "hybrid_attn",
    BLOCK_MLSTM: "mlstm", BLOCK_SLSTM: "slstm",
    BLOCK_ENC: "enc", BLOCK_DEC: "dec",
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25   # GShard-style; tokens over capacity
                                        # are dropped (residual passthrough)
    # attention flavor
    sliding_window: int = 0          # 0 = full attention
    attn_bias: bool = False
    # SSM / hybrid
    ssm_state: int = 0
    d_conv: int = 4
    shared_attn_period: int = 0      # Zamba2: every k-th block invokes shared attn
    # xLSTM: fraction/positions of sLSTM blocks
    slstm_positions: Tuple[int, ...] = ()
    # enc-dec (Whisper)
    num_encoder_layers: int = 0
    encoder_seq: int = 0             # frames after conv frontend (stub input)
    # VLM
    num_patches: int = 0             # vision prefix tokens (stub input)
    # misc
    max_seq_len: int = 1 << 20
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.num_encoder_layers > 0

    @property
    def is_subquadratic(self) -> bool:
        """Whether long-context (500k) shapes are runnable per the task spec:
        SSM/hybrid/linear-attn run; sliding-window attention counts too."""
        return self.family in ("hybrid", "ssm") or self.sliding_window > 0

    # -- parameter counting ------------------------------------------------
    def params_per_block(self, block_type: int) -> int:
        d, h = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        attn = d * (nq * h) + 2 * d * (nkv * h) + (nq * h) * d
        dense_ffn = 3 * d * self.d_ff                  # SwiGLU: wi, wg, wo
        norms = 2 * d
        if block_type == BLOCK_DENSE:
            return attn + dense_ffn + norms
        if block_type == BLOCK_MOE:
            router = d * self.num_experts
            return attn + self.num_experts * dense_ffn + router + norms
        if block_type in (BLOCK_MAMBA, BLOCK_HYBRID_ATTN):
            d_in = 2 * d                               # expand factor 2
            nheads = max(1, d_in // 64)
            mamba = (d * (2 * d_in + 2 * self.ssm_state * (d_in // 64 if False else 1))
                     )  # refined below
            # canonical Mamba2 param count: in_proj d->(2*d_in + 2*n_groups*state + nheads)
            n_groups = 1
            in_proj = d * (2 * d_in + 2 * n_groups * self.ssm_state + nheads)
            conv = self.d_conv * (d_in + 2 * n_groups * self.ssm_state)
            out_proj = d_in * d
            extra = 3 * nheads                          # A, D, dt_bias
            base = in_proj + conv + out_proj + extra + norms
            if block_type == BLOCK_HYBRID_ATTN:
                return base                             # shared attn counted once globally
            return base
        if block_type == BLOCK_MLSTM:
            d_in = 2 * d
            proj = d * 2 * d_in + d_in * d              # up (gated) + down
            qkv = 3 * d_in * (d_in // max(1, nq))       # block-diagonal per head
            gates = 2 * d_in + d_in
            return proj + qkv + gates + norms
        if block_type == BLOCK_SLSTM:
            # 4 gates, recurrent + input weights at model dim + ffn
            return 8 * d * d + 2 * d * int(d * 4 / 3) + norms
        if block_type == BLOCK_ENC:
            return attn + 2 * d * self.d_ff + d * self.d_ff + norms
        if block_type == BLOCK_DEC:
            cross = attn
            return 2 * attn + 2 * d * self.d_ff + d * self.d_ff + 3 * d
        return 0

    def block_pattern(self) -> List[int]:
        """Global layer sequence of block type tags (length = total blocks)."""
        if self.is_encdec:
            return ([BLOCK_ENC] * self.num_encoder_layers
                    + [BLOCK_DEC] * self.num_layers)
        if self.family == "moe":
            return [BLOCK_MOE] * self.num_layers
        if self.family == "hybrid":
            out = []
            for i in range(self.num_layers):
                if self.shared_attn_period and (i % self.shared_attn_period
                                                == self.shared_attn_period // 2):
                    out.append(BLOCK_HYBRID_ATTN)
                else:
                    out.append(BLOCK_MAMBA)
            return out
        if self.family == "ssm":
            return [BLOCK_SLSTM if i in self.slstm_positions else BLOCK_MLSTM
                    for i in range(self.num_layers)]
        return [BLOCK_DENSE] * self.num_layers

    def total_blocks(self) -> int:
        return len(self.block_pattern())

    def param_count(self) -> int:
        body = sum(self.params_per_block(t) for t in self.block_pattern())
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        shared = 0
        if self.family == "hybrid" and self.shared_attn_period:
            d, h = self.d_model, self.resolved_head_dim
            shared = (d * self.num_heads * h + 2 * d * self.num_kv_heads * h
                      + self.num_heads * h * d + 2 * d)
        final_norm = self.d_model
        return body + emb + head + shared + final_norm

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only experts_per_token experts)."""
        if self.family != "moe":
            return self.param_count()
        total = self.param_count()
        dense_ffn = 3 * self.d_model * self.d_ff
        inactive = (self.num_experts - self.experts_per_token) * dense_ffn
        return total - inactive * self.num_layers


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# bytes per element for every param dtype the trainer supports; repack memory
# budgets and profiler byte vectors must use the *configured* dtype, not a
# hard-coded bf16 assumption (the CLI trainer runs float32)
DTYPE_BYTES: Dict[str, int] = {
    "float32": 4, "bfloat16": 2, "float16": 2, "float64": 8,
}


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Parallelism layout knobs."""
    num_stages: int = 16           # model-axis size (pipeline)
    num_micro: int = 32            # microbatches per step
    slot_slack: int = 1            # extra layer slots per stage beyond ceil(L/S)
    fsdp: bool = True              # shard weights over data axis (ZeRO-3)
    expert_parallel: bool = True   # MoE experts over data axis
    remat: str = "block"           # none | block | full
    slot_exec: str = "masked_scan" # masked_scan | bounded_loop
    unroll_ticks: bool = False     # unroll schedule loop (exact cost analysis)
    unroll_slots: bool = False
    param_dtype: str = "bfloat16"
    kernel_impl: str = "scan"      # reference | scan | pallas — attention +
                                   # SwiGLU inner impl: "reference" is the
                                   # O(s^2) oracle, "scan" the pure-JAX flash
                                   # scan, "pallas" the block-skipping TPU
                                   # kernels (interpret mode off-TPU); see
                                   # DESIGN.md §kernel dispatch
    optimizer: str = "adamw"       # adamw | adafactor
    grad_compression: str = "none" # none | topk | int8
    collective_matmul: bool = False
    seq_shard: bool = False        # shard long sequences over data axis
    pin_carry_sharding: bool = True  # with_sharding_constraint on the
                                     # pipeline carry at tick boundaries —
                                     # stops XLA auto-sharding's involuntary
                                     # full-rematerialization fallback

    @property
    def num_slots(self) -> int:
        raise NotImplementedError("use slots_for(model_cfg)")

    @property
    def bytes_per_param(self) -> int:
        return DTYPE_BYTES.get(self.param_dtype, 2)

    def slots_for(self, mc: ModelConfig) -> int:
        return math.ceil(mc.total_blocks() / self.num_stages) + self.slot_slack


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


# the port registers the architectures its slices serve; the rest of the
# reference's registry joins as their block families are ported
_ARCH_MODULES = ["smollm_360m", "mixtral_8x7b"]


def _load_all() -> None:
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def reduced_config(mc: ModelConfig, num_layers: int = 4, d_model: int = 64,
                   num_heads: int = 4, num_kv_heads: int = 2, d_ff: int = 128,
                   vocab_size: int = 256) -> ModelConfig:
    """Shrink an arch config to smoke-test size, preserving its family shape."""
    kv = min(num_kv_heads, num_heads)
    repl = dict(
        name=mc.name + "-reduced", num_layers=num_layers, d_model=d_model,
        num_heads=num_heads, num_kv_heads=kv, d_ff=d_ff,
        vocab_size=vocab_size, head_dim=d_model // num_heads,
        max_seq_len=4096,
    )
    if mc.num_experts:
        repl["num_experts"] = min(4, mc.num_experts)
        repl["experts_per_token"] = min(2, mc.experts_per_token)
        # drop-free capacity so incremental decode == full re-forward in
        # smoke tests (capacity dropping makes them legitimately differ)
        repl["moe_capacity_factor"] = 4.0
    if mc.sliding_window:
        repl["sliding_window"] = 32
    if mc.ssm_state:
        repl["ssm_state"] = 16
    if mc.shared_attn_period:
        repl["shared_attn_period"] = 2
    if mc.slstm_positions:
        repl["slstm_positions"] = tuple(
            p for p in (1,) if p < num_layers)
    if mc.num_encoder_layers:
        repl["num_encoder_layers"] = max(2, num_layers // 2)
        repl["encoder_seq"] = 16
    if mc.num_patches:
        repl["num_patches"] = 8
    return dataclasses.replace(mc, **repl)
