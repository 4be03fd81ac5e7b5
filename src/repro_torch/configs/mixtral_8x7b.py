"""Mixtral 8x7B — 8-expert top-2 MoE with sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, register

MIXTRAL_8X7B = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1e6,
    source="arXiv:2401.04088; hf",
))
