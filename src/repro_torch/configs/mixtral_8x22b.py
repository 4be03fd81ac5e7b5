"""Mixtral 8x22B — 8-expert top-2 MoE with sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, register

MIXTRAL_8X22B = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1e6,
    source="arXiv:2401.04088; hf",
))
