"""Zamba2 1.2B — Mamba2 backbone with shared attention blocks.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig, register

ZAMBA2_1P2B = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    d_conv=4,
    shared_attn_period=6,     # every 6th block invokes the shared attn block
    source="arXiv:2411.15242; hf",
))
