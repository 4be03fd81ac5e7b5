"""Llama-3 405B — dense GQA decoder, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ModelConfig, register

LLAMA3_405B = register(ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    head_dim=128,
    rope_theta=5e5,
    source="arXiv:2407.21783; unverified",
))
