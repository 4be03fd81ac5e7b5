"""SmolLM 360M — llama-arch small with GQA kv=5.
[hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import ModelConfig, register

SMOLLM_360M = register(ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    head_dim=64,
    rope_theta=1e4,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
))
