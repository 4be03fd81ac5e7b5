"""Command R+ 104B — dense GQA, no-bias, 256k vocab.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig, register

COMMAND_R_PLUS = register(ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    head_dim=128,
    attn_bias=False,
    rope_theta=75e4,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
))
