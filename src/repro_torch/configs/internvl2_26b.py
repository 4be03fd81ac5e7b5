"""InternVL2 26B — InternLM2 LM backbone; InternViT frontend is a STUB
(input_specs provides precomputed patch embeddings). [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig, register

INTERNVL2_26B = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    num_patches=256,          # stubbed ViT output tokens per image
    rope_theta=1e6,
    source="arXiv:2404.16821; hf",
))
