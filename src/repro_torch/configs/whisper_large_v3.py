"""Whisper large-v3 — encoder-decoder; conv frontend STUBBED (input_specs
provides precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig, register

WHISPER_LARGE_V3 = register(ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,            # decoder layers
    num_encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    encoder_seq=1500,         # 30 s audio -> 1500 frames after conv stub
    max_seq_len=32768,        # honoured mechanically for assigned shapes
    source="arXiv:2212.04356; unverified",
))
