"""xLSTM 1.3B — mLSTM + sLSTM blocks (7:1 pattern). [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig, register

# sLSTM at positions spaced every 8th block (7:1 mLSTM:sLSTM), per paper recipe.
_SLSTM_POSITIONS = tuple(range(3, 48, 8))

XLSTM_1P3B = register(ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                   # xLSTM blocks have no separate FFN (gated proj inside)
    vocab_size=50304,
    head_dim=512,
    slstm_positions=_SLSTM_POSITIONS,
    source="arXiv:2405.04517; unverified",
))
