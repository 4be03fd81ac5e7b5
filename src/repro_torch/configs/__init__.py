from repro_torch.configs.base import (
    BLOCK_DEC, BLOCK_DENSE, BLOCK_ENC, BLOCK_HYBRID_ATTN, BLOCK_MAMBA,
    BLOCK_MLSTM, BLOCK_MOE, BLOCK_PAD, BLOCK_SLSTM, BLOCK_TYPE_NAMES,
    SHAPES, DistConfig, ModelConfig, ShapeConfig, get_config, list_configs,
    reduced_config, register,
)

__all__ = [
    "BLOCK_DEC", "BLOCK_DENSE", "BLOCK_ENC", "BLOCK_HYBRID_ATTN",
    "BLOCK_MAMBA", "BLOCK_MLSTM", "BLOCK_MOE", "BLOCK_PAD", "BLOCK_SLSTM",
    "BLOCK_TYPE_NAMES", "SHAPES", "DistConfig", "ModelConfig", "ShapeConfig",
    "get_config", "list_configs", "reduced_config", "register",
]
