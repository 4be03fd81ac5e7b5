"""GPT configs matching the paper's own evaluation models (§5: seq 2048,
hidden 1024, 32 heads; depth varied). Used by the reproduction benchmarks."""
from repro_torch.configs.base import ModelConfig, register


def _gpt(layers: int) -> ModelConfig:
    return ModelConfig(
        name=f"gpt-paper-{layers}l",
        family="dense",
        num_layers=layers,
        d_model=1024,
        num_heads=32,
        num_kv_heads=32,
        d_ff=4096,
        vocab_size=50257,
        head_dim=32,
        max_seq_len=2048,
        rope_theta=1e4,
        source="paper §5 (GPT-2 style)",
    )


GPT_PAPER_24L = register(_gpt(24))
GPT_PAPER_32L = register(_gpt(32))
GPT_PAPER_40L = register(_gpt(40))
GPT_PAPER_48L = register(_gpt(48))
