from repro_torch.kernels.block_sparse_attention.ops import (
    KERNEL, attention_tile_work, block_sparse_attention,
    block_sparse_attention_fwd)
from repro_torch.kernels.block_sparse_attention.ref import (
    block_sparse_attention_ref)

__all__ = ["KERNEL", "attention_tile_work", "block_sparse_attention",
           "block_sparse_attention_fwd", "block_sparse_attention_ref"]
