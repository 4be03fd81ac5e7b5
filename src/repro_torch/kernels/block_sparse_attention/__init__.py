from repro_torch.kernels.block_sparse_attention.ops import (
    KERNEL, KERNEL_DKV, KERNEL_DQ, attention_tile_work,
    block_sparse_attention, block_sparse_attention_bwd,
    block_sparse_attention_fwd)
from repro_torch.kernels.block_sparse_attention.ref import (
    block_sparse_attention_bwd_ref, block_sparse_attention_ref)

__all__ = ["KERNEL", "KERNEL_DKV", "KERNEL_DQ", "attention_tile_work",
           "block_sparse_attention", "block_sparse_attention_bwd",
           "block_sparse_attention_bwd_ref", "block_sparse_attention_fwd",
           "block_sparse_attention_ref"]
