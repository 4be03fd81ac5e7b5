"""Hand-written CUDA kernels of the port, one package per TPU kernel of the
reference, each with its plain PyTorch version beside it (the CPU path and
the oracle on the card).  ``KERNELS`` lists every kernel the port builds."""
from repro_torch.kernels.block_sparse_attention.ops import KERNEL as _BSA
from repro_torch.kernels.block_sparse_attention.ops import (
    KERNEL_DKV as _BSA_DKV)
from repro_torch.kernels.block_sparse_attention.ops import (
    KERNEL_DQ as _BSA_DQ)
from repro_torch.kernels.grouped_matmul.ops import KERNEL as _GM
from repro_torch.kernels.grouped_matmul.ops import KERNEL_DW as _GM_DW
from repro_torch.kernels.paged_attention.ops import KERNEL as _PAGED
from repro_torch.kernels.pruned_matmul.ops import KERNEL as _PM

KERNELS = (_BSA, _BSA_DQ, _BSA_DKV, _PM, _GM, _GM_DW, _PAGED)

__all__ = ["KERNELS"]
