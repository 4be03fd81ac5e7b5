from repro_torch.kernels.pruned_matmul.backward import pruned_matmul_bwd
from repro_torch.kernels.pruned_matmul.ops import (KERNEL, matmul_tile_work,
                                                   product, pruned_matmul,
                                                   pruned_swiglu)
from repro_torch.kernels.pruned_matmul.ref import pruned_matmul_ref

__all__ = ["KERNEL", "matmul_tile_work", "product", "pruned_matmul",
           "pruned_matmul_bwd", "pruned_swiglu", "pruned_matmul_ref"]
