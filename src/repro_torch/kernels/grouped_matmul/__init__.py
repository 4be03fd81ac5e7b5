from repro_torch.kernels.grouped_matmul.backward import (grouped_matmul_bwd,
                                                         grouped_tile_work)
from repro_torch.kernels.grouped_matmul.ops import (KERNEL, KERNEL_DW,
                                                    grouped_matmul,
                                                    grouped_product,
                                                    grouped_product_dw,
                                                    placement_maps)
from repro_torch.kernels.grouped_matmul.ref import (grouped_matmul_dw_ref,
                                                    grouped_matmul_ref,
                                                    grouped_product_dw_ref,
                                                    grouped_product_ref)

__all__ = ["KERNEL", "KERNEL_DW", "grouped_matmul", "grouped_matmul_bwd",
           "grouped_matmul_dw_ref", "grouped_matmul_ref", "grouped_product",
           "grouped_product_dw", "grouped_product_dw_ref",
           "grouped_product_ref", "grouped_tile_work", "placement_maps"]
