"""Paged decode attention: single-token attention over a block-paged KV
pool, gathering K/V through a per-lane page table.

``paged_attention`` (kernel_impl="pallas") is the count-gated CUDA kernel,
which cuts each lane's pages into ``pa_splits`` ranges;
``paged_attention_ref`` gathers pages and defers to the dense
``decode_attention`` oracle.  ``paged_tile_work`` accounts kernel tiles
actually computed.
"""
from repro_torch.kernels.paged_attention.ops import (KERNEL, pa_splits,
                                                     paged_attention,
                                                     paged_attention_fwd,
                                                     paged_tile_work)
from repro_torch.kernels.paged_attention.ref import (
    gather_pages, paged_attention_fwd_ref, paged_attention_ref,
    paged_attention_split_ref)

__all__ = ["KERNEL", "pa_splits", "paged_attention", "paged_attention_fwd",
           "paged_attention_fwd_ref", "paged_attention_ref",
           "paged_attention_split_ref", "gather_pages", "paged_tile_work"]
