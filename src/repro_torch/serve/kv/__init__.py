"""Block-paged KV memory for the serving path.

A physical block pool replaces per-lane contiguous KV lines; requests hold
page tables mapping logical pages to pool blocks, with refcounted
copy-on-write sharing of common prompt prefixes.
"""
from repro_torch.serve.kv.allocator import PageAllocator, PagedKVConfig

__all__ = ["PageAllocator", "PagedKVConfig"]
