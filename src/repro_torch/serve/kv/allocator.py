"""Host-side page allocator for the block-paged KV cache.

The device holds one physical block pool per stage-slot
(``[pool_pages + 1, page_size, n_kv, head_dim]``; the last block is a trash
block that absorbs gated writes).  This allocator owns everything else:

* a **free list** (lowest block first, so allocation order is deterministic
  for a given request schedule),
* **per-request page tables** — ``pages_of[rid][j]`` is the physical block
  backing logical page ``j`` (token positions ``[j*page_size,
  (j+1)*page_size)``) of request ``rid``,
* **refcounted prefix sharing** — a *full* prompt page (one entirely covered
  by prompt tokens) is registered under the hash of the token prefix it
  holds; later requests with the same prefix map the same physical block and
  bump its refcount,
* **copy-on-write** — before a lane writes into a shared block (refcount
  > 1), ``ensure_private`` forks it: a fresh block is allocated, the caller
  copies the bytes on device, and the writer's table is repointed.

Admission reserves a request's whole lifetime footprint up front
(``pages_needed``), so a request never blocks mid-flight on an empty free
list and admission gating cannot deadlock.
"""
from __future__ import annotations

import dataclasses
from bisect import insort
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    """Serving-side paged-KV settings (derived from ``RunSpec.serve``)."""

    page_size: int            # tokens per KV block
    pool_pages: int           # physical blocks in the pool (excl. trash)
    prefix_cache: bool = False

    def __post_init__(self) -> None:
        if self.page_size <= 0:
            raise ValueError("page_size must be positive")
        if self.pool_pages <= 0:
            raise ValueError("pool_pages must be positive")


class PageAllocator:
    """Free-list block allocator with refcounted copy-on-write sharing."""

    def __init__(self, pool_pages: int, page_size: int, *,
                 max_pages_per_req: int, prefix_cache: bool = False) -> None:
        if pool_pages <= 0 or page_size <= 0 or max_pages_per_req <= 0:
            raise ValueError("pool_pages/page_size/max_pages must be > 0")
        self.pool_pages = pool_pages
        self.page_size = page_size
        self.max_pages = max_pages_per_req
        self.prefix_cache = prefix_cache
        self._free: List[int] = list(range(pool_pages))   # sorted ascending
        self._refs: List[int] = [0] * pool_pages
        self._pages: Dict[int, List[int]] = {}            # rid -> blocks
        self._prefix: Dict[Tuple[int, ...], int] = {}     # prefix -> block
        self._key_of: Dict[int, Tuple[int, ...]] = {}     # block -> prefix
        self.prefix_hits = 0
        self.cow_forks = 0

    # -- accounting ---------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return self.pool_pages - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.live_pages / self.pool_pages

    def pages_of(self, rid: int) -> List[int]:
        return self._pages[rid]

    def pages_needed(self, plen: int, gen: int) -> int:
        """Blocks covering every position request ``rid`` will ever write.

        The scheduler writes generated token ``g`` at position
        ``plen - 2 + g`` (the bootstrap re-feed rewrites ``plen - 1``), so
        the max position touched is ``max(plen - 1, plen + gen - 2)``.
        """
        max_pos = max(plen - 1, plen + gen - 2)
        return max_pos // self.page_size + 1

    # -- admission ----------------------------------------------------------
    def _full_prompt_pages(self, plen: int) -> int:
        return plen // self.page_size

    def _prefix_key(self, prompt: Sequence[int], j: int) -> Tuple[int, ...]:
        return tuple(int(t) for t in prompt[:(j + 1) * self.page_size])

    def blocks_required(self, prompt: Sequence[int], gen: int) -> int:
        """Fresh blocks needed to admit, after prefix-cache hits.

        When the bootstrap write position ``plen - 1`` falls inside a shared
        full prompt page (``plen % page_size == 0``), the admitter forks that
        page immediately (``ensure_private``), so one extra block is counted
        here — the fork then runs in the same admission step as this gate and
        can never find the free list empty.
        """
        plen = len(prompt)
        need = self.pages_needed(plen, gen)
        if not self.prefix_cache:
            return need
        hits = {j for j in range(min(need, self._full_prompt_pages(plen)))
                if self._prefix_key(prompt, j) in self._prefix}
        fork = 1 if (plen - 1) // self.page_size in hits else 0
        return need - len(hits) + fork

    def can_admit(self, prompt: Sequence[int], gen: int) -> bool:
        need = self.pages_needed(len(prompt), gen)
        if need > self.max_pages:
            raise ValueError(
                f"request needs {need} pages > table capacity {self.max_pages}")
        return self.blocks_required(prompt, gen) <= len(self._free)

    def admit(self, rid: int, prompt: Sequence[int], gen: int) -> List[int]:
        """Map every page the request will ever touch; returns the table."""
        if rid in self._pages:
            raise ValueError(f"rid {rid} already admitted")
        if not self.can_admit(prompt, gen):
            raise RuntimeError("admit() without can_admit() — pool exhausted")
        plen = len(prompt)
        n = self.pages_needed(plen, gen)
        full = self._full_prompt_pages(plen)
        blocks: List[int] = []
        for j in range(n):
            key = (self._prefix_key(prompt, j)
                   if (self.prefix_cache and j < full) else None)
            hit = self._prefix.get(key) if key is not None else None
            if hit is not None:
                self._refs[hit] += 1
                self.prefix_hits += 1
                blocks.append(hit)
                continue
            blk = self._free.pop(0)
            self._refs[blk] = 1
            if key is not None:
                self._prefix[key] = blk
                self._key_of[blk] = key
            blocks.append(blk)
        self._pages[rid] = blocks
        return blocks

    # -- copy-on-write ------------------------------------------------------
    def ensure_private(self, rid: int, j: int) -> Optional[Tuple[int, int]]:
        """Fork page ``j`` of ``rid`` if shared; returns a (src, dst) block
        copy the caller must apply on device, or None if already private."""
        blocks = self._pages[rid]
        src = blocks[j]
        if self._refs[src] <= 1:
            return None
        if not self._free:
            raise RuntimeError("CoW fork with empty free list — the "
                               "admission gate under-reserved")
        dst = self._free.pop(0)
        self._refs[src] -= 1
        self._refs[dst] = 1
        blocks[j] = dst
        self.cow_forks += 1
        return (src, dst)

    # -- release ------------------------------------------------------------
    def free(self, rid: int) -> None:
        """Drop every mapping of ``rid``; blocks return to the free list as
        their refcounts reach zero (per-block free at EOS)."""
        for blk in self._pages.pop(rid):
            self._refs[blk] -= 1
            if self._refs[blk] == 0:
                key = self._key_of.pop(blk, None)
                if key is not None and self._prefix.get(key) == blk:
                    del self._prefix[key]
                insort(self._free, blk)

    # -- invariants ---------------------------------------------------------
    def check(self) -> None:
        mapped: Dict[int, int] = {}
        for rid, blocks in self._pages.items():
            if len(set(blocks)) != len(blocks):
                raise AssertionError(f"rid {rid} double-maps a block")
            for blk in blocks:
                mapped[blk] = mapped.get(blk, 0) + 1
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate block on the free list")
        for blk, n in mapped.items():
            if blk in free:
                raise AssertionError(f"block {blk} mapped while free")
            if self._refs[blk] != n:
                raise AssertionError(
                    f"block {blk}: refcount {self._refs[blk]} != mappers {n}")
        for blk in range(self.pool_pages):
            if blk not in mapped and blk not in free:
                raise AssertionError(f"block {blk} leaked")
            if blk in free and self._refs[blk] != 0:
                raise AssertionError(f"free block {blk} has refcount")
        if len(free) + len(mapped) != self.pool_pages:
            raise AssertionError("free + live != pool (conservation)")
        for key, blk in self._prefix.items():
            if self._refs[blk] <= 0 or self._key_of.get(blk) != key:
                raise AssertionError("prefix index points at a dead block")
