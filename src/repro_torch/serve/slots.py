"""KV-cache slot (lane) manager — a thin shim over lane bookkeeping and,
when the paged KV subsystem is on, the block ``PageAllocator``.

The pipeline's serving shapes are fixed — ``[num_micro, mb_global]`` lanes —
but what a lane *owns* depends on the memory model: dense mode binds a lane
to one contiguous KV line; paged mode binds it to a request whose KV lives
in pool blocks managed by ``repro_torch.serve.kv.PageAllocator`` (this manager
then only tracks lane identity, and ``free`` forwards the request's pages
back to the allocator — per-block free at EOS).  Either way continuous
batching is lane bookkeeping: ``alloc`` binds a request to the lowest free
lane (determinism), ``free`` vacates it the tick the request finishes or
early-exits, and ``defrag`` compacts the active lanes into the lane-index
prefix.

Defrag keeps per-microbatch occupancy front-loaded: as early exits punch
holes across microbatches, compaction moves the stragglers together so
trailing microbatch rows drain to fully-empty (a deployment can then skip
them, and the occupancy signal the autoscaler shrinks on reflects real
packing, not fragmentation).  Lanes are independent in the model math, so
moving a request's KV line between lanes never changes its tokens
(property-tested).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class SlotManager:
    """Tracks lane ownership over the flat lane space [0, m*B)."""

    def __init__(self, num_micro: int, mb: int, allocator=None):
        self.num_micro = num_micro
        self.mb = mb
        self.n_lanes = num_micro * mb
        self.owner = np.full(self.n_lanes, -1, np.int64)   # rid or -1
        self._lane_of: Dict[int, int] = {}                 # rid -> lane
        # paged mode: the PageAllocator owning this lane space's KV blocks;
        # freeing a lane releases its request's pages
        self.allocator = allocator

    # -- queries -----------------------------------------------------------
    @property
    def num_active(self) -> int:
        return len(self._lane_of)

    @property
    def num_free(self) -> int:
        return self.n_lanes - self.num_active

    def active_lanes(self) -> List[int]:
        return sorted(self._lane_of.values())

    def lane_of(self, rid: int) -> int:
        return self._lane_of[rid]

    def unravel(self, lane: int):
        return divmod(lane, self.mb)                       # (micro, batch)

    # -- transitions -------------------------------------------------------
    def alloc(self, rid: int) -> int:
        """Bind ``rid`` to the lowest free lane."""
        if rid in self._lane_of:
            raise ValueError(f"request {rid} already holds lane "
                             f"{self._lane_of[rid]}")
        free = np.nonzero(self.owner < 0)[0]
        if free.size == 0:
            raise RuntimeError("no free lane (admission must check "
                               "num_free first)")
        lane = int(free[0])
        self.owner[lane] = rid
        self._lane_of[rid] = lane
        return lane

    def free(self, lane: int) -> int:
        """Vacate a lane; returns the rid that held it.  In paged mode the
        request's pages go back to the allocator in the same transition."""
        if not 0 <= lane < self.n_lanes:
            raise ValueError(f"lane {lane} out of range [0, {self.n_lanes})")
        rid = int(self.owner[lane])
        if rid < 0:
            raise ValueError(f"lane {lane} is already free")
        self.owner[lane] = -1
        del self._lane_of[rid]
        if self.allocator is not None:
            self.allocator.free(rid)
        return rid

    def defrag(self) -> Optional[np.ndarray]:
        """Compact active lanes into the prefix.  Returns ``src_of_dst``
        (a full lane permutation: destination lane i takes the state of
        source lane src_of_dst[i]) or None when already compact.  The
        caller must apply the same permutation to every per-lane array
        (KV cache lines, scheduler lane state)."""
        active = np.nonzero(self.owner >= 0)[0]
        if active.size == 0 or int(active[-1]) == active.size - 1:
            return None                                    # already compact
        free = np.nonzero(self.owner < 0)[0]
        src_of_dst = np.concatenate([active, free]).astype(np.int64)
        self.owner = self.owner[src_of_dst]
        self._lane_of = {int(r): i for i, r in enumerate(self.owner)
                         if r >= 0}
        return src_of_dst

    # -- invariants --------------------------------------------------------
    def check(self) -> None:
        """No lane double-assigned, no request on two lanes, map and owner
        array consistent — raised on violation (used by the tests after
        every transition)."""
        owned = self.owner[self.owner >= 0]
        assert len(set(owned.tolist())) == owned.size, "rid on two lanes"
        assert len(self._lane_of) == owned.size, "map/array out of sync"
        for rid, lane in self._lane_of.items():
            assert self.owner[lane] == rid, (rid, lane, self.owner[lane])
