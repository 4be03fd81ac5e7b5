"""Continuous-batching scheduler over the fixed-shape pipeline batch.

One scheduler *tick* = (admit new requests → prefill their lanes) then
(one pipelined decode step for every live lane).  The pipeline fns keep
their fixed ``[num_micro, mb_global]`` shapes — the scheduler fills lanes
and masks, it never reshapes:

  * **Admission/prefill.**  Freed lanes are bound to queued requests; one
    prefill call writes the admitted lanes' KV lines (right-padded to the
    cell's ``prompt_len``), and the server merges only those lanes into
    the live cache.  A full-length prompt's first token comes straight
    from the prefill's last-position argmax (exactly the one-shot path);
    a shorter prompt bootstraps by re-feeding its last prompt token at
    position ``plen-1`` — the decode re-writes that position's KV with
    identical values and its output is the first generated token.  The
    pad garbage prefill wrote beyond ``plen`` is invisible: decode masks
    the cache at each lane's OWN length and overwrites the pad positions
    as the lane advances through them.
  * **Decode.**  Every live lane decodes at its own position (the
    pipeline's per-lane ``pos`` path).  Free lanes carry garbage whose
    outputs are ignored and whose stale cache writes are overwritten at
    re-admission.
  * **Early exit.**  A finished (gen budget or EOS) sequence vacates its
    lane the same tick; ``defrag_every`` compacts survivors into the lane
    prefix (``SlotManager.defrag``), moving KV lines without touching
    tokens.

All decisions are functions of the trace and tick number only — a serving
run is bit-deterministic and independent of the execution world's stage
count, which is what the elastic-vs-fixed token-identity guarantee rests
on (see DESIGN.md §10).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.requests import Request, RequestQueue
from repro_torch.serve.slots import SlotManager


@dataclasses.dataclass
class AdmissionPlan:
    """Lanes admitted this tick; ``prefill_tokens`` is the full-shape token
    batch (admitted lanes hold their right-padded prompts, the rest zeros)
    and ``admit_mask`` selects the lanes whose KV lines the merge takes.
    Paged mode adds ``page_table``/``pack_mask`` [m, B, J]: where to scatter
    the admitted lanes' prompt pages out of the prefill scratch."""
    lanes: List[Tuple[int, Request]]
    prefill_tokens: np.ndarray          # [m, B, prompt_len] int32
    admit_mask: np.ndarray              # [m, B] bool
    full_len_lanes: List[int]           # lanes taking token 1 from prefill
    page_table: Optional[np.ndarray] = None   # [m, B, J] int32, -1 unmapped
    pack_mask: Optional[np.ndarray] = None    # [m, B, J] bool


@dataclasses.dataclass
class DecodePlan:
    tokens: np.ndarray                  # [m, B] int32 (free lanes: 0)
    pos: np.ndarray                     # [m, B] int32 per-lane positions
    active: np.ndarray                  # [m, B] bool
    lanes: List[int]                    # flat indices of live lanes
    page_table: Optional[np.ndarray] = None   # [m, B, J] int32, -1 unmapped
    copies: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    seeds: Optional[np.ndarray] = None  # [m, B] int32 per-lane sample seeds


class Scheduler:
    def __init__(self, num_micro: int, mb: int, prompt_len: int,
                 cache_len: int, queue: RequestQueue, *,
                 eos_id: Optional[int] = None, defrag_every: int = 0,
                 allocator=None, sample_seed: Optional[int] = None):
        assert cache_len >= prompt_len
        self.prompt_len = prompt_len
        self.cache_len = cache_len
        self.queue = queue
        self.eos_id = eos_id
        self.defrag_every = defrag_every
        # paged KV: admission gates on free *pages* (the real memory), and
        # lanes only carry page-table rows — freeing a lane releases its
        # pages through the SlotManager shim
        self.allocator = allocator
        if allocator is not None:
            if cache_len % allocator.page_size:
                raise ValueError("cache_len must be a multiple of the KV "
                                 "page size (paged rows == dense rows)")
            self.n_table_pages = cache_len // allocator.page_size
        # per-lane sampling (temperature > 0): seed is a deterministic
        # function of (base seed, rid, position) so requeued lanes replay
        # and resume identically
        self.sample_seed = sample_seed
        self.slots = SlotManager(num_micro, mb, allocator=allocator)
        n = self.slots.n_lanes
        self.cur_tok = np.zeros(n, np.int32)
        self.pos = np.zeros(n, np.int32)
        self.gen_done = np.zeros(n, np.int64)
        self.gen_budget = np.zeros(n, np.int64)
        self.live: Dict[int, Request] = {}
        self.completions: List[Request] = []
        # teacher-forced replay (requeued lanes, DESIGN.md §12): known
        # tokens still to feed through decode to rebuild the KV line; while
        # a lane replays, decode emissions are ignored — the model's
        # predictions are only recorded once it reaches unseen positions
        self.replay: Dict[int, deque] = {}
        self.requeued_total = 0

    # -- signals (autoscaler food) ----------------------------------------
    @property
    def queue_depth(self) -> int:
        return self.queue.depth

    @property
    def occupancy(self) -> float:
        return self.slots.num_active / self.slots.n_lanes

    @property
    def page_occupancy(self) -> Optional[float]:
        """Fraction of pool pages live, or None in dense mode — THE memory
        signal: lane occupancy says how many requests run, page occupancy
        says whether another one fits."""
        return None if self.allocator is None else self.allocator.occupancy

    @property
    def done(self) -> bool:
        return self.queue.exhausted and self.slots.num_active == 0

    # -- tick phases -------------------------------------------------------
    def plan_admissions(self, tick: int) -> Optional[AdmissionPlan]:
        self.queue.poll(tick)
        if not self.queue.pending or self.slots.num_free == 0:
            return None
        m, B = self.slots.num_micro, self.slots.mb
        toks = np.zeros((m, B, self.prompt_len), np.int32)
        mask = np.zeros((m, B), bool)
        lanes: List[Tuple[int, Request]] = []
        full: List[int] = []
        while self.queue.pending and self.slots.num_free > 0:
            if self.allocator is not None:
                # gate on free PAGES, not free lanes: the head request's
                # whole lifetime footprint (after prefix-cache hits) must
                # fit now — no mid-flight allocation, no deadlock.  A head
                # that doesn't fit blocks the queue (FIFO determinism).
                h = self.queue.peek()
                hp = min(h.plen, self.prompt_len)
                hg = min(h.gen, self.cache_len - h.plen + 1)
                if not self.allocator.can_admit(h.prompt[:hp], hg):
                    break
            r = self.queue.pop()
            lane = self.slots.alloc(r.rid)
            # admission owns the runtime fields: serving the same Request
            # objects through a second run must not append onto the first
            # run's token stream.  A requeued request re-enters with its
            # already-generated tokens as ``carried`` — prompt+carried is
            # the effective prompt whose KV this admission rebuilds
            r.admitted = tick
            r.finished = -1
            r.tokens = list(r.carried)
            mi, bi = self.slots.unravel(lane)
            pl = min(r.plen, self.prompt_len)
            toks[mi, bi, :pl] = r.prompt[:pl]
            mask[mi, bi] = True
            self.live[lane] = r
            # the cache line bounds how far the lane can decode: token g
            # is written at plen - 2 + g, which must stay < cache_len
            # (carried tokens were generated under that same budget, so a
            # requeued lane's replay always fits)
            self.gen_budget[lane] = min(r.gen,
                                        self.cache_len - r.plen + 1)
            self.gen_done[lane] = len(r.carried)
            if self.allocator is not None:
                self.allocator.admit(r.rid, r.prompt[:pl],
                                     int(self.gen_budget[lane]))
                # if the bootstrap write position plen-1 landed in a shared
                # full prompt page, fork it now — the gate reserved the
                # block, and pack fills it from this lane's own scratch
                # (so no device copy is needed for an admission-time fork)
                self.allocator.ensure_private(
                    r.rid, (pl - 1) // self.allocator.page_size)
            if r.carried:
                # requeued lane: rebuild the KV line with the SAME ops
                # that originally produced it — the prefill covers the
                # prompt only, and every carried token is teacher-forced
                # through decode (note_decode feeds the known tokens and
                # ignores emissions until the replay drains).  Rebuilding
                # carried positions via prefill would be ULP-different
                # from the decode that first wrote them, and a near-tie
                # argmax downstream can flip — losing token identity.
                if r.plen >= self.prompt_len:
                    # original run took token 1 from the prefill argmax;
                    # resume at its first decode: feed token 1 at plen
                    self.pos[lane] = r.plen
                    self.cur_tok[lane] = int(r.carried[0])
                    rest = r.carried[1:]
                else:
                    # resume at the bootstrap decode (re-feed the last
                    # prompt token at plen-1, exactly like admission did)
                    self.pos[lane] = r.plen - 1
                    self.cur_tok[lane] = int(r.prompt[r.plen - 1])
                    rest = r.carried
                if rest:
                    self.replay[lane] = deque(int(t) for t in rest)
            else:
                # next-decode position is plen-1 either way: full-length
                # lanes take their next token from the prefill argmax
                # (``_record`` advances them), shorter prompts bootstrap by
                # re-feeding their last token there (the decode re-writes
                # that position's KV with identical values and emits the
                # next token)
                self.pos[lane] = r.plen - 1
                if r.plen >= self.prompt_len:
                    full.append(lane)
                else:
                    self.cur_tok[lane] = int(r.prompt[r.plen - 1])
            lanes.append((lane, r))
        if not lanes:
            return None                 # page gate blocked the whole batch
        ptab = pmask = None
        if self.allocator is not None:
            ptab, pmask = self._page_table_for(lanes)
        return AdmissionPlan(lanes, toks, mask, full, ptab, pmask)

    def _page_table_for(self, lanes) -> Tuple[np.ndarray, np.ndarray]:
        """[m, B, J] device page table + prompt-page pack mask for the given
        (lane, request) pairs; other rows stay unmapped (-1)."""
        m, B = self.slots.num_micro, self.slots.mb
        J = self.n_table_pages
        ptab = np.full((m, B, J), -1, np.int32)
        pmask = np.zeros((m, B, J), bool)
        ps = self.allocator.page_size
        for lane, r in lanes:
            mi, bi = self.slots.unravel(lane)
            pgs = self.allocator.pages_of(r.rid)
            ptab[mi, bi, :len(pgs)] = pgs
            pl = min(r.plen, self.prompt_len)
            pmask[mi, bi, :-(-pl // ps)] = True
        return ptab, pmask

    def note_prefill(self, plan: AdmissionPlan, prefill_ids: np.ndarray,
                     tick: int) -> List[Request]:
        """Record first tokens for full-length admissions (may finish
        one-token requests immediately); returns the finished ones."""
        finished: List[Request] = []
        for lane in plan.full_len_lanes:
            mi, bi = self.slots.unravel(lane)
            tok = int(prefill_ids[mi, bi])
            self._record(lane, tok, tick, finished)
        return finished

    def plan_decode(self) -> Optional[DecodePlan]:
        lanes = [ln for ln in self.slots.active_lanes()]
        if not lanes:
            return None
        m, B = self.slots.num_micro, self.slots.mb
        active = (self.slots.owner >= 0).reshape(m, B)
        ptab, copies = None, []
        if self.allocator is not None:
            # copy-on-write: if any lane's write page this tick is still
            # shared, fork it (device block copies the server must apply
            # BEFORE this decode) — then snapshot the remapped table
            ps = self.allocator.page_size
            for lane in lanes:
                wpos = min(int(self.pos[lane]), self.cache_len - 1)
                cp = self.allocator.ensure_private(self.live[lane].rid,
                                                   wpos // ps)
                if cp is not None:
                    copies.append(cp)
            ptab, _ = self._page_table_for(
                [(ln, self.live[ln]) for ln in lanes])
        seeds = None
        if self.sample_seed is not None:
            seeds = np.zeros((m, B), np.int32)
            for lane in lanes:
                mi, bi = self.slots.unravel(lane)
                seeds[mi, bi] = ((self.sample_seed * 1000003
                                  + self.live[lane].rid * 8191
                                  + int(self.pos[lane])) & 0x7FFFFFFF)
        return DecodePlan(self.cur_tok.reshape(m, B).copy(),
                          self.pos.reshape(m, B).copy(), active, lanes,
                          ptab, copies, seeds)

    def note_decode(self, plan: DecodePlan, ids: np.ndarray,
                    tick: int) -> List[Request]:
        finished: List[Request] = []
        for lane in plan.lanes:
            dq = self.replay.get(lane)
            if dq is not None:
                # teacher-forced replay: this decode rebuilt one KV
                # position; advance with the KNOWN next token and drop the
                # model's emission — predictions only count at positions
                # the original run never reached
                self.cur_tok[lane] = dq.popleft()
                self.pos[lane] = self.pos[lane] + 1
                if not dq:
                    del self.replay[lane]
                continue
            mi, bi = self.slots.unravel(lane)
            self._record(lane, int(ids[mi, bi]), tick, finished)
        return finished

    def _record(self, lane: int, tok: int, tick: int,
                finished: List[Request]) -> None:
        r = self.live[lane]
        r.tokens.append(tok)
        self.gen_done[lane] += 1
        self.cur_tok[lane] = tok
        self.pos[lane] = self.pos[lane] + 1
        if (self.gen_done[lane] >= self.gen_budget[lane]
                or (self.eos_id is not None and tok == self.eos_id)):
            r.finished = tick
            self.slots.free(lane)
            del self.live[lane]
            self.completions.append(r)

    def maybe_defrag(self, tick: int) -> Optional[np.ndarray]:
        """On cadence, compact live lanes into the prefix.  Returns the
        ``src_of_dst`` lane permutation the server must apply to the KV
        cache, or None.  Scheduler-side per-lane state moves here."""
        if not self.defrag_every or (tick + 1) % self.defrag_every:
            return None
        perm = self.slots.defrag()
        if perm is None:
            return None
        self.cur_tok = self.cur_tok[perm]
        self.pos = self.pos[perm]
        self.gen_done = self.gen_done[perm]
        self.gen_budget = self.gen_budget[perm]
        self.live = {int(np.nonzero(perm == old)[0][0]): r
                     for old, r in self.live.items()}
        self.replay = {int(np.nonzero(perm == old)[0][0]): dq
                       for old, dq in self.replay.items()}
        return perm

    # -- fault recovery (DESIGN.md §12) ------------------------------------
    def requeue_live(self, tick: int) -> List[Request]:
        """A worker crash lost part of every live lane's KV line (each line
        passes through every stage).  Pull every in-flight request back to
        the FRONT of the queue with its generated-so-far tokens carried;
        re-admission rebuilds the KV from the token prefix and generation
        resumes token-identically.  Returns the requeued requests."""
        requeued = [r for _, r in sorted(self.live.items())]
        for lane in list(self.live):
            self.slots.free(lane)
        self.live.clear()
        self.replay.clear()
        for r in reversed(requeued):
            r.carried = list(r.tokens)
            r.requeues += 1
            self.queue.push_front(r)
        self.requeued_total += len(requeued)
        return requeued
