"""Request model + admission queue + arrival-trace generation.

Time is *logical* (scheduler ticks), not wall-clock: arrivals keyed to tick
numbers make every serving run deterministic for a given trace/seed, which
is what lets the elastic and fixed-mesh runs be compared token-for-token
(the autoscaler's load signals are functions of queue depth / occupancy,
never of wall time, unless the latency SLO signal is explicitly enabled).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request.  ``gen`` counts tokens to produce INCLUDING
    the first post-prompt token; ``kind`` tags the dynamism behavior the
    trace generator modelled for it (e.g. ``early_exit`` requests draw a
    short ``gen`` — the sequence leaves the batch early and vacates its
    KV lane)."""
    rid: int
    arrival: int                    # tick the request enters the queue
    prompt: np.ndarray              # [plen] int32, plen >= 1
    gen: int
    kind: str = "none"
    # runtime bookkeeping (stamped by the scheduler)
    admitted: int = -1
    finished: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    # fault recovery (DESIGN.md §12): tokens generated before the lane's
    # KV was lost to a worker crash.  Re-admission treats prompt+carried as
    # an extended prompt — prefill plus teacher-forced replay rebuilds the
    # KV line, and decoding resumes exactly where the crash cut it off
    carried: List[int] = dataclasses.field(default_factory=list)
    requeues: int = 0

    @property
    def plen(self) -> int:
        return int(len(self.prompt))


class RequestQueue:
    """Arrival stream + pending queue.  ``poll(tick)`` admits arrivals into
    the pending queue; the scheduler pops from it as KV lanes free up."""

    def __init__(self, requests: List[Request]):
        self._arrivals = sorted(requests, key=lambda r: (r.arrival, r.rid))
        self._cursor = 0
        self.pending: Deque[Request] = deque()

    def poll(self, tick: int) -> int:
        """Move requests with arrival <= tick into pending; returns count."""
        n = 0
        while (self._cursor < len(self._arrivals)
               and self._arrivals[self._cursor].arrival <= tick):
            self.pending.append(self._arrivals[self._cursor])
            self._cursor += 1
            n += 1
        return n

    def pop(self) -> Optional[Request]:
        return self.pending.popleft() if self.pending else None

    def peek(self) -> Optional[Request]:
        """Head of the pending queue without popping — page-gated admission
        checks the head's footprint and blocks head-of-line (FIFO stays
        deterministic) rather than admitting around it."""
        return self.pending[0] if self.pending else None

    def push_front(self, r: Request) -> None:
        """Requeue an evicted in-flight request ahead of ordinary arrivals —
        it already waited its turn once."""
        self.pending.appendleft(r)

    @property
    def depth(self) -> int:
        return len(self.pending)

    @property
    def exhausted(self) -> bool:
        return self._cursor >= len(self._arrivals) and not self.pending


def make_trace(n_requests: int, *, prompt_len: int, max_gen: int,
               vocab_size: int, seed: int = 0, min_prompt: int = 1,
               burst_period: int = 0, burst_len: int = 0,
               burst_rate: int = 4, lull_rate: int = 1,
               early_exit_frac: float = 0.0) -> List[Request]:
    """Bursty arrival trace with prompt/gen-length distributions.

    Arrivals follow a square wave: within each ``burst_period``-tick cycle
    the first ``burst_len`` ticks emit ``burst_rate`` requests/tick and the
    rest ``lull_rate`` (``burst_period=0`` → everything arrives at tick 0).
    ``early_exit_frac`` of requests are tagged ``early_exit`` and draw a
    short gen length (upper half of requests exit in the first quarter of
    ``max_gen``) — the serving-side analogue of CALM early exit: their KV
    lanes free early and the batch drains, which is exactly the load shape
    the autoscaler's occupancy watermark consolidates on.
    """
    assert 1 <= min_prompt <= prompt_len
    if burst_period > 0 and (burst_rate * min(burst_len, burst_period)
                             + lull_rate
                             * max(0, burst_period - burst_len)) <= 0:
        raise ValueError(
            f"arrival rate is zero everywhere (burst_rate={burst_rate} x "
            f"burst_len={burst_len}, lull_rate={lull_rate}) — the trace "
            f"would never reach {n_requests} requests")
    rng = np.random.RandomState(seed)
    out: List[Request] = []
    tick = 0
    while len(out) < n_requests:
        if burst_period > 0:
            in_burst = (tick % burst_period) < burst_len
            rate = burst_rate if in_burst else lull_rate
        else:
            rate = n_requests
        for _ in range(rate):
            if len(out) >= n_requests:
                break
            plen = int(rng.randint(min_prompt, prompt_len + 1))
            ee = bool(rng.rand() < early_exit_frac)
            hi = max(2, max_gen // 4) if ee else max_gen
            gen = int(rng.randint(1, hi + 1))
            out.append(Request(
                rid=len(out), arrival=tick,
                prompt=rng.randint(0, vocab_size, plen).astype(np.int32),
                gen=gen, kind="early_exit" if ee else "none"))
        tick += 1
    return out
