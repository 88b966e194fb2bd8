"""Discrete-event simulation kernel.

Drives the validation-testbed network model (paper §4.2.2) and the Fig. 5
experiment: every transmission, queue and inference occupies simulated time.
Also usable in instant mode (``InstantClock``) where events fire inline —
that is what the platform/integration tests use.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional


class SimClock:
    def __init__(self):
        self.now = 0.0
        self._q = []
        self._seq = itertools.count()

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        assert delay >= 0, delay
        heapq.heappush(self._q, (self.now + delay, next(self._seq), fn))

    def schedule_at(self, t: float, fn: Callable[[], None]) -> None:
        self.schedule(max(0.0, t - self.now), fn)

    def run(self, until: Optional[float] = None, max_events: int = 10_000_000) -> int:
        """Process events (optionally up to simulated time ``until``)."""
        n = 0
        while self._q and n < max_events:
            t, _, fn = self._q[0]
            if until is not None and t > until:
                break
            heapq.heappop(self._q)
            self.now = t
            fn()
            n += 1
        if until is not None and self.now < until:
            self.now = until
        return n

    def empty(self) -> bool:
        return not self._q


class InstantClock(SimClock):
    """Clock whose events run inline at schedule time (zero-latency mode)."""

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        fn()
