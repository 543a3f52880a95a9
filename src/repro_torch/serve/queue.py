"""Request queue and admission accounting for the serving tier.

The neuromorphic ``FleetEngine`` (a queue of pending user sessions
admitted into batched chip or board instances) sits on this module.
The queue is the
activity signal of the paper's spike-FIFO -> performance-level loop
applied to serving: its depth feeds ``repro_torch.core.dvfs.QueueDVFS``,
which selects how wide the machine runs this round.

``RequestQueue`` is FIFO with one twist the fleet needs: ``submit(...,
front=True)`` re-queues a preempted (checkpointed) session at the head,
so sessions evicted when the fleet narrows resume before new arrivals
are admitted.  Every item's queue wait is recorded at ``take`` time, so
admission latency lands in the serving stats.

Host-side Python and numpy only: nothing here touches a tensor.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional

import numpy as np


class RequestQueue:
    """FIFO admission queue of the serving engines.

    ``spans`` optionally attaches a ``repro_torch.obs.spans.SpanLog``: every
    ``submit`` then opens (or re-opens, for preempted sessions) the
    item's request-lifecycle span with an ``enqueue`` event — the queue
    is where a request's observable life begins, so the hook lives here
    rather than in each engine."""

    def __init__(self, clock=time.perf_counter, spans=None):
        self._q: deque = deque()          # (item, enqueue_time)
        self._clock = clock
        self.spans = spans
        self.submitted = 0
        self.taken = 0
        self.wait_s: list = []            # queue wait of every taken item

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    def submit(self, item, *, front: bool = False) -> None:
        """Enqueue ``item``; ``front=True`` puts it at the head (used for
        preempted sessions so they resume before fresh arrivals)."""
        entry = (item, self._clock())
        if front:
            self._q.appendleft(entry)
        else:
            self._q.append(entry)
        self.submitted += 1
        if self.spans is not None:
            sid = getattr(item, "sid", None)
            if sid is not None:
                self.spans.emit(
                    "enqueue", sid, front=front, depth=len(self._q),
                    ticks_done=int(getattr(item, "ticks_done", 0)))

    def extend(self, items) -> None:
        for it in items:
            self.submit(it)

    def take(self, n: int) -> list:
        """Dequeue up to ``n`` items in order, recording each one's queue
        wait (seconds between submit and take)."""
        now = self._clock()
        out = []
        while self._q and len(out) < n:
            item, t0 = self._q.popleft()
            self.wait_s.append(now - t0)
            out.append(item)
        self.taken += len(out)
        return out

    def peek_depth_with(self, in_flight: int = 0) -> int:
        """The admission-control activity signal: waiting + in-flight.

        Feeding only the waiting depth to ``QueueDVFS`` would collapse
        the width the moment the queue drains even with a full fleet in
        flight; offered load is both terms."""
        return len(self._q) + in_flight

    def stats(self) -> dict:
        w = np.asarray(self.wait_s, np.float64)
        return {
            "submitted": self.submitted,
            "taken": self.taken,
            "waiting": len(self._q),
            "wait_p50_s": float(np.percentile(w, 50)) if w.size else 0.0,
            "wait_p99_s": float(np.percentile(w, 99)) if w.size else 0.0,
        }


def percentiles(samples, ps=(50, 99)) -> dict:
    """{p50: ..., p99: ...} of ``samples`` (0.0s when empty) — the one
    latency summary both serving engines report.

    Edge cases are defined, not accidental: an empty input (or one that
    is all ``None`` — e.g. latencies of sessions that never completed)
    yields 0.0 for every percentile, and a single sample is its own
    p50 AND p99 (``np.percentile`` of one point), so downstream
    ``p99 >= p50`` comparisons hold for any sample count."""
    a = np.asarray([s for s in samples if s is not None], np.float64)
    return {f"p{p}": (float(np.percentile(a, p)) if a.size else 0.0)
            for p in ps}


def select_width(dvfs, queue: RequestQueue, in_flight: int,
                 capacity: Optional[int] = None) -> int:
    """Activity-driven width: offered load (waiting + in-flight) through
    ``QueueDVFS.batch_size``, clamped to ``capacity``."""
    width = dvfs.batch_size(queue.peek_depth_with(in_flight))
    return min(width, capacity) if capacity is not None else width
