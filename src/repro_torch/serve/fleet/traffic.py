"""Synthetic user traffic for the serving benchmarks.

``PoissonTraffic`` is the load generator: each scheduling round it draws
``Poisson(rate)`` new session arrivals (deterministic in ``seed``) until
``n_sessions`` have been offered.  Every arrival is a ``SessionSpec`` —
a session seed (which parameterizes the user's input stream) and a
session length in ticks — that the fleet engine turns into a queued
``Session``.  Burstiness is what exercises the QueueDVFS width loop: a
Poisson stream at rate r keeps mean offered load at r sessions/round but
regularly spikes past the admission thresholds, forcing the fleet to
widen, then narrow (preempting + checkpointing sessions) as the burst
drains.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class SessionSpec:
    sid: int
    seed: int
    total_ticks: int


@dataclass
class PoissonTraffic:
    """Poisson session arrivals, ``rate`` expected per poll (= per
    scheduling round), stopping after ``n_sessions`` total.  Session
    lengths are uniform over ``tick_range`` (inclusive ends, quantized
    to ``tick_quantum``)."""
    rate: float = 2.0
    n_sessions: int = 64
    tick_range: tuple = (128, 384)
    tick_quantum: int = 1
    seed: int = 0
    _rng: np.random.Generator = field(init=False, repr=False)
    _emitted: int = field(init=False, default=0)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    @property
    def exhausted(self) -> bool:
        return self._emitted >= self.n_sessions

    def poll(self) -> list:
        """This round's arrivals (possibly empty)."""
        if self.exhausted:
            return []
        k = min(int(self._rng.poisson(self.rate)),
                self.n_sessions - self._emitted)
        out = []
        lo, hi = self.tick_range
        for _ in range(k):
            sid = self._emitted
            ticks = int(self._rng.integers(lo, hi + 1))
            q = max(1, self.tick_quantum)
            ticks = max(q, (ticks // q) * q)
            out.append(SessionSpec(sid=sid, seed=self.seed * 100003 + sid,
                                   total_ticks=ticks))
            self._emitted += 1
        return out

    def drain(self) -> list:
        """All remaining arrivals at once (closed-loop benchmarking)."""
        specs = []
        while not self.exhausted:
            specs.extend(self.poll())
        return specs
