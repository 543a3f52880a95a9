"""Session bookkeeping for the fleet engine.

A *session* is one user attached to one instance slot of the batched
fleet: their input stream, how many ticks of it have been served, the
accumulated per-tick outputs and energy, and, when the session is not
resident, where its checkpoint lives.  The ``SessionTable`` keeps the
resident sessions in a compact slot prefix (slot i of the batched carry
is session ``table.slots[i]``), so the fleet always runs the smallest
batch width covering the active set: completing or evicting a mid-table
session moves the LAST resident session into the hole (one copy on the
carry: instances are slot-relocatable because the batched tick treats
every instance alike).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Session:
    """One user session's lifecycle record."""
    sid: int
    stream: object                       # .signal(t0, n) -> raw input
    total_ticks: int
    ticks_done: int = 0
    arrival_s: float = 0.0               # submit wall-clock
    admitted_s: Optional[float] = None   # first admission
    done_s: Optional[float] = None       # completion wall-clock
    energy_j: float = 0.0                # simulated joules served so far
    ticks_run: int = 0                   # includes post-completion padding
    preemptions: int = 0
    outputs: dict = field(default_factory=dict)   # key -> [per-round np]
    response: Optional[dict] = None
    snapshot: Optional[object] = None    # in-memory ckpt (no ckpt_dir)
    ckpt_step: int = -1                  # last on-disk checkpoint step

    @property
    def remaining(self) -> int:
        return max(0, self.total_ticks - self.ticks_done)

    @property
    def done(self) -> bool:
        return self.ticks_done >= self.total_ticks

    def latency_s(self) -> Optional[float]:
        return None if self.done_s is None else self.done_s - self.arrival_s


class SessionTable:
    """The resident set: sessions packed into slots [0, n_active)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.slots: list[Session] = []

    def __len__(self) -> int:
        return len(self.slots)

    @property
    def n_active(self) -> int:
        return len(self.slots)

    def admit(self, session: Session) -> int:
        """Seat ``session`` in the next free slot; returns the slot."""
        if len(self.slots) >= self.capacity:
            raise RuntimeError(f"session table full ({self.capacity})")
        self.slots.append(session)
        return len(self.slots) - 1

    def evict(self, slot: int):
        """Remove the session at ``slot``, compacting by moving the last
        resident session into the hole.  Returns ``(evicted, moved_from)``
        where ``moved_from`` is the old slot of the relocated session
        (``None`` when the tail slot itself was evicted) — the caller
        mirrors the move on the batched carry."""
        last = len(self.slots) - 1
        evicted = self.slots[slot]
        if slot == last:
            self.slots.pop()
            return evicted, None
        self.slots[slot] = self.slots.pop()
        return evicted, last

    def evict_tail(self):
        """Remove and return the last resident session (no compaction
        needed — the preemption path narrows from the tail)."""
        return self.slots.pop()
