"""Request-lifecycle spans for the serving tier.

Every user session served by the fleet gets a *span chain* — the ordered
structured events of its lifecycle:

    enqueue -> admit (slot, width) -> round* -> preempt -> enqueue ->
    resume -> round* -> complete

recorded host-side by ``FleetEngine``/``RequestQueue`` into one
``SpanLog`` per serve.  The log also samples per-round *fleet counters*
(queue depth, fleet width, active residents, batched tick time, round
energy) — the signals ``repro_torch.obs.trace`` renders as Perfetto counter
tracks next to the per-slot request slices.

The chain is a checkable grammar, not just a log: ``validate_spans``
runs the per-session state machine (admit precedes ticks, resume only
after preempt/suspend, exactly one terminal event, nothing after
completion) and returns every violation — the serving health verdict
and the span-completeness tests both gate on it.  A session restored
from a checkpoint in a *fresh* engine opens its chain with an
``enqueue`` carrying ``ticks_done > 0``, which the validator treats as
the preempted state — so a single engine's log validates standalone,
and two engines' logs concatenated per session validate as one chain
across suspend-to-disk/restore.
"""
from __future__ import annotations

import gzip
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

SPAN_KINDS = ("enqueue", "admit", "resume", "round", "preempt",
              "suspend", "complete", "slo")

# fleet-level events (SLO violations, ...) carry this sid
FLEET_SID = -1


@dataclass(frozen=True)
class SpanEvent:
    """One structured lifecycle event: ``kind`` from ``SPAN_KINDS``,
    the session it belongs to (``FLEET_SID`` for fleet-level events),
    wall time relative to the log's epoch, the scheduling round it
    happened in (-1 outside the round loop), and kind-specific args."""
    kind: str
    sid: int = FLEET_SID
    t_s: float = 0.0
    round: int = -1
    args: dict = field(default_factory=dict)

    def asdict(self) -> dict:
        return {"kind": self.kind, "sid": self.sid,
                "t_s": round(self.t_s, 6), "round": self.round,
                "args": self.args}


class SpanLog:
    """Append-only span recorder + per-round fleet counter samples."""

    def __init__(self, clock=time.perf_counter, meta: dict | None = None):
        self._clock = clock
        self.epoch = clock()
        self.events: list[SpanEvent] = []
        self.counters: list[dict] = []
        self.meta = dict(meta or {})

    def now(self) -> float:
        return self._clock() - self.epoch

    def emit(self, kind: str, sid: int = FLEET_SID, round_i: int = -1,
             **args) -> SpanEvent:
        if kind not in SPAN_KINDS:
            raise ValueError(f"unknown span kind {kind!r}; expected one "
                             f"of {SPAN_KINDS}")
        ev = SpanEvent(kind=kind, sid=int(sid), t_s=self.now(),
                       round=int(round_i), args=args)
        self.events.append(ev)
        return ev

    def sample(self, round_i: int, **vals) -> None:
        """Record one per-round fleet counter sample (queue depth, width,
        tick time, energy, ...) — the counter-track side of the trace."""
        self.counters.append({"round": int(round_i),
                              "t_s": round(self.now(), 6), **vals})

    def for_sid(self, sid: int) -> list[SpanEvent]:
        return [e for e in self.events if e.sid == sid]

    @property
    def sids(self) -> list[int]:
        return sorted({e.sid for e in self.events if e.sid != FLEET_SID})

    # ------------------------------------------------------- (de)serialize
    def payload(self) -> dict:
        return {"schema": "fleet-spans-v1", "meta": self.meta,
                "events": [e.asdict() for e in self.events],
                "counters": self.counters}

    def write(self, path, compress: bool = False) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        blob = json.dumps(self.payload())
        if compress or path.suffix == ".gz":
            if path.suffix != ".gz":
                path = path.with_suffix(path.suffix + ".gz")
            path.write_bytes(gzip.compress(blob.encode()))
        else:
            path.write_text(blob)
        return path


def load_spans(path) -> dict:
    """Read a span-log payload written by ``SpanLog.write`` (gzip
    transparent: ``.gz`` paths decompress)."""
    path = Path(path)
    raw = path.read_bytes()
    if path.suffix == ".gz" or raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return json.loads(raw.decode())


# ---------------------------------------------------------------------------
# The span-chain grammar
# ---------------------------------------------------------------------------

_NEW, _QUEUED, _RESIDENT, _PREEMPTED, _DONE = range(5)
_STATE_NAMES = {_NEW: "new", _QUEUED: "queued", _RESIDENT: "resident",
                _PREEMPTED: "preempted", _DONE: "done"}


def validate_spans(events, require_complete: bool = False) -> list:
    """Check every session's span chain against the lifecycle grammar.

    ``events`` is an iterable of ``SpanEvent`` or their ``asdict`` form
    (so loaded payloads validate too); events must be in emission order
    per session — concatenating the logs of two engines that served the
    same session (suspend-to-disk, restore) yields one valid chain.

    Rules, per session:

    * the chain opens with ``enqueue`` (a restore into a fresh engine
      opens with an ``enqueue`` whose args carry ``ticks_done > 0`` —
      treated as arriving already-preempted);
    * ``admit`` only from the queue, and only as the FIRST residency;
      ``resume`` only from the queue after a ``preempt``/``suspend``;
    * ``round`` events (ticks actually served) only while resident;
    * ``preempt``/``suspend`` only while resident, and re-queueing
      (``enqueue``) only after one of them;
    * exactly one terminal ``complete`` (while resident), then nothing.

    Returns a list of human-readable violations (empty = valid).  With
    ``require_complete`` every session must have reached ``complete`` —
    the full-drain invariant (a dropped session is a broken chain).
    """
    problems: list = []
    state: dict = {}
    seen_ticks: dict = {}

    def ev_fields(e):
        if isinstance(e, SpanEvent):
            return e.kind, e.sid, e.args
        return e["kind"], e["sid"], e.get("args", {})

    for i, e in enumerate(events):
        kind, sid, args = ev_fields(e)
        if sid == FLEET_SID:
            continue                       # fleet-level events are free-form
        st = state.get(sid, _NEW)
        bad = None
        if kind == "enqueue":
            if st == _NEW:
                # a restored session opens mid-lifecycle
                state[sid] = _QUEUED
                if float(args.get("ticks_done", 0)) > 0:
                    seen_ticks[sid] = True
            elif st == _PREEMPTED:
                state[sid] = _QUEUED
            else:
                bad = "enqueue while " + _STATE_NAMES[st]
        elif kind == "admit":
            if st == _QUEUED and not seen_ticks.get(sid):
                state[sid] = _RESIDENT
            elif seen_ticks.get(sid):
                bad = "admit after ticks were served (expected resume)"
            else:
                bad = "admit while " + _STATE_NAMES[st]
        elif kind == "resume":
            if st == _QUEUED and seen_ticks.get(sid):
                state[sid] = _RESIDENT
            elif not seen_ticks.get(sid):
                bad = "resume with no prior preempt/suspend"
            else:
                bad = "resume while " + _STATE_NAMES[st]
        elif kind == "round":
            if st != _RESIDENT:
                bad = "round while " + _STATE_NAMES[st]
            elif float(args.get("ticks", 1)) > 0:
                seen_ticks[sid] = True
        elif kind in ("preempt", "suspend"):
            if st == _RESIDENT:
                state[sid] = _PREEMPTED
            else:
                bad = f"{kind} while " + _STATE_NAMES[st]
        elif kind == "complete":
            if st == _RESIDENT:
                state[sid] = _DONE
            else:
                bad = "complete while " + _STATE_NAMES[st]
        else:
            bad = f"unknown kind {kind!r}"
        if bad:
            problems.append(f"event {i} sid {sid}: {bad}")

    if require_complete:
        for sid, st in sorted(state.items()):
            if st != _DONE:
                problems.append(f"sid {sid}: chain ended "
                                f"{_STATE_NAMES[st]}, never completed")
    return problems
