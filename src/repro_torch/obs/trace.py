"""Chrome/Perfetto trace-event export of recorded chip and board runs.

``trace_events(program, recs)`` turns the engine's per-tick records into
the Trace Event JSON format (https://ui.perfetto.dev loads it):

* one process per chip (boards) or one for the whole chip, one thread
  per PE named after its population and mesh coordinate;
* per-PE "X" slices on active ticks (multicast packets emitted);
* per-PE "pl" counter tracks, delta-encoded, so DVFS transitions render
  as step functions;
* a NoC process with per-tier flit counters (on-chip and the
  chip-to-chip tier) and traffic energy;
* per-slot learn-update counters (mean |dw| a tick) when the program is
  plastic.

``fleet_trace_events(payload)`` renders a served fleet's span log
(``obs.spans``): fleet counter tracks, one thread per fleet slot, one
per request with its queued and resident phases.

Also a command line, which runs a small board workload and writes its
trace, or renders a span log:

    python -m repro_torch.obs.trace --board 2x2 --chip 4x2 \\
        --workload hybrid --ticks 64 --out artifacts/board.json
    python -m repro_torch.obs.trace --fleet spans.json.gz \\
        --out artifacts/fleet.json
"""
from __future__ import annotations

import gzip as _gzip
import json
from pathlib import Path

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pop_of_pe(program) -> list:
    names = [""] * program.n_pes
    for name, sl in program.pe_slices.items():
        for p in range(sl.start, sl.stop):
            names[p] = name
    return names


def _counter(events: list, pid: int, name: str, series, t_sys_s: float,
             unit: str = "", scale: float = 1.0) -> None:
    """Delta-encoded counter track: one event at t=0, then only on a
    change of value (Perfetto renders counters as step functions)."""
    label = f"{name} [{unit}]" if unit else name
    prev = None
    for t, v in enumerate(_np(series)):
        v = float(v) * scale
        if prev is not None and v == prev:
            continue
        events.append({"ph": "C", "pid": pid, "tid": 0, "name": label,
                       "ts": t * t_sys_s * 1e6, "args": {name: v}})
        prev = v


def trace_events(program, recs: dict, t_sys_s: float = 1e-3,
                 pes=None) -> dict:
    """The trace-event payload of a program and its run's records.

    ``pes`` restricts the per-PE tracks to a subset of logical PE ids
    (the NoC and learn tiers always export); default every PE."""
    pl = _np(recs["pl"])                           # (T, P)
    packets = _np(recs["packets"])                 # (T, P)
    T, P = pl.shape
    tick_us = t_sys_s * 1e6
    pops = _pop_of_pe(program)
    chip_of_pe = getattr(program, "chip_of_pe", None)
    board = getattr(program, "board", None)
    coords = np.asarray(getattr(program, "coords_local", None)
                        if chip_of_pe is not None else program.coords)
    pe_ids = range(P) if pes is None else [int(p) for p in pes]

    events: list = []

    # -- NoC process: per-tier flit counters + traffic energy --------------
    NOC_PID = 0
    events.append({"ph": "M", "pid": NOC_PID, "name": "process_name",
                   "args": {"name": "NoC"}})
    link_flits = _np(recs["link_flits"])                     # (T, L)
    for tier, mask in program.noc.tier_masks().items():
        _counter(events, NOC_PID, f"flits/{tier}",
                 link_flits @ np.asarray(mask, link_flits.dtype), t_sys_s)
    if "e_noc_xchip" in recs:
        _counter(events, NOC_PID, "e_noc_xchip", recs["e_noc_xchip"],
                 t_sys_s, unit="pJ", scale=1e12)
    _counter(events, NOC_PID, "e_noc", recs["e_noc"], t_sys_s,
             unit="pJ", scale=1e12)

    # -- learn process: per-slot update magnitude --------------------------
    slots = getattr(program, "learn_slots", ())
    if slots and "e_learn" in recs:
        LEARN_PID = 1
        events.append({"ph": "M", "pid": LEARN_PID, "name": "process_name",
                       "args": {"name": "learn"}})
        _counter(events, LEARN_PID, "e_learn",
                 _np(recs["e_learn"]).sum(axis=-1), t_sys_s,
                 unit="pJ", scale=1e12)
        for s in slots:
            key = f"learn/{s.name}/dw"
            if key in recs:
                _counter(events, LEARN_PID, f"dw {s.name}", recs[key],
                         t_sys_s)

    # -- per-chip processes, per-PE threads --------------------------------
    PE_PID0 = 2
    if board is not None and chip_of_pe is not None:
        chips = np.asarray(chip_of_pe)
        for c in sorted(set(int(v) for v in chips)):
            cx, cy = board.chip_coord(c)
            events.append({"ph": "M", "pid": PE_PID0 + c,
                           "name": "process_name",
                           "args": {"name": f"chip {c} ({cx},{cy})"}})
    else:
        chips = np.zeros(P, np.int64)
        events.append({"ph": "M", "pid": PE_PID0, "name": "process_name",
                       "args": {"name": "chip"}})

    for p in pe_ids:
        pid = PE_PID0 + int(chips[p])
        x, y = (int(coords[p][0]), int(coords[p][1]))
        events.append({"ph": "M", "pid": pid, "tid": p,
                       "name": "thread_name",
                       "args": {"name": f"PE {p} {pops[p]}@({x},{y})"}})
        # active-tick slices: the workload's firing/streaming rhythm
        for t in np.flatnonzero(packets[:, p] > 0):
            events.append({
                "ph": "X", "pid": pid, "tid": p, "cat": "compute",
                "name": f"{pops[p]} tick", "ts": float(t) * tick_us,
                "dur": tick_us,
                "args": {"packets": int(packets[t, p]),
                         "pl": int(pl[t, p])}})
        # DVFS trajectory: one delta-encoded counter track per PE
        _counter(events, pid, f"pl PE{p}", pl[:, p], t_sys_s)

    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"n_pes": P, "n_ticks": T,
                          "tick_ms": t_sys_s * 1e3}}


def _counter_at(events: list, pid: int, name: str, samples,
                unit: str = "") -> None:
    """Delta-encoded counter track over irregular (ts_us, value) samples
    — the span-log counters are per-round (variable wall-clock spacing),
    unlike the tick-indexed series ``_counter`` handles."""
    label = f"{name} [{unit}]" if unit else name
    prev = None
    for ts, v in samples:
        v = float(v)
        if prev is not None and v == prev:
            continue
        events.append({"ph": "C", "pid": pid, "tid": 0, "name": label,
                       "ts": float(ts), "args": {name: v}})
        prev = v


def fleet_trace_events(payload: dict) -> dict:
    """Render a served-fleet span log (``SpanLog.payload()`` /
    ``load_spans``) as trace events.

    Three processes: *fleet* (queue-depth / width / active / batched
    tick-time / round-energy counter tracks + SLO-violation instants),
    *slots* (one thread per fleet slot, an "X" slice per resident round
    named by the session occupying it), and *requests* (one thread per
    session: its queued and resident phases as slices, preempt/complete
    as instant markers) — the request-lifecycle view of the serve.
    """
    events: list = []
    counters = payload.get("counters", [])
    spans = payload.get("events", [])

    FLEET_PID, SLOT_PID, REQ_PID = 0, 1, 2
    events.append({"ph": "M", "pid": FLEET_PID, "name": "process_name",
                   "args": {"name": "fleet"}})
    events.append({"ph": "M", "pid": SLOT_PID, "name": "process_name",
                   "args": {"name": "slots"}})
    events.append({"ph": "M", "pid": REQ_PID, "name": "process_name",
                   "args": {"name": "requests"}})

    # -- fleet counter tracks (per-round samples, wall-clock spaced) -------
    tracks = (("queue_depth", ""), ("width", ""), ("n_active", ""),
              ("tick_us", "us"), ("energy_j", "J"), ("completed", ""))
    for key, unit in tracks:
        samples = [(c["t_s"] * 1e6, c[key]) for c in counters if key in c]
        if samples:
            _counter_at(events, FLEET_PID, key, samples, unit=unit)

    # -- per-slot round slices + per-request lifecycle ---------------------
    slots_seen: set = set()
    queued_at: dict = {}           # sid -> enqueue t_s
    resident_at: dict = {}         # sid -> admit/resume t_s
    req_tids: dict = {}            # sid -> stable tid on the request proc

    def req_tid(sid):
        if sid not in req_tids:
            req_tids[sid] = len(req_tids)
            events.append({"ph": "M", "pid": REQ_PID,
                           "tid": req_tids[sid], "name": "thread_name",
                           "args": {"name": f"sid {sid}"}})
        return req_tids[sid]

    for e in spans:
        kind, sid = e["kind"], e["sid"]
        t_us = e["t_s"] * 1e6
        args = e.get("args", {})
        if kind == "slo":
            events.append({"ph": "i", "pid": FLEET_PID, "tid": 0,
                           "name": f"SLO {args.get('rule', '?')}",
                           "ts": t_us, "s": "p", "cat": "slo",
                           "args": args})
            continue
        if sid < 0:
            continue
        if kind == "enqueue":
            queued_at[sid] = e["t_s"]
            req_tid(sid)
        elif kind in ("admit", "resume"):
            t0 = queued_at.pop(sid, None)
            if t0 is not None and e["t_s"] > t0:
                events.append({"ph": "X", "pid": REQ_PID,
                               "tid": req_tid(sid), "cat": "queued",
                               "name": "queued", "ts": t0 * 1e6,
                               "dur": (e["t_s"] - t0) * 1e6})
            resident_at[sid] = e["t_s"]
        elif kind == "round":
            slot = int(args.get("slot", 0))
            if slot not in slots_seen:
                slots_seen.add(slot)
                events.append({"ph": "M", "pid": SLOT_PID, "tid": slot,
                               "name": "thread_name",
                               "args": {"name": f"slot {slot}"}})
            start = args.get("start_s", e["t_s"])
            dur = max(args.get("dur_s", 0.0), 1e-7)
            events.append({"ph": "X", "pid": SLOT_PID, "tid": slot,
                           "cat": "round", "name": f"sid {sid}",
                           "ts": start * 1e6, "dur": dur * 1e6,
                           "args": {"width": args.get("width"),
                                    "ticks": args.get("ticks")}})
        elif kind in ("preempt", "suspend", "complete"):
            t0 = resident_at.pop(sid, None)
            if t0 is not None and e["t_s"] > t0:
                events.append({"ph": "X", "pid": REQ_PID,
                               "tid": req_tid(sid), "cat": "resident",
                               "name": "resident", "ts": t0 * 1e6,
                               "dur": (e["t_s"] - t0) * 1e6})
            events.append({"ph": "i", "pid": REQ_PID, "tid": req_tid(sid),
                           "name": kind, "ts": t_us, "s": "t",
                           "cat": "lifecycle", "args": args})

    meta = dict(payload.get("meta", {}))
    meta["n_requests"] = len(req_tids)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": meta}


def _write_payload(path, payload: dict, compress: bool = False) -> Path:
    """Write a trace-event payload, gzipped when ``compress`` is set or
    the path already ends in ``.gz`` (Perfetto loads both)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = json.dumps(payload)
    if compress or path.suffix == ".gz":
        if path.suffix != ".gz":
            path = path.with_suffix(path.suffix + ".gz")
        path.write_bytes(_gzip.compress(blob.encode()))
    else:
        path.write_text(blob)
    print(f"# wrote {len(payload['traceEvents'])} trace events to {path} "
          f"(load at https://ui.perfetto.dev)")
    return path


def write_trace(path, program, recs: dict, t_sys_s: float = 1e-3,
                pes=None, compress: bool = False) -> Path:
    """Export a run to ``path`` as Perfetto-loadable trace-event JSON,
    gzipped when ``compress`` is set or the path ends in ``.gz``."""
    payload = trace_events(program, recs, t_sys_s=t_sys_s, pes=pes)
    return _write_payload(path, payload, compress=compress)


def write_fleet_trace(path, span_payload: dict,
                      compress: bool = False) -> Path:
    """Export a served-fleet span log as Perfetto trace-event JSON."""
    return _write_payload(path, fleet_trace_events(span_payload),
                          compress=compress)


def main(argv=None) -> int:
    """Run a small board workload and export its Perfetto trace, or,
    with ``--fleet SPANLOG``, render a recorded serving span log."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--board", default="2x2",
                    help="chip grid, e.g. 2x2 (default)")
    ap.add_argument("--chip", default="4x2", help="per-chip QPE mesh")
    ap.add_argument("--workload", default="hybrid",
                    choices=("hybrid", "synfire", "dnn"))
    ap.add_argument("--ticks", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--fleet", default=None, metavar="SPANLOG",
                    help="render a serving span log (SpanLog.write "
                         "output, .json or .json.gz) instead of running "
                         "a board workload")
    ap.add_argument("--gzip", action="store_true",
                    help="gzip the output trace (.gz appended if absent)")
    ap.add_argument("--out", default="artifacts/board.perfetto-trace.json")
    args = ap.parse_args(argv)

    if args.fleet is not None:
        from repro_torch.obs.spans import load_spans
        write_fleet_trace(args.out, load_spans(args.fleet),
                          compress=args.gzip)
        return 0

    from repro_torch import resolve_device
    from repro_torch.board import BoardSpec, compile_board
    from repro_torch.chip.chip import ChipSim
    from repro_torch.chip.workloads import (dnn_board_graph,
                                            hybrid_farm_board_graph,
                                            synfire_board_graph)
    dev = resolve_device(args.device)
    board = BoardSpec.parse(args.board, chip=args.chip)
    if args.workload == "dnn":
        graph = dnn_board_graph(board)
    else:
        build = (hybrid_farm_board_graph if args.workload == "hybrid"
                 else synfire_board_graph)
        graph = build(board, device=dev)
    prog = compile_board(graph, board)
    recs = ChipSim(prog, device=dev).run(args.ticks, seed=args.seed)
    write_trace(args.out, prog, recs, compress=args.gzip)
    return 0


if __name__ == "__main__":                                # pragma: no cover
    raise SystemExit(main())
