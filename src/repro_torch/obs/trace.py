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

Also a command line, which runs a small board workload and writes its
trace:

    python -m repro_torch.obs.trace --board 2x2 --chip 4x2 \\
        --workload hybrid --ticks 64 --out artifacts/board.json
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


def write_trace(path, program, recs: dict, t_sys_s: float = 1e-3,
                pes=None, compress: bool = False) -> Path:
    """Export a run to ``path`` as Perfetto-loadable trace-event JSON,
    gzipped when ``compress`` is set or the path ends in ``.gz``."""
    payload = trace_events(program, recs, t_sys_s=t_sys_s, pes=pes)
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


def main(argv=None) -> int:
    """Run a small board workload and export its Perfetto trace."""
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
    ap.add_argument("--gzip", action="store_true",
                    help="gzip the output trace (.gz appended if absent)")
    ap.add_argument("--out", default="artifacts/board.perfetto-trace.json")
    args = ap.parse_args(argv)

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
