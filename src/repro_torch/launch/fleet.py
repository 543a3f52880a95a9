"""Neuromorphic fleet launcher: batched chip or board instances serving a
Poisson session stream with queue-driven (DVFS-style) fleet widths, on
one CUDA device unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.fleet --scenario adaptive \\
        --fleet 64 --sessions 96 --rate 8

Add ``--board 2x1`` to compile the served program across a chip grid,
and ``--ckpt-dir PATH`` to checkpoint evicted sessions to disk instead
of in-memory snapshots.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device
from repro_torch.core.dvfs import QueueDVFS
from repro_torch.serve.fleet import SCENARIOS, FleetEngine, PoissonTraffic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="adaptive",
                    choices=sorted(SCENARIOS))
    ap.add_argument("--fleet", type=int, default=16,
                    help="top batch level (ladder = fleet/4, fleet/2, fleet)")
    ap.add_argument("--sessions", type=int, default=24)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="expected session arrivals per scheduling round")
    ap.add_argument("--round-ticks", type=int, default=64)
    ap.add_argument("--min-ticks", type=int, default=128)
    ap.add_argument("--max-ticks", type=int, default=384)
    ap.add_argument("--board", default=None,
                    help="compile across a chip grid, e.g. 2x1")
    ap.add_argument("--chip", default="2x2")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint evicted sessions here (else in-memory)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    sc = SCENARIOS[args.scenario](device=dev)
    board = None
    if args.board:
        from repro_torch.board import BoardSpec
        board = BoardSpec.parse(args.board, chip=args.chip)
    lo, mid = max(1, args.fleet // 4), max(1, args.fleet // 2)
    eng = FleetEngine(
        sc, round_ticks=args.round_ticks, board=board,
        ckpt_dir=args.ckpt_dir, keep_outputs=False, device=dev,
        dvfs=QueueDVFS(thresholds=(max(2, lo // 2), max(3, mid // 2)),
                       batch_levels=(lo, mid, args.fleet)))
    traffic = PoissonTraffic(rate=args.rate, n_sessions=args.sessions,
                             tick_range=(args.min_ticks, args.max_ticks),
                             seed=args.seed)
    t0 = time.time()
    stats = eng.serve(traffic)["stats"]
    dt = time.time() - t0
    where = f"board {args.board}" if args.board else "chip"
    print(f"served {stats['completed']} {args.scenario} sessions on {where} "
          f"({dev}) in {dt:.1f}s ({stats['sessions_per_s']:.1f} "
          f"sessions/s)")
    print(f"rounds={stats['rounds']} fleet widths={stats['width_hist']} "
          f"(queue-DVFS levels: {eng.dvfs.batch_levels})")
    print(f"request p50/p99 {stats['request_latency_s']['p50']:.2f}/"
          f"{stats['request_latency_s']['p99']:.2f}s, "
          f"{stats['joules_per_request'] * 1e3:.2f} mJ/request, "
          f"{stats['preemptions']} preemptions")
    return stats


if __name__ == "__main__":
    main()
