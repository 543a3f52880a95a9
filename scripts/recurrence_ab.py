#!/usr/bin/env python3
"""Time the recurrence kernels of the ``repro_torch`` package found on the
path at chip_smoke.py's rows: ``linear_scan`` at new-s (RecurrentGemma-
2B's prefill, 4 x 4096 x 2560 float32) and new-s' (its decode step, S =
1), ``wkv6`` at new-w (RWKV-6-1.6B's prefill, 4 x 4096 x 32 heads of 64,
bf16) and new-w' (S = 1), and new-w at the strongest decay range of the
recurrent tests (``--strong``).  Inputs come from a seeded generator in
the models' ranges (Griffin's a in [0.9, 0.999]; RWKV's log decay
-exp(U(-6, 1)), the strong range -exp(U(-8, 3))).  Each launch is timed
cold (the L2 cache flushed before it) with CUDA events, ``--iters``
times; one JSON line with the mean and the median in µs, the card's name
and power limit.

Two trees of the port compare in one call on one card, in turns:

    for t in parent change change parent; do
        PYTHONPATH=$t/src python3 scripts/recurrence_ab.py --label $t
    done
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess

import torch

FLUSH_BYTES = 256 << 20           # five times the H100's 50 MB L2


def cold_us(fn, iters: int, flush) -> list:
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    return times


def scan_args(B, S, W, gen, dev):
    xi, xa, u = (torch.randn(B, S, W, generator=gen, device=dev)
                 for _ in range(3))
    a0 = torch.empty(W, device=dev).uniform_(0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(a0) / 8.0))
    return xi, xa, u, lam, torch.randn(B, W, generator=gen, device=dev)


def wkv_args(B, S, H, D, gen, dev, decay=(-6.0, 1.0)):
    r, k, v = (torch.randn(B, S, H, D, generator=gen, device=dev)
               .bfloat16() for _ in range(3))
    lw = -torch.exp(torch.empty(B, S, H, D, device=dev)
                    .uniform_(*decay, generator=gen))
    u = 0.5 * torch.randn(H, D, generator=gen, device=dev)
    return r, k, v, lw, u, torch.randn(B, H, D, D, generator=gen,
                                       device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--strong", action="store_true",
                    help="also new-w at log decays -exp(U(-8, 3))")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("recurrence_ab: no CUDA device")
    from repro_torch.kernels import linear_scan, wkv6
    dev = torch.device("cuda")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev).zero_
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {"new-s": (linear_scan, scan_args(4, 4096, 2560, gen, dev)),
             "new-s'": (linear_scan, scan_args(4, 1, 2560, gen, dev)),
             "new-w": (wkv6, wkv_args(4, 4096, 32, 64, gen, dev)),
             "new-w'": (wkv6, wkv_args(4, 1, 32, 64, gen, dev))}
    if args.strong:
        cases["new-w strong"] = (wkv6, wkv_args(4, 4096, 32, 64, gen, dev,
                                                (-8.0, 3.0)))
    rows = {}
    for name, (fn, fargs) in cases.items():
        out = fn(*fargs)
        t = cold_us(lambda: fn(*fargs), args.iters, flush)
        rows[name] = dict(shape=list(fargs[0].shape),
                          mean_us=statistics.fmean(t),
                          median_us=statistics.median(t),
                          finite=all(math.isfinite(float(o.abs().max()))
                                     for o in out))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
