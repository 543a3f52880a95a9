#!/usr/bin/env python3
"""Time ``flash_attention_kernel`` of the ``repro_torch`` package found on
the path, causal and without a window, at chip_smoke.py's flash row
shapes: 8 (1 x 4096, 32 x 128, bf16), 8'' (4 x 4096, the LM prefill's
batch) and 8' (float32, 1 x 1024).  Each launch is timed cold (the L2
cache flushed before it) with CUDA events, ``--iters`` times; one JSON
line with the mean and the median in ms, the card's name and power limit.

Two trees of the port compare in one call on one card, in turns:

    for t in parent change change parent; do
        PYTHONPATH=$t/src python3 scripts/flash_ab.py --label $t
    done
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

SHAPES = {"8": ((1, 4096, 32, 128), torch.bfloat16),
          "8''": ((4, 4096, 32, 128), torch.bfloat16),
          "8'": ((1, 1024, 32, 128), torch.float32)}
FLUSH_BYTES = 256 << 20           # five times the H100's 50 MB L2


def cold_ms(fn, iters: int, flush) -> list:
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
        times.append(a.elapsed_time(b))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA device")
    from repro_torch.kernels import flash_attention_kernel
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev).zero_
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name, (shape, dtype) in SHAPES.items():
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        t = cold_ms(lambda: flash_attention_kernel(q, k, v), args.iters,
                    flush)
        rows[name] = dict(shape=list(shape),
                          dtype=str(dtype).removeprefix("torch."),
                          mean_ms=statistics.fmean(t),
                          median_ms=statistics.median(t))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
