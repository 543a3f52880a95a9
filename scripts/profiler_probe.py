#!/usr/bin/env python3
"""Does torch.profiler keep every kernel record of a short profile after
long ones?  On the card:

    python3 scripts/profiler_probe.py

A short profile is 10 calls of four elementwise kernels (a 256 MB
fill, as chip_smoke.py's L2 flush, then three on a 2M-element tensor);
a long one is 20000 tiny kernels.  Prints, as JSON lines, the records a
short profile kept of each kernel (5 profiles a line) in a fresh
process, after each of three long profiles, and then with each remedy
tried in chip_smoke.py's ``device_kernels``: kernels launched inside the
profile before the window (``warm``), a pause before it (``pause``, s)
or after it (``post``, s), marker kernels after it (``burst``), CUDA
activity alone (``cpu`` false).  Needs no kernel build.
"""
from __future__ import annotations

import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe: no CUDA device")
    dev = torch.device("cuda")
    x = torch.randn(8, 128, 2048, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    small = torch.randn(64, device=dev)

    def call():
        flush.zero_()
        return torch.tanh(x * 2.0 + 1.0)

    def many():
        for _ in range(200):
            small.add_(1.0)

    def session(fn, n, cpu=True, warm=0, pause=0.0, post=0.0, burst=0):
        """{kernel: records} of a profile of n calls of fn."""
        fn()
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu
                                          else [])
        with profile(activities=acts) as prof:
            for _ in range(warm):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            time.sleep(pause)
            for _ in range(n):
                fn()
            for _ in range(burst):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            time.sleep(post)
        return {e.key: e.count for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")
                and e.self_device_time_total > 0
                and "spin_kernel" not in e.key}

    def report(tag, **kw):
        kept = [sorted(session(call, 10, **kw).values()) for _ in range(5)]
        print(json.dumps({"tag": tag, **kw, "records_of_10_calls": kept}),
              flush=True)

    report("fresh")
    for i in range(3):
        print(json.dumps({"long_profile": i, "records":
                          sum(session(many, 100).values())}), flush=True)
        report(f"after long profile {i}")
    report("cuda activity alone", cpu=False)
    report("pause before", pause=0.2)
    report("pause after", post=0.2)
    report("markers after", burst=64)
    report("markers before", warm=64)
    report("markers before", warm=512)
    print(json.dumps({"card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
