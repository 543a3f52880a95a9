"""Rows and timing shared by the port's paper benchmarks.

Rows print as the reference's benchmarks print them (``name,us,derived``)
and are returned as dicts that also carry the parsed numbers and the
device the call ran on.  This module stands alone: the reference's
``benchmarks/common.py`` imports JAX.
"""
from __future__ import annotations

import time

import torch


def emit(name: str, us: float, derived: str, device, **values) -> dict:
    """Print one row and return it with ``values`` and the device."""
    print(f"{name},{us:.1f},{derived}", flush=True)
    return {"name": name, "us_per_call": us, "derived": derived,
            "device": str(device), "values": values}


def time_call(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median µs of one call of ``fn(*args)``.  On a CUDA device the
    card's time between CUDA events around the call; on the CPU the host
    clock."""
    dev = args[0].device
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e6)
    return sorted(times)[len(times) // 2]


def check_equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel output != plain version")
