#!/usr/bin/env python3
"""A quick card check of the recurrent archs' backward kernels:
``linear_scan_bwd_kernel`` (``csrc/linear_scan.cu``), WKV-6's backward
on both routes (``bwd_route``: the chunked ``wkv6_bwd_state_kernel``,
past 3 chunks ``wkv6_bwd_scan_kernel``, and ``wkv6_bwd_chunk_kernel`` of
``csrc/wkv6_bwd_chunked.cu`` at D 64 and S >= 64, else the walk
``wkv6_bwd_kernel`` of ``csrc/wkv6_bwd.cu``) and flash attention's backward
at D 256 (bf16 on the wgmma_d256 route, ``csrc/flash_attn_bwd_d256.cu``;
float32 on the d256 route, ``flash_bwd_dkdv_kernel`` and
``flash_bwd_dq_kernel`` at D 256 of ``csrc/flash_attn_bwd.cu``):

    PYTHONPATH=src python3 scripts/recurrent_bwd_check.py

Builds the kernel library and prints each new kernel's registers and
spills from the build's ``-Xptxas -v``; then, for a few shapes each (the
scan at ragged sizes, 8 x 128 and 1 x 4096 x 2560 with beta's clamp on
two channels; WKV at head sizes 8-64, float32 and bf16, S 1-4096 by
route, the strongest decays on the chunked route's ragged and long
shapes, the launcher's 8 x 128 x 32 x 64 and RWKV-6-1.6B's 1 x 4096 x 32
x 64, with the walk's time on the chunked shapes' inputs; flash at D 160-256,
H over H_kv 1-10, windows 0-2048, both dtypes), holds the kernel against
its plain version on the card (each gradient's largest error over its
largest magnitude), two calls bit for bit, and WKV's route and launches
(``bwd_launches``) and, on the walk, its dstate0 against the plain
version's bit for bit, with the mean ms a call over warm calls (CUDA
events) and, on the chunked route, each kernel's device µs a call
(torch.profiler, warm).  One line a shape, then ``OK``; a failed check raises.

    PYTHONPATH=src python3 scripts/recurrent_bwd_check.py --scans

measures instead the rule ``FUSED_SCAN_CHUNKS`` of the chunked WKV
backward (``kernels/wkv6/ops.py``): for batch x heads 8, 64 and 256 (32
heads of 64 at batches 1-8, bf16) and N = 2-12 chunks of 64, each call
with the scans fused into the state kernel's last blocks and with the
scan kernel of their own, both checked against each other bit for bit,
the L2 evicted before each call: the median of 20 calls' CUDA-event ms
(launches, the counter's memset and du's sum included) and the device µs
a call by kernel (torch.profiler, 10 calls).  One line a shape, then
``OK``.
"""
from __future__ import annotations

import re
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    flash_attention_bwd_ref)
from repro_torch.kernels.linear_scan import (  # noqa: E402
    linear_scan, linear_scan_bwd, linear_scan_bwd_ref)
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6_bwd, wkv6_bwd_ref  # noqa: E402

NEW_KERNELS = (r"linear_scan_bwd|wkv6_bwd|flash_bwd_dkdv_kernelI\w*Li256|"
               r"flash_bwd_dq_kernelI\w*Li256")
SCAN_TOL, WKV_TOL = 2.0 ** -18, 2.0 ** -16
FLASH_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -14}


def rel(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def warm_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(True), torch.cuda.Event(True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def device_us(fn, n: int) -> dict:
    """Device µs a call of each kernel ``fn`` launches, over n warm calls
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: round(e.self_device_time_total / n, 1)
            for e in prof.key_averages() if e.self_device_time_total > 0}


def cold_ms(fn, n: int, flush) -> float:
    """Median CUDA-event ms of ``fn`` over n calls, ``flush()`` before
    each."""
    times = []
    for _ in range(n + 1):
        flush()
        t0, t1 = torch.cuda.Event(True), torch.cuda.Event(True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return sorted(times[1:])[n // 2]


def scan_sweep(dev, rnd) -> None:
    """The fused and separate scans of the chunked WKV backward side by
    side (see the module's docstring)."""
    flush = torch.empty(50 * 2 ** 20 * 5 // 4, dtype=torch.int32,
                        device=dev).zero_
    for B, H in ((2, 4), (2, 32), (8, 32)):
        for N in (2, 3, 4, 5, 6, 8, 10, 12):
            S, D = N * wkv_ops.CHUNK, wkv_ops.CHUNKED_D
            r, k, v = (rnd(B, S, H, D).to(torch.bfloat16) for _ in range(3))
            lw = -torch.exp(rnd(B, S, H, D) * 0.5 - 1.0)
            args = (r, k, v, lw, rnd(H, D), rnd(B, H, D, D),
                    rnd(B, S, H, D), rnd(B, H, D, D))
            line = f"scans B {B} H {H} BH {B * H} N {N} S {S} rule " \
                   f"{'fused' if N <= wkv_ops.FUSED_SCAN_CHUNKS else 'separate'}"
            outs = {}
            for fused in (True, False):
                call = lambda: wkv_ops._bwd_kernels("chunked", *args,
                                                    fused=fused)
                outs[fused] = call()
                ms = cold_ms(call, 20, flush)
                us = device_us(lambda: (flush(), call()), 10)
                us = {re.sub(r"^void |[<(].*$", "", key): t
                      for key, t in us.items() if "FillFunctor" not in key}
                line += (f" | {'fused' if fused else 'separate'} ms "
                         f"{ms:.4f} device us {sum(us.values()):.1f} {us}")
            assert all(torch.equal(a, b) for a, b in zip(outs[True],
                                                          outs[False]))
            print(line, flush=True)
            del args, outs, r, k, v, lw
    print("OK")


def ptxas_lines() -> None:
    log = _build.build_log.splitlines()
    for i, line in enumerate(log):
        if "Compiling entry function" in line and re.search(NEW_KERNELS,
                                                            line):
            name = re.search(r"'(\w+)'", line).group(1)
            use = " ".join(x.strip() for x in log[i + 1:i + 3]
                           if "spill" in x or "Used" in x)
            print(f"ptxas {name}: {use}")


def main() -> int:
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    _build.library()
    print(f"build_s {time.time() - t0:.1f}")
    ptxas_lines()
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    if sys.argv[1:] == ["--scans"]:
        scan_sweep(dev, rnd)
        return 0

    for B, S, W in ((2, 77, 70), (8, 128, 2560), (1, 4096, 2560)):
        xi, xa, u, dy = (rnd(B, S, W) for _ in range(4))
        lam, h0, dh = rnd(W), rnd(B, W), rnd(B, W)
        lam[:2] = -40.0
        y, _ = linear_scan(xi, xa, u, lam, h0)
        args = (xi, xa, u, lam, h0, y, dy, dh)
        got, again = linear_scan_bwd(*args), linear_scan_bwd(*args)
        errs = [rel(g, w) for g, w in zip(got, linear_scan_bwd_ref(*args))]
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        assert max(errs) <= SCAN_TOL, errs
        print(f"scan {(B, S, W)} rel {errs} ms "
              f"{warm_ms(lambda: linear_scan_bwd(*args), 10):.4f}")

    f32, bf16 = torch.float32, torch.bfloat16
    for B, S, H, D, dt, strong in (
            (1, 33, 2, 8, f32, False), (1, 50, 3, 16, f32, False),
            (1, 70, 2, 32, bf16, True), (1, 1, 2, 64, f32, False),
            (1, 63, 2, 64, f32, True),
            (1, 64, 2, 64, f32, True), (1, 65, 2, 64, bf16, True),
            (2, 100, 4, 64, f32, False), (2, 100, 4, 64, bf16, False),
            (2, 200, 4, 64, f32, True), (1, 1000, 2, 64, bf16, True),
            (8, 128, 32, 64, bf16, False),
            (1, 4096, 32, 64, bf16, True), (1, 4096, 32, 64, f32, False)):
        r, k, v = (rnd(B, S, H, D).to(dt) for _ in range(3))
        lw = -torch.exp(rnd(B, S, H, D) * 2.0 if strong
                        else rnd(B, S, H, D) * 0.5 - 1.0)
        u, s0 = rnd(H, D), rnd(B, H, D, D)
        dy, ds = rnd(B, S, H, D), rnd(B, H, D, D)
        args = (r, k, v, lw, u, s0, dy, ds)
        route = wkv_ops.bwd_route(S, D)
        before = wkv6_bwd.launches
        got = wkv6_bwd(*args)
        launched = wkv6_bwd.launches - before
        again = wkv6_bwd(*args)
        want = wkv6_bwd_ref(*args)
        errs = [rel(g, w) for g, w in zip(got, want)]
        assert launched == wkv_ops.bwd_launches(S, D), (route, launched)
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        if route == "walk":
            assert torch.equal(got[5], want[5])
        # bf16 dr, dk, dv: one rounding of their dtype
        assert max(errs[3:]) <= WKV_TOL and max(errs[:3]) <= (
            2.0 ** -7 if dt == torch.bfloat16 else WKV_TOL), errs
        ms = warm_ms(lambda: wkv6_bwd(*args), 3)
        walk = split = ""
        if route == "chunked":
            walk_ms = warm_ms(lambda: wkv_ops._bwd_kernels("walk", *args), 2)
            walk = f" walk ms {walk_ms:.4f}"
            split = f" device us {device_us(lambda: wkv6_bwd(*args), 5)}"
        print(f"wkv {(B, S, H, D)} {str(dt)[6:]} {route} {launched} "
              f"launches rel {errs} ms {ms:.4f}{walk}{split}", flush=True)
        del want

    for B, S, H, Hkv, D, dt, win in (
            (1, 300, 10, 1, 256, torch.bfloat16, 64),
            (1, 300, 10, 1, 256, torch.float32, 64),
            (2, 200, 4, 4, 256, torch.bfloat16, 0),
            (2, 200, 4, 4, 256, torch.float32, 0),
            (1, 129, 4, 2, 160, torch.bfloat16, 0),
            (1, 129, 4, 2, 200, torch.float32, 16),
            (1, 4096, 10, 1, 256, torch.bfloat16, 2048),
            (1, 4096, 10, 1, 256, torch.float32, 2048)):
        q, do = (rnd(B, S, H, D).to(dt) for _ in range(2))
        k, v = (rnd(B, S, Hkv, D).to(dt) for _ in range(2))
        o, lse = flash_ops._forward(q, k, v, True, win, True)
        call = lambda: flash_ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                     window=win)
        before = flash_ops.flash_attention_bwd.launches
        got = call()
        launched = flash_ops.flash_attention_bwd.launches - before
        again = call()
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, window=win)
        errs = [rel(g, w) for g, w in zip(got, want)]
        route = flash_ops.bwd_route(q, k, v, o, do)
        assert route == ("wgmma_d256" if dt == torch.bfloat16 else "d256")
        assert launched == flash_ops.bwd_launches(q, k, v, o, do)
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        assert max(errs) <= FLASH_TOL[dt], errs
        print(f"flash {(B, S, H, Hkv, D)} {str(dt)[6:]} window {win} "
              f"{route} {launched} launches rel {errs} ms "
              f"{warm_ms(call, 3):.4f}")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
