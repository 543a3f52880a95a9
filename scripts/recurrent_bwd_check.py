#!/usr/bin/env python3
"""A quick card check of the recurrent archs' backward kernels:
``linear_scan_bwd_kernel`` (``csrc/linear_scan.cu``), ``wkv6_bwd_kernel``
(``csrc/wkv6_bwd.cu``) and flash attention's d256 route
(``flash_bwd_dkdv_kernel`` and ``flash_bwd_dq_kernel`` at D 256,
``csrc/flash_attn_bwd.cu``):

    PYTHONPATH=src python3 scripts/recurrent_bwd_check.py

Builds the kernel library and prints each new kernel's registers and
spills from the build's ``-Xptxas -v``; then, for a few shapes each (the
scan at ragged sizes, 8 x 128 and 1 x 4096 x 2560 with beta's clamp on
two channels; WKV at head sizes 8-64, float32 and bf16, S 1-4096, the
strongest decays at RWKV-6-1.6B's 1 x 4096 x 32 x 64; flash at D 160-256,
H over H_kv 1-10, windows 0-2048, both dtypes), holds the kernel against
its plain version on the card (each gradient's largest error over its
largest magnitude), two calls bit for bit, and WKV's dstate0 against the
plain version's bit for bit, with the mean ms a call over warm calls
(CUDA events).  One line a shape, then ``OK``; a failed check raises.
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

    for B, S, H, D, dt, strong in (
            (2, 100, 4, 64, torch.float32, False),
            (2, 100, 4, 64, torch.bfloat16, False),
            (1, 33, 2, 8, torch.float32, False),
            (1, 50, 3, 16, torch.float32, False),
            (1, 70, 2, 32, torch.bfloat16, True),
            (1, 1, 2, 64, torch.float32, False),
            (1, 4096, 32, 64, torch.bfloat16, True)):
        r, k, v = (rnd(B, S, H, D).to(dt) for _ in range(3))
        lw = -torch.exp(rnd(B, S, H, D) * 2.0 if strong
                        else rnd(B, S, H, D) * 0.5 - 1.0)
        u, s0 = rnd(H, D), rnd(B, H, D, D)
        dy, ds = rnd(B, S, H, D), rnd(B, H, D, D)
        args = (r, k, v, lw, u, s0, dy, ds)
        got, again = wkv6_bwd(*args), wkv6_bwd(*args)
        want = wkv6_bwd_ref(*args)
        errs = [rel(g, w) for g, w in zip(got, want)]
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        assert torch.equal(got[5], want[5])
        # bf16 dr, dk, dv: one rounding of their dtype
        assert max(errs[3:]) <= WKV_TOL and max(errs[:3]) <= (
            2.0 ** -7 if dt == torch.bfloat16 else WKV_TOL), errs
        print(f"wkv {(B, S, H, D)} {str(dt)[6:]} rel {errs} ms "
              f"{warm_ms(lambda: wkv6_bwd(*args), 2):.4f}")
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
        assert route == "d256"
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
