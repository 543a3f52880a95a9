#!/usr/bin/env python3
"""A quick card check of flash attention's backward kernels
(``csrc/flash_attn_bwd.cu``) beside the forward's log-sum-exp:

    PYTHONPATH=src python3 scripts/flash_bwd_check.py

Builds the kernel library, prints the backward kernels' registers and
spills from the build's ``-Xptxas -v`` and any ptxas note (C7510-C7515)
that serialises a kernel's wgmma, then for a few shapes (bf16 and
float32, D 40-128, causal, full and windows, H over H_kv 1-16, S at and
around the 128-row blocks of the wgmma route, ragged S, an unaligned
bf16 view) holds ``flash_attention_bwd`` against
``flash_attention_bwd_ref`` on the card (each gradient's largest error
over the larger of its own and dV's largest magnitude, below 2^-6 in
bf16 and 1e-5 in float32), the
forward's lse against the plain version's, the forward's output with lse
bit for bit the call's without, and two backward calls bit for bit the
same, each line with its route (``bwd_route``) and launches.  Last,
Qwen1.5-4B's layer at batch 1 x 4096 (20 heads of 128, bf16, causal):
the backward's mean ms a call over 10 warm calls (CUDA events) beside
one PyTorch ``scaled_dot_product_attention`` forward and backward; and
at chip_smoke.py's backward rows (bwd-b, bwd-g, bwd-w, bwd-m, bwd-f)
each kernel's mean device µs a call, the L2 cache flushed before each
of 10 calls (torch.profiler).  One JSON line a shape, then ``OK`` or
``FAIL``.
"""
from __future__ import annotations

import json
import re
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import _build, flash_attention_bwd
from repro_torch.kernels.flash_attn.ops import _forward, bwd_route
from repro_torch.kernels.flash_attn.ref import (flash_attention_bwd_ref,
                                                flash_attention_ref)

# (B, S, H, H_kv, D), dtype, causal, window, q's offset in elements (4:
# off a 16-byte boundary, which TMA cannot read: the mma route)
CASES = [((1, 128, 4, 4, 128), torch.bfloat16, True, 0, 0),
         ((2, 100, 4, 2, 64), torch.bfloat16, True, 0, 0),
         ((1, 257, 6, 2, 128), torch.float32, True, 0, 0),
         ((1, 200, 4, 1, 64), torch.float32, False, 0, 0),
         ((1, 300, 4, 4, 128), torch.bfloat16, True, 70, 0),
         ((1, 300, 4, 2, 72), torch.bfloat16, False, 0, 0),
         ((1, 300, 4, 2, 72), torch.bfloat16, False, 0, 4),
         ((1, 190, 2, 2, 40), torch.float32, True, 33, 0),
         ((2, 64, 3, 1, 128), torch.bfloat16, False, 17, 0),
         ((1, 127, 2, 2, 128), torch.bfloat16, True, 0, 0),
         ((1, 128, 4, 2, 64), torch.bfloat16, True, 0, 0),
         ((1, 129, 4, 4, 128), torch.bfloat16, False, 0, 0),
         ((1, 1, 2, 1, 64), torch.bfloat16, True, 0, 0),
         ((1, 640, 32, 2, 128), torch.bfloat16, True, 0, 0),
         ((1, 500, 16, 2, 64), torch.bfloat16, True, 100, 0),
         ((1, 4096, 20, 20, 128), torch.bfloat16, True, 0, 0)]
LIMIT = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}
# chip_smoke.py's backward rows: (B, S, H, H_kv, D), dtype, window
ROWS = {"bwd-b": ((1, 4096, 20, 20, 128), torch.bfloat16, 0),
        "bwd-g": ((1, 4096, 32, 2, 128), torch.bfloat16, 0),
        "bwd-w": ((1, 4096, 32, 16, 128), torch.bfloat16, 1024),
        "bwd-m": ((1, 4096, 32, 32, 64), torch.bfloat16, 0),
        "bwd-f": ((1, 1024, 20, 20, 128), torch.float32, 0)}
FLUSH_BYTES = 256 << 20           # five times the H100's 50 MB L2


def plain_forward(q, k, v, causal, window):
    B, S, H, D = q.shape
    G = H // k.shape[2]
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, D)
    o, lse = flash_attention_ref(
        fold(q), fold(k.repeat_interleave(G, 2)),
        fold(v.repeat_interleave(G, 2)), causal=causal, window=window,
        return_lse=True)
    return o.reshape(B, H, S, D).transpose(1, 2), lse.reshape(B, H, S)


def registers(log: str) -> dict:
    """{backward kernel: ptxas's registers and spill lines, and its notes
    that serialise wgmma (C7510-C7515)}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
        note = re.search(r"\(C751[0-5]\).*'(\w+)'", line)
        if note and "flash_bwd" in note.group(1):
            out.setdefault(note.group(1), []).append(line.strip())
        elif cur and "flash_bwd" in cur and ("registers" in line
                                              or "spill" in line):
            out.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    return out


def events_ms(fn, iters: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def kernel_split(dev) -> dict:
    """{row: {kernel: mean device µs a call}} over 10 cold calls."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                        device=dev).zero_
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for name, ((B, S, H, Hkv, D), dt, window) in ROWS.items():
        q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dt)
                for _ in range(2))
        o, lse = _forward(q, k, v, True, window, True)
        call = lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                           window=window)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                flush()
                call()
            torch.cuda.synchronize()
        out[name] = {
            re.search(r"flash_bwd_\w+", e.key).group(0):
                getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0)) / 10
            for e in prof.key_averages() if "flash_bwd" in e.key}
        del q, k, v, do, o, lse
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_check: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "registers": registers(_build.build_log)}))
    ok = True
    for (B, S, H, Hkv, D), dt, causal, window, offset in CASES:
        gen = torch.Generator(device=dev).manual_seed(S + H)
        rnd = lambda h: torch.randn(B, S, h, D, generator=gen,
                                    device=dev).to(dt)
        q, k, v = rnd(H), rnd(Hkv), rnd(Hkv)
        do = rnd(H)
        if offset:
            q = torch.cat([q.flatten()[:offset], q.flatten()])[offset:].view(
                q.shape)
        o, lse = _forward(q, k, v, causal, window, True)
        _, lse_want = plain_forward(q, k, v, causal, window)
        same_out = torch.equal(o, _forward(q, k, v, causal, window,
                                           False)[0])
        before = flash_attention_bwd.launches
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window)
        launches = flash_attention_bwd.launches - before
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
        again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=window)
        torch.cuda.synchronize()
        # each error over the larger of its gradient's largest magnitude
        # and dV's: dQ and dK vanish where every query meets one key (S
        # 1, window 1) and keep only the rounding of that cancellation
        scale = want[2].float().abs().max()
        rel = [float((a.float() - b.float()).abs().max()
                     / torch.maximum(b.float().abs().max(), scale)
                     .clamp_min(1e-30))
               for a, b in zip(got, want)]
        lse_err = float((lse - lse_want).abs().max())
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        good = (same_out and bitwise and lse_err < 1e-4
                and max(rel) < LIMIT[dt]
                and all(bool(torch.isfinite(a).all()) for a in got))
        ok &= good
        print(json.dumps(dict(shape=[B, S, H, Hkv, D], dtype=str(dt),
                              causal=causal, window=window, offset=offset,
                              route=bwd_route(q, k, v, o, do),
                              launches=launches, lse_err=lse_err,
                              out_same_without_lse=same_out,
                              rel_errs_dq_dk_dv=rel, reproducible=bitwise,
                              good=good)))
        del q, k, v, do, o, lse, got, want, again
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(1, 4096, 20, 128, generator=gen,
                               device=dev).bfloat16() for _ in range(4))
    o, lse = _forward(q, k, v, True, 0, True)
    bwd_ms = events_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do))
    lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, is_causal=True).backward(dot)
    print(json.dumps({"shape": [1, 4096, 20, 128], "bwd_ms": bwd_ms,
                      "sdpa_forward_backward_ms": events_ms(sdpa),
                      "card": torch.cuda.get_device_name(0)}))
    del q, k, v, do, o, lse, lq, lk, lv
    torch.cuda.empty_cache()
    print(json.dumps({"kernel_us_a_call_cold": kernel_split(dev)}))
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
