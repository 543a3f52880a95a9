#!/usr/bin/env python3
"""Where the chunked WKV kernel spends its time, step by step, on the card.

Builds a copy of ``src/repro_torch/csrc/wkv6.cu`` whose chunk loop reads
``clock64()`` in thread 0 of every block after each block barrier and
before the copy wait, runs it once at chip_smoke.py's row new-w (RWKV-6-
1.6B's prefill: 4 x 4096 x 32 heads of 64, bf16, log decays -exp(U(-6,
1))) and prints one JSON line: SM cycles a chunk (averaged over blocks
and chunks) of each stretch of the loop, with the instrumented launch's
time and the card's name and power limit.  Thread 0 sits in warp 0, so
``step4`` is warp 0's part of step 4 (y's A V and its store) and
``wait`` the rest of step 4 with the next chunk's copy wait; the other
stretches end at barriers, so each is its slowest warp's.  The clock
reads cost a few per cent of the time.

    PYTHONPATH=src python3 scripts/wkv6_steps.py
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import _build

STRETCHES = ("wait", "step1", "step2", "step3", "step4")
COUNTERS = """__device__ unsigned long long g_steps[8];
#define STEP(i) do { if (threadIdx.x == 0) { long long t_ = clock64(); \\
  atomicAdd(&g_steps[i], (unsigned long long)(t_ - t_last)); t_last = t_; } \\
  } while (0)
"""
READ = """
extern "C" int steps_read(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_steps, sizeof(g_steps));
}
"""


def instrument(src: str) -> str:
    """The kernel source with its chunk loop's stretches counted: slot i
    after the loop's i-th barrier, slot 4 (warp 0's step 4) before the
    copy wait."""
    kernel = src.index("wkv6_chunked_kernel(")
    loop = src.index("  for (int n = 0; n < n_chunks; ++n) {", kernel)
    end = src.index("\nnamespace {", loop)
    body = src[loop:end].replace("    cp_async_wait_all();\n",
                                 "    if (n > 0) STEP(4);\n"
                                 "    cp_async_wait_all();\n", 1)
    count = iter(range(4))
    body = re.sub(r"    __syncthreads\(\);\n",
                  lambda m: m.group(0) + f"    STEP({next(count)});\n", body)
    head = src[:loop].replace("template <typename T>\n__global__",
                              COUNTERS + "template <typename T>\n__global__",
                              1)
    return head + "  long long t_last = clock64();\n" + body + src[end:] + READ


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wkv6_steps: no CUDA device")
    src = (_build.CSRC / "wkv6.cu").read_text()
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        cu, so = Path(tmp) / "wkv6_steps.cu", Path(tmp) / "wkv6_steps.so"
        cu.write_text(instrument(src))
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(so), str(cu)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.repro_wkv6_chunked
        fn.argtypes = (ctypes.c_void_p,) * 8 + (ctypes.c_int32,) * 5 + (
            ctypes.c_void_p,)
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        B, S, H, D = 4, 4096, 32, 64
        r, k, v = (torch.randn(B, S, H, D, generator=gen, device=dev)
                   .bfloat16() for _ in range(3))
        lw = -torch.exp(torch.empty(B, S, H, D, device=dev)
                        .uniform_(-6.0, 1.0, generator=gen))
        u = 0.5 * torch.randn(H, D, generator=gen, device=dev)
        s0 = torch.randn(B, H, D, D, generator=gen, device=dev)
        y, st = torch.empty_like(lw), torch.empty_like(s0)

        def call():
            rc = fn(*(t.data_ptr() for t in (r, k, v, lw, u, s0, y, st)),
                    B, S, H, D, 1, torch.cuda.current_stream().cuda_stream)
            _build.check(rc, "wkv6_steps")
        call()                                   # sets the shared memory
        torch.cuda.synchronize()
        zeros = (ctypes.c_ulonglong * 8)()
        lib.steps_read(zeros)                    # the first call's counts
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call()
        b.record()
        b.synchronize()
        counts = (ctypes.c_ulonglong * 8)()
        lib.steps_read(counts)
    # step 4 is read at the next chunk's top: every chunk but the last
    chunks = [B * H * (S // 64)] * 4 + [B * H * (S // 64 - 1)]
    cycles = {name: (counts[i] - zeros[i]) / chunks[i]
              for i, name in enumerate(STRETCHES)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "instrumented_us": a.elapsed_time(b) * 1e3,
                      "cycles_per_chunk": cycles,
                      "sum": sum(cycles.values())}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
