#!/usr/bin/env python3
"""Time ``flash_attention_kernel`` of the ``repro_torch`` package found on
the path, causal, at chip_smoke.py's flash row shapes: 8 (1 x 4096, 32 x
128, bf16), 8'' (4 x 4096, the LM prefill's batch), 8w (the same under
Gemma-3's local window of 1024), 8m (4 x 4096, 32 x 64: MusicGen-large's
head size), 8' (float32, 1 x 1024), and RecurrentGemma-2B's local layers
at head_dim 256, 8r (4 x 4096, 10 x 256, window 2048, bf16) and 8r' (the
same in float32).  K and V are passed expanded to every query head (the
model inputs of 8'', 8w and 8r have fewer KV heads), the form that every
tree of the port accepts.  Each launch is timed cold (the L2 cache
flushed before it) with CUDA events, ``--iters`` times (8r' a third as
often); one JSON line with the mean and the median in ms, the card's
name and power limit.  ``--rows`` times only the rows named.  Beside them,
``kv_copies``: the cold time of the K and V expansion that the parent
tree's prefill made before each flash launch (``repeat_interleave`` to
every query head), at GLM-4-9B's layer (cell n: 4 x 4096, 2 KV heads of
128 to 32, 40 layers) and RecurrentGemma-2B's local layer (cell q: 1 KV
head of 256 to 10, 8 local layers), a layer and a prefill batch.

Two trees of the port compare in one call on one card, in turns, each
pair in the other order from the last:

    for i in 1 2 3 4 5; do
        for t in parent change change parent; do
            PYTHONPATH=$t/src python3 scripts/flash_ab.py --label $t
        done
    done
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

# row: (B, S, H, D), dtype, window
SHAPES = {"8": ((1, 4096, 32, 128), torch.bfloat16, 0),
          "8''": ((4, 4096, 32, 128), torch.bfloat16, 0),
          "8w": ((4, 4096, 32, 128), torch.bfloat16, 1024),
          "8m": ((4, 4096, 32, 64), torch.bfloat16, 0),
          "8'": ((1, 1024, 32, 128), torch.float32, 0),
          "8r": ((4, 4096, 10, 256), torch.bfloat16, 2048),
          "8r'": ((4, 4096, 10, 256), torch.float32, 2048)}
FLUSH_BYTES = 256 << 20           # five times the H100's 50 MB L2
# cell: (B, S, H_kv, D), G, layers that expand in a prefill batch
KV_COPIES = {"n": ((4, 4096, 2, 128), 16, 40),
             "q": ((4, 4096, 1, 256), 10, 8)}


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
    ap.add_argument("--rows", nargs="+", choices=list(SHAPES),
                    default=list(SHAPES), help="rows to time (all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA device")
    from repro_torch.kernels import flash_attention_kernel
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev).zero_
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name in args.rows:
        shape, dtype, window = SHAPES[name]
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        iters = args.iters // 3 if name == "8r'" else args.iters
        t = cold_ms(lambda: flash_attention_kernel(q, k, v, window=window),
                    iters, flush)
        rows[name] = dict(shape=list(shape),
                          dtype=str(dtype).removeprefix("torch."),
                          window=window, mean_ms=statistics.fmean(t),
                          median_ms=statistics.median(t))
        del q, k, v
    copies = {}
    for cell, (shape, G, layers) in KV_COPIES.items():
        k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        t = cold_ms(lambda: (k.repeat_interleave(G, dim=2),
                             v.repeat_interleave(G, dim=2)), args.iters,
                    flush)
        copies[cell] = dict(shape=list(shape), groups=G,
                            layer_ms=statistics.median(t),
                            batch_ms=layers * statistics.median(t))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "rows": rows,
                      "kv_copies": copies}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
