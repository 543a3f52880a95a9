"""Serving launcher: batched decode with queue-driven (DVFS-style) widths.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
        --requests 12 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b

Any registered token model: the dense transformers, the MoE configs
(``olmoe-1b-7b``, ``phi3.5-moe-42b-a6.6b``), Gemma-3's local windows,
Nemotron-4, Chameleon (whose VQ image tokens share the text
vocabulary) and the recurrent pair, ``recurrentgemma-2b`` (RG-LRU
layers and local attention at head_dim 256) and ``rwkv6-1.6b``.  MusicGen's encodec frames do not go through the engine, in
the reference's engine as in this one: drive its ``prefill`` and
``decode_step`` on ``{"frames": ...}`` directly.  The reference launcher's
flags, plus ``--device`` (default: the CUDA
device) and ``--dtype`` (default: bfloat16), the dtype of both the
parameters and the activations.  The weights are random, drawn on the
device from ``--seed``; the prompts come from numpy's generator with the
same seed, as in the reference, so the schedule is the reference's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    args = ap.parse_args(argv)

    cfg = configs.get_arch(args.arch)
    if cfg.frontend == "encodec":
        ap.error(f"{args.arch} takes encodec frames, not tokens: drive "
                 f"models.transformer.prefill / decode_step with "
                 f"{{'frames': ...}}")
    if args.smoke:
        cfg = cfg.smoke()
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    params = T.init_params(cfg, dtype=dtype, device=device, seed=args.seed)

    eng = ServeEngine(cfg, params, max_seq=args.max_seq, dtype=dtype)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        eng.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len,
                                dtype=np.int32),
            max_new_tokens=args.max_new))
    t0 = time.time()
    stats = eng.run()
    dt = time.time() - t0
    print(f"served {args.requests} requests, {stats['tokens']} tokens in "
          f"{dt:.1f}s ({stats['tokens']/dt:.1f} tok/s) on {device}")
    print(f"rounds={stats['rounds']} batch widths={stats['batch_hist']} "
          f"(queue-DVFS levels: {eng.dvfs.batch_levels})")
    return stats


if __name__ == "__main__":
    main()
