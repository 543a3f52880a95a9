"""Training launcher (the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --smoke --steps 200 --device cpu

The reference launcher's flags, plus ``--device`` (default: the CUDA
device) and ``--dtype`` (default: bfloat16), the dtype of the
activations; the parameters, their gradients and AdamW's moments are
float32, as in the reference.  The model is drawn on the device from
``--seed``; the data is the synthetic pipeline's (frames and labels for
MusicGen's encodec frontend), made on the host from the same seed.  The
step runs ``remat="full"`` and ``ce_chunk=min(seq, 512)`` as the
reference's does, inside the fault-tolerant loop (checkpoints under
``--ckpt-dir/<arch>`` every ``--ckpt-every`` steps, resume from the
latest, preemption by SIGTERM / SIGINT).  On the card, the recurrent
archs (``recurrentgemma-2b``, ``rwkv6-1.6b``) and head_dim above 128 are
refused: their kernels have no backward yet (ROADMAP queue A, slice 17);
on the CPU their plain versions differentiate and they train.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokenPipeline
from repro_torch.ft.loop import FaultTolerantLoop, LoopConfig
from repro_torch.kernels.flash_attn.ops import MAX_BWD_HEAD_DIM
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
RECURRENT = ("rglru", "rwkv")


def card_refusal(cfg) -> str | None:
    """Why ``cfg`` cannot train on the card yet, or None."""
    if any(k in RECURRENT for k in cfg.layer_pattern + cfg.rem_layers):
        return (f"{cfg.name}: the recurrent kernels (linear_scan, wkv6) "
                f"have no backward yet (ROADMAP queue A, slice 17); train "
                f"it with --device cpu")
    if cfg.head_dim > MAX_BWD_HEAD_DIM:
        return (f"{cfg.name}: flash attention's backward takes head_dim <= "
                f"{MAX_BWD_HEAD_DIM}, not {cfg.head_dim} (ROADMAP queue A, "
                f"slice 17)")
    return None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--moe-dense", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                    help="activation dtype (parameters stay float32)")
    args = ap.parse_args(argv)

    cfg = configs.get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device = resolve_device(args.device)
    if device.type == "cuda" and card_refusal(cfg):
        ap.error(card_refusal(cfg))
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"device={device}")

    params = T.init_params(cfg, device=device, seed=args.seed,
                           requires_grad=True)
    opt_state = adamw_init(params)
    pipe = SyntheticTokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        kind="frames" if cfg.frontend == "encodec" else "tokens",
        d_model=cfg.d_model, num_codebooks=cfg.num_codebooks), device=device)

    step_fn = make_train_step(
        cfg, opt=AdamWConfig(lr=args.lr), microbatch=args.microbatch,
        remat="full", moe_dense=args.moe_dense, ce_chunk=min(args.seq, 512),
        total_steps=args.steps, warmup_steps=max(args.steps // 20, 10),
        dtype=DTYPES[args.dtype])

    ckpt = CheckpointManager(f"{args.ckpt_dir}/{cfg.name}")
    loop = FaultTolerantLoop(
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                   install_signal_handlers=True),
        ckpt, step_fn, pipe)

    t0 = time.time()
    state, log = loop.run(params, opt_state)
    for rec in log:
        if rec["step"] % args.log_every == 0 or rec["step"] == args.steps - 1:
            print(f"step {rec['step']:5d} loss {rec['loss']:.4f} "
                  f"({rec['dt']*1e3:.0f} ms)")
    dt = time.time() - t0
    if log:
        first = sum(r["loss"] for r in log[:10]) / max(len(log[:10]), 1)
        last = sum(r["loss"] for r in log[-10:]) / max(len(log[-10:]), 1)
        print(f"done in {dt:.1f}s; loss {first:.4f} -> {last:.4f}")
        return {"first": first, "last": last, "log": log, "state": state}
    return {}


if __name__ == "__main__":
    main()
