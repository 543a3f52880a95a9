"""Deterministic, seekable synthetic data pipeline (the reference's
``data/pipeline.py``).

Every batch is a pure function of (seed, step), the property fault
tolerance needs: after a restart from the checkpoint of step k the
pipeline resumes at exactly batch k with no replay log.  Tokens follow
per-sequence affine recurrences over the vocabulary (x_{t+1} = a x_t + c
mod V, one of ``n_styles`` fixed (a, c) pairs a sequence) mixed with
noise tokens, so a model has structure to learn and its loss falls within
a few hundred steps.

The reference draws with ``jax.random`` (threefry), which the port does
not import, so the work is split in two: ``draws`` takes the random
numbers from a CPU ``torch.Generator`` seeded from (seed, step) (the
style pool from seed + 7919, as the reference's), and ``batch_from_draws``
is the pure function from the draws to the batch (the recurrence in
int32, wrapping as the reference's int32 arithmetic does, the noise mask,
frames mode).  Given the reference's own draws, ``batch_from_draws``
gives the reference's batch bit for bit; the port's draws are other
numbers with the same distributions.  Batches are made on the CPU and
moved to the pipeline's device.  ``shard_for`` (placement on a mesh) is
not ported: one card has no mesh.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device

POOL_SEED_OFFSET = 7919


@dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise_prob: float = 0.05
    n_styles: int = 8             # size of the fixed (a, c) recurrence pool
    kind: str = "tokens"          # "tokens" | "frames"
    d_model: int = 0              # frames mode
    num_codebooks: int = 1


def _generator(*words: int) -> torch.Generator:
    """A CPU generator seeded from the words, mixed by numpy's
    SeedSequence so that nearby (seed, step) pairs give unrelated
    streams."""
    state = np.random.SeedSequence([w % 2 ** 32 for w in words])
    return torch.Generator().manual_seed(
        int(state.generate_state(1, np.uint64)[0]))


def draws(cfg: PipelineConfig, step: int) -> dict:
    """The random numbers of batch ``step``, numpy arrays.  Tokens:
    ``pool_a`` (odd, in [1, V)) and ``pool_c`` (in [0, V)) of the style
    pool, ``style`` (B,), ``x0`` (B, 1), ``noise`` (B, S + 1) tokens and
    ``u`` (B, S + 1) uniform in [0, 1), float32.  Frames: ``frames`` (B,
    S, d) standard normal, float32, and ``labels`` (B, S, K)."""
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    g = _generator(cfg.seed, step)
    if cfg.kind == "frames":
        frames = torch.randn((B, S, cfg.d_model), generator=g)
        labels = torch.randint(0, V, (B, S, cfg.num_codebooks), generator=g)
        return {"frames": frames.numpy(), "labels": labels.numpy()}
    pool = _generator(cfg.seed + POOL_SEED_OFFSET)
    pool_a = 1 + 2 * torch.randint(0, (V - 1) // 2, (cfg.n_styles,),
                                   generator=pool)
    pool_c = torch.randint(0, V, (cfg.n_styles,), generator=pool)
    style = torch.randint(0, cfg.n_styles, (B,), generator=g)
    x0 = torch.randint(0, V, (B, 1), generator=g)
    noise = torch.randint(0, V, (B, S + 1), generator=g)
    u = torch.rand((B, S + 1), generator=g, dtype=torch.float32)
    return {k: t.numpy() for k, t in dict(
        pool_a=pool_a, pool_c=pool_c, style=style, x0=x0, noise=noise,
        u=u).items()}


def _wrap32(x: np.ndarray) -> np.ndarray:
    """int64 values wrapped to int32's range, as int32 arithmetic wraps."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def batch_from_draws(cfg: PipelineConfig, d: dict) -> dict:
    """The batch from its draws (numpy in, numpy out): frames float32
    (the pipeline casts them to bfloat16) and int32 labels; tokens (B,
    S + 1) int32: x_0 from ``x0``, x_{t+1} = (a x_t + c) mod V with (a,
    c) the sequence's style, each product and sum wrapped to int32 as
    the reference's int32 scan computes them, then ``noise`` where ``u``
    < noise_prob."""
    if cfg.kind == "frames":
        return {"frames": np.asarray(d["frames"], np.float32),
                "labels": np.asarray(d["labels"]).astype(np.int32)}
    V = cfg.vocab_size
    style = np.asarray(d["style"]).astype(np.int64)
    a = np.asarray(d["pool_a"]).astype(np.int64)[style]
    c = np.asarray(d["pool_c"]).astype(np.int64)[style]
    x = np.asarray(d["x0"]).astype(np.int64)[:, 0]
    noise = np.asarray(d["noise"])
    tokens = np.empty(noise.shape, np.int64)
    tokens[:, 0] = x
    for t in range(1, noise.shape[1]):
        x = _wrap32(_wrap32(x * a) + c) % V
        tokens[:, t] = x
    mask = np.asarray(d["u"], np.float32) < np.float32(cfg.noise_prob)
    tokens = np.where(mask, noise, tokens)
    return {"tokens": tokens.astype(np.int32)}


class SyntheticTokenPipeline:
    """Batches of ``cfg`` on ``device`` (default: the card): tokens (B,
    S + 1) int32, or frames (B, S, d) bfloat16 and labels (B, S, K)
    int32."""

    def __init__(self, cfg: PipelineConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def batch(self, step: int) -> dict:
        """Batch for ``step`` (deterministic, O(1) seek)."""
        out = batch_from_draws(self.cfg, draws(self.cfg, int(step)))
        batch = {k: torch.from_numpy(v) for k, v in out.items()}
        if "frames" in batch:
            batch["frames"] = batch["frames"].to(torch.bfloat16)
        return {k: v.to(self.device) for k, v in batch.items()}
