"""Batched LM serving engine with activity-driven scheduling.

The spike-FIFO -> performance-level loop of the paper (core/dvfs.py),
applied to inference: the request queue's depth selects the decode batch
width each scheduling round (``QueueDVFS``), so machine activity tracks
offered load — idle deployments run narrow/cheap, bursts widen the batch.

Continuous-batching-lite: one padded decode batch; finished sequences are
replaced from the queue between rounds.  Prefill (the flash kernel in
every layer) and decode run eagerly on the parameters' device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.dvfs import QueueDVFS
from repro_torch.models import transformer as T
from repro_torch.serve.queue import RequestQueue, select_width


def sample_logits(logits, generator: torch.Generator, *,
                  temperature: float = 0.0, top_k: int = 0):
    """logits: (B, V).  temperature<=0 -> greedy; top_k>0 restricts
    support.  Sampling draws from ``generator`` (not ``jax.random``'s
    stream, so not bitwise the reference's samples)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    lg = logits.float() / temperature
    if top_k > 0:
        kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
        lg = torch.where(lg < kth, -1e30, lg)
    return torch.multinomial(torch.softmax(lg, dim=-1), 1,
                             generator=generator)[:, 0]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 32
    out_tokens: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serves ``params`` (a ``models.transformer.Transformer``) on its
    device.  ``dtype`` is the activation dtype (the reference's bf16 by
    default).  ``stats`` has the reference's keys; ``timings`` the host
    seconds of each prefill (to its first sampled tokens) and each decode
    step, both ending in the step's read-back of the sampled tokens."""

    def __init__(self, cfg, params, *, max_seq: int = 256,
                 dvfs: QueueDVFS | None = None, eos_id: int | None = None,
                 greedy: bool = True, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, dtype=torch.bfloat16):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.dvfs = dvfs or QueueDVFS(thresholds=(2, 6),
                                      batch_levels=(1, 4, 8))
        self.eos_id = eos_id
        self.greedy = greedy
        self.temperature = temperature
        self.top_k = top_k
        self.dtype = dtype
        self.device = params["embed"]["table"].device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # the shared serving-tier admission queue (serve.queue), the same
        # class the neuromorphic FleetEngine admits sessions from
        self.queue = RequestQueue()
        self.stats = {"tokens": 0, "rounds": 0, "batch_hist": []}
        self.timings = {"prefill_s": [], "decode_s": []}

    def submit(self, req: Request):
        self.queue.submit(req)

    def _sample(self, logits):
        lg = logits[:, -1]
        if self.greedy or self.temperature <= 0.0:
            return torch.argmax(lg, dim=-1)
        return sample_logits(lg, self.generator,
                             temperature=self.temperature, top_k=self.top_k)

    @torch.inference_mode()
    def _run_batch(self, reqs: list[Request]):
        """Prefill a batch of same-length prompts, then decode to
        completion."""
        cfg, params = self.cfg, self.params
        B = len(reqs)
        S = max(len(r.prompt) for r in reqs)
        prompts = np.full((B, S), 0, np.int64)
        for i, r in enumerate(reqs):
            prompts[i, S - len(r.prompt):] = r.prompt       # left-pad
        t0 = time.perf_counter()
        logits, caches = T.prefill(
            cfg, params, {"tokens": torch.from_numpy(prompts).to(self.device)},
            self.max_seq, dtype=self.dtype)
        tok_dev = self._sample(logits)
        tok = tok_dev.tolist()
        self.timings["prefill_s"].append(time.perf_counter() - t0)
        max_new = max(r.max_new_tokens for r in reqs)
        for i, r in enumerate(reqs):
            r.out_tokens.append(tok[i])
        for step in range(1, max_new):
            t0 = time.perf_counter()
            logits, caches = T.decode_step(cfg, params, caches,
                                           S + step - 1,
                                           {"tokens": tok_dev[:, None]},
                                           dtype=self.dtype)
            tok_dev = self._sample(logits)
            tok = tok_dev.tolist()
            self.timings["decode_s"].append(time.perf_counter() - t0)
            for i, r in enumerate(reqs):
                if len(r.out_tokens) < r.max_new_tokens and not r.done:
                    r.out_tokens.append(tok[i])
                    if self.eos_id is not None and tok[i] == self.eos_id:
                        r.done = True
            self.stats["tokens"] += B
        for r in reqs:
            r.done = True

    def run(self):
        """Drain the queue with DVFS-selected batch widths."""
        while self.queue:
            width = select_width(self.dvfs, self.queue, in_flight=0)
            batch = self.queue.take(width)
            self.stats["rounds"] += 1
            self.stats["batch_hist"].append(len(batch))
            self._run_batch(batch)
        self.stats["queue"] = self.queue.stats()
        return self.stats
