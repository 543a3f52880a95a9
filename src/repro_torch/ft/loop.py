"""Fault-tolerant training loop (the reference's ``ft/loop.py``).

* periodic checkpoint (atomic publish; ``ckpt/checkpoint.py``),
* resume from the latest checkpoint at its step + 1, with the data
  seeking there (``data/pipeline.py`` batches are pure functions of the
  step, so no replay log is needed),
* preemption: SIGTERM / SIGINT set a flag, and the loop checkpoints and
  exits at the next step boundary,
* bounded retry: a step that raises restores the last checkpoint and
  replays from it, at most ``max_retries`` times in a row,
* straggler hook: each step's wall time feeds an EMA; a step slower than
  ``straggler_factor`` x the EMA calls ``on_straggler`` and is recorded.
  The first step (which builds the kernels and warms the caches) is
  left out of the EMA.

The train step updates the model and the optimiser state in place
(``train/step.py``); a step's end is ``float(metrics["loss"])``, which
waits for the device.  A checkpoint holds {"params": the model's state
dict, "opt": the optimiser state}, and a restore copies it back into the
same model and tensors.  The reference's elastic restore onto another
mesh has no counterpart on one card.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.ckpt.checkpoint import CheckpointManager


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    max_retries: int = 3
    straggler_factor: float = 3.0
    ema_beta: float = 0.9
    install_signal_handlers: bool = False


def state_tree(state: dict) -> dict:
    """The checkpointed tree of {"params", "opt"}: a model as its state
    dict ({name: tensor})."""
    return {k: (dict(v.state_dict()) if isinstance(v, nn.Module) else v)
            for k, v in state.items()}


@torch.no_grad()
def load_into(state: dict, restored: dict) -> dict:
    """Copy a restored tree into ``state``'s model and tensors in place."""
    def copy(dst, src):
        if isinstance(dst, nn.Module):
            dst.load_state_dict(src)
        elif isinstance(dst, dict):
            for k in dst:
                dst[k] = copy(dst[k], src[k])
        else:
            dst.copy_(src)
        return dst
    return {k: copy(v, restored[k]) for k, v in state.items()}


def _device(state: dict) -> torch.device:
    p = state["params"]
    t = next(p.parameters()) if isinstance(p, nn.Module) else \
        next(iter(p.values()))
    return t.device


class FaultTolerantLoop:
    def __init__(self, cfg: LoopConfig, ckpt: CheckpointManager,
                 train_step, pipeline, *, on_straggler=None):
        self.cfg = cfg
        self.ckpt = ckpt
        self.train_step = train_step
        self.pipeline = pipeline
        self.on_straggler = on_straggler or (lambda step, dt, ema: None)
        self.preempted = False
        self.metrics_log: list = []
        self.straggler_steps: list = []
        if cfg.install_signal_handlers:
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, self._handle_preempt)

    def _handle_preempt(self, signum, frame):
        self.preempted = True

    def _restore(self, state):
        """(state, step of the latest checkpoint) or (state, None)."""
        template = state_tree(state)
        restored, manifest = self.ckpt.restore(template,
                                               device=_device(state))
        if restored is None:
            return state, None
        return load_into(state, restored), manifest["step"]

    def run(self, params, opt_state, *, start_step: int | None = None,
            fail_injector=None):
        """Train to ``total_steps`` from the latest checkpoint (or from
        ``start_step`` without restoring).  ``fail_injector(step) -> bool``
        is a test hook that makes a step raise.  Returns ({"params",
        "opt"}, the metrics log)."""
        state = {"params": params, "opt": opt_state}
        step = start_step or 0
        if start_step is None:
            state, last = self._restore(state)
            if last is not None:
                step = last + 1
        ema = None
        first_step = True          # builds the kernels: not a baseline
        retries = 0
        while step < self.cfg.total_steps:
            if self.preempted:
                self._checkpoint(step - 1, state, reason="preempt")
                break
            batch = self.pipeline.batch(step)
            t0 = time.monotonic()
            try:
                if fail_injector is not None and fail_injector(step):
                    raise RuntimeError(f"injected failure at step {step}")
                p, o, metrics = self.train_step(
                    state["params"], state["opt"], batch, step)
                loss = float(metrics["loss"])      # waits for the device
                state = {"params": p, "opt": o}
                retries = 0
            except Exception:
                retries += 1
                if retries > self.cfg.max_retries:
                    raise
                state, last = self._restore(state)
                step = 0 if last is None else last + 1
                continue
            dt = time.monotonic() - t0
            if first_step:
                first_step = False
            else:
                if ema is not None and dt > self.cfg.straggler_factor * ema:
                    self.straggler_steps.append(step)
                    self.on_straggler(step, dt, ema)
                ema = dt if ema is None else \
                    self.cfg.ema_beta * ema + (1 - self.cfg.ema_beta) * dt
            self.metrics_log.append({"step": step, "loss": loss, "dt": dt})
            if (step + 1) % self.cfg.ckpt_every == 0:
                self._checkpoint(step, state)
            step += 1
        self.ckpt.wait()
        return state, self.metrics_log

    def _checkpoint(self, step, state, reason="periodic"):
        self.ckpt.save(step, state_tree(state), meta={"reason": reason})
