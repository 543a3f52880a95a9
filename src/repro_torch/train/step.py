"""Train and serve step factories (the reference's ``train/step.py``).

``make_train_step`` gives the function the trainer runs each step: the
loss's gradients by autograd (the flash kernel's backward among them),
accumulated over ``microbatch`` slices of the batch in float32, then one
AdamW step with the cosine schedule's learning rate.  The reference's
step is a pure function under ``jit``; this one updates the parameters
and the optimiser state in place and returns them, so the call reads as
the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule
from repro_torch.optim.adamw import named_leaves

METRIC_KEYS = ("loss", "ce", "lb_loss", "z_loss")


def make_train_step(cfg, *, opt=AdamWConfig(), microbatch: int = 1,
                    remat: str = "full", moe_dense: bool = False,
                    ce_chunk: int = 512, total_steps: int = 10_000,
                    warmup_steps: int = 100, dtype=torch.bfloat16):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics): ``params`` a model whose floating leaves require
    grad, ``opt_state`` from ``adamw_init``, ``batch`` the pipeline's,
    ``step`` an int or an integer tensor.  Gradients of each of the
    ``microbatch`` slices of the batch's leading axis add up in the
    leaves' float32 ``.grad`` and are divided by ``microbatch``; the
    metrics (``loss``, ``ce``, ``lb_loss``, ``z_loss``, averaged over the
    slices, then ``grad_norm`` and ``lr``) are float32 0-d tensors on the
    device, not synchronised."""

    def train_step(params, opt_state, batch, step):
        leaves = named_leaves(params)
        for p in leaves.values():
            p.grad = None
        n = max(microbatch, 1)
        B = next(iter(batch.values())).shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} "
                             f"microbatches")
        msum = None
        for i in range(n):
            mb = {k: v[i * B // n:(i + 1) * B // n] for k, v in batch.items()}
            loss, metrics = T.train_loss(cfg, params, mb, moe_dense=moe_dense,
                                         remat=remat, ce_chunk=ce_chunk,
                                         dtype=dtype)
            loss.backward()
            m = {k: metrics[k].detach().float() for k in METRIC_KEYS}
            msum = m if msum is None else {k: msum[k] + m[k] for k in m}
        # a leaf the loss does not read (MusicGen's token table) takes a
        # zero gradient, as under jax.grad
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in leaves.items()}
        if n > 1:
            for g in grads.values():
                g.div_(n)
            msum = {k: v / n for k, v in msum.items()}
        device = next(iter(leaves.values())).device
        lr = cosine_schedule(step, peak_lr=opt.lr, warmup_steps=warmup_steps,
                             total_steps=total_steps, device=device)
        params, opt_state, om = adamw_update(grads, opt_state, params, opt,
                                             lr=lr)
        for p in leaves.values():
            p.grad = None
        return params, opt_state, {**msum, **om, "lr": lr}

    return train_step


def make_prefill_step(cfg, max_seq: int, *, moe_dense: bool = False,
                      dtype=torch.bfloat16):
    def prefill_step(params, batch):
        return T.prefill(cfg, params, batch, max_seq, moe_dense=moe_dense,
                         dtype=dtype)
    return prefill_step


def make_decode_step(cfg, *, moe_dense: bool = False, dtype=torch.bfloat16):
    def decode_step(params, caches, pos, batch):
        return T.decode_step(cfg, params, caches, pos, batch,
                             moe_dense=moe_dense, dtype=dtype)
    return decode_step
