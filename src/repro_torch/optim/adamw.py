"""AdamW with float32 moments (the reference's ``optim/adamw.py``).

The reference maps a pure update over the parameter pytree.  Here the
parameters are a module's (or a dict's) tensors, and the update runs in
place under ``torch.no_grad()``, one leaf at a time, so that its
temporaries never exceed one leaf (Qwen1.5-4B's embedding alone is 389 M
float32 values).  The arithmetic is the reference's: clip by the global
norm, moments in float32, bias correction by the int32 step ``count``,
decoupled weight decay, the new value cast back to the leaf's dtype.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def named_leaves(params) -> dict:
    """{name: tensor} of the floating leaves: a module's named parameters
    (``blocks.0.attn.wq``), or a flat dict as it is."""
    if isinstance(params, nn.Module):
        items = params.named_parameters()
    else:
        items = params.items()
    return {k: v for k, v in items if v.is_floating_point()}


def adamw_init(params) -> dict:
    """{"mu": {name: zeros}, "nu": {name: zeros}, "count": int32 0}: the
    moments float32, on each leaf's device."""
    leaves = named_leaves(params)
    zeros = lambda: {k: torch.zeros(v.shape, dtype=torch.float32,
                                    device=v.device)
                     for k, v in leaves.items()}
    dev = next(iter(leaves.values())).device if leaves else None
    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32."""
    total = None
    for t in tensors:
        sq = torch.sum(torch.square(t.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig, lr=None):
    """One AdamW step.  ``grads``: {name: gradient} over the leaves of
    ``params`` (None: each leaf's ``.grad``).  Updates ``params`` and
    ``state`` in place and returns (params, state, {"grad_norm"})."""
    lr = cfg.lr if lr is None else lr
    leaves = named_leaves(params)
    if grads is None:
        grads = {k: v.grad for k, v in leaves.items()}
    gnorm = global_norm(grads[k] for k in leaves)
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    state["count"] += 1
    count = state["count"].to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, count)
    b2c = 1.0 - torch.pow(cfg.b2, count)
    for k, p in leaves.items():
        g = grads[k].float() * scale
        mu, nu = state["mu"][k], state["nu"][k]
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        step = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr * (step + cfg.weight_decay * pf))
    return params, state, {"grad_norm": gnorm}
