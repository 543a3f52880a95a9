"""Plain PyTorch version of the RG-LRU recurrence kernel: the reference's
gates (``repro/models/rglru.py::_gates``) and its sequential recurrence
``h_t = a_t h_{t-1} + b_t`` (the naive loop its tests hold the chunked
scan against), in float32 with a Python loop over t."""
from __future__ import annotations

import torch

C = 8.0             # RG-LRU decay sharpness constant


def softplus(x):
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def rglru_coefficients(xi, xa, u, lam):
    """The recurrence's coefficients from the gates' pre-activations ``xi``
    = u W_i + b_i and ``xa`` = u W_a + b_a (B, S, w), the input u and the
    decay parameter ``lam`` (w,): a = exp(-8 softplus(lam) sigmoid(xa)),
    b = sqrt(max(1 - a^2, 1e-12)) sigmoid(xi) u (1 - a^2 from log a, for
    precision near a ~ 1)."""
    gate_i = torch.sigmoid(xi)
    gate_a = torch.sigmoid(xa)
    log_a = -C * softplus(lam) * gate_a
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * gate_i * u


def linear_scan_ref(xi, xa, u, lam, h0):
    """xi, xa, u: (B, S, w) float32; lam: (w,); h0: (B, w).  Returns (y
    (B, S, w), h_final (B, w)), y_t = h_t."""
    a, b = rglru_coefficients(xi, xa, u, lam)
    y = torch.empty_like(b)
    h = h0
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y, h
