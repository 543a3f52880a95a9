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


def linear_scan_bwd_ref(xi, xa, u, lam, h0, y, dy, dh_final):
    """The backward of ``linear_scan_ref``: its inputs, its output y (B,
    S, w) and the cotangents dy (B, S, w) and dh_final (B, w), all
    float32 -> (dxi, dxa, du (B, S, w), dlam (w,), dh0 (B, w)).

    The reverse scan g_t = dy_t + a_{t+1} g_{t+1} (g_S = dy_S +
    dh_final) gives da_t = g_t h_{t-1} and db_t = g_t (h_0 = h0, dh0 =
    a_1 g_1); then the chain back through ``rglru_coefficients``: beta's
    derivative goes through log a and is zero where its 1e-12 clamp
    holds, softplus' derivative is the sigmoid, and dlam = sum over
    (B, S) of dlog a_t (-8 sigmoid(lam) sigmoid(xa_t))."""
    gate_i = torch.sigmoid(xi)
    gate_a = torch.sigmoid(xa)
    neg_c_sp = -C * softplus(lam)
    log_a = neg_c_sp * gate_a
    a = torch.exp(log_a)
    e2 = torch.exp(2.0 * log_a)
    m = 1.0 - e2
    beta = torch.sqrt(torch.clamp_min(m, 1e-12))
    g = torch.empty_like(dy)
    carry, a_next = dh_final, torch.ones_like(h0)
    for t in reversed(range(dy.shape[1])):
        carry = dy[:, t] + a_next * carry
        g[:, t] = carry
        a_next = a[:, t]
    dh0 = a_next * carry
    h_prev = torch.cat([h0[:, None], y[:, :-1]], 1)
    gb = g * beta
    du = gb * gate_i
    dbeta = g * gate_i * u
    dlog_a = g * h_prev * a + torch.where(m > 1e-12, -(dbeta * e2) / beta,
                                          0.0)
    dxi = gb * u * (gate_i * (1.0 - gate_i))
    dxa = dlog_a * neg_c_sp * (gate_a * (1.0 - gate_a))
    dlam = (dlog_a * gate_a).sum((0, 1)) * (-C * torch.sigmoid(lam))
    return dxi, dxa, du, dlam, dh0
