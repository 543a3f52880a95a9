"""Griffin-style recurrent block with RG-LRU (RecurrentGemma,
arXiv:2402.19427).

Block: x -> [W_x -> causal depthwise conv(4) -> RG-LRU] * gelu(W_gate x)
-> W_o

RG-LRU (float32):
    i_t = sigmoid(W_i u_t + b_i)
    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a u_t + b_a)),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The gates' two products are float32 ``torch.matmul``s; the gates and the
recurrence are one ``kernels.linear_scan`` call (the hand-written kernel
on a CUDA tensor, its plain version on a CPU tensor), for a prefill as
for a decode step (S = 1).  The cache holds the conv's last ``cw - 1``
inputs (B, cw-1, w) in the activation dtype and the float32 state (B, w).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import linear_scan
from repro_torch.models.layers import PSpec


def rglru_pspecs(cfg):
    d = cfg.d_model
    w = cfg.lru_width or d
    cw = cfg.conv_width
    return {
        "wx": PSpec((d, w)),
        "wgate": PSpec((d, w)),
        "conv_w": PSpec((cw, w)),
        "conv_b": PSpec((w,), "zeros"),
        "wi": PSpec((w, w)),
        "bi": PSpec((w,), "zeros"),
        "wa": PSpec((w, w)),
        "ba": PSpec((w,), "zeros"),
        "lam": PSpec((w,), "ones"),
        "wo": PSpec((w, d), "out"),
    }


def _causal_conv(p, u, conv_cache):
    """Depthwise causal conv of width cw in u's dtype.  u: (B, S, w);
    cache: (B, cw-1, w), the inputs before u.  Returns (out, the last
    cw - 1 inputs)."""
    cw = p["conv_w"].shape[0]
    full = torch.cat([conv_cache.to(u.dtype), u], dim=1)
    S = u.shape[1]
    out = torch.zeros_like(u)
    for i in range(cw):
        # tap i uses x_{t-(cw-1-i)}
        out = out + full[:, i:i + S] * p["conv_w"][i].to(u.dtype)
    out = out + p["conv_b"].to(u.dtype)
    new_cache = full[:, -(cw - 1):].clone() if cw > 1 else conv_cache
    return out, new_cache


def _preactivations(p, uf):
    """The gates' pre-activations u W_i + b_i and u W_a + b_a, float32."""
    xi = uf @ p["wi"].float() + p["bi"].float()
    xa = uf @ p["wa"].float() + p["ba"].float()
    return xi, xa


def rg_lru(p, u, h0, scan=None):
    """u: (B, S, w); h0: (B, w) float32.  Returns (y (B, S, w) float32,
    h_final).  ``scan``: None for ``kernels.linear_scan``, or its plain
    version."""
    uf = u.float()
    xi, xa = _preactivations(p, uf)
    return (scan or linear_scan)(xi, xa, uf, p["lam"].float().contiguous(),
                                 h0.contiguous())


def rglru_block_apply(cfg, p, x, cache=None, scan=None):
    """x: (B, S, d).  cache: {"conv": (B, cw-1, w), "state": (B, w)
    float32} or None (zeros).  Returns (out, new_cache)."""
    B, S, d = x.shape
    w = cfg.lru_width or d
    cw = cfg.conv_width
    conv_cache = (cache["conv"] if cache is not None else
                  torch.zeros((B, cw - 1, w), dtype=x.dtype, device=x.device))
    h0 = (cache["state"] if cache is not None else
          torch.zeros((B, w), dtype=torch.float32, device=x.device))
    u = x @ p["wx"].to(x.dtype)
    gate = F.gelu(x @ p["wgate"].to(x.dtype), approximate="tanh")
    u, new_conv = _causal_conv(p, u, conv_cache)
    y, h_final = rg_lru(p, u, h0, scan)
    y = y.to(x.dtype) * gate
    out = y @ p["wo"].to(x.dtype)
    return out, {"conv": new_conv, "state": h_final}


def init_rglru_cache(cfg, batch, dtype=torch.bfloat16, device=None):
    w = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device),
            "state": torch.zeros((batch, w), dtype=torch.float32,
                                 device=device)}
