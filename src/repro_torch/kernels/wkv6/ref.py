"""Plain PyTorch version of the WKV-6 recurrence kernel: the reference's
oracle ``repro/models/rwkv6.py::wkv_sequential``, one step a position."""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, lw, u, state0):
    """r, k, v: (B, S, H, D), widened to float32; lw: (B, S, H, D) float32
    log decay; u: (H, D) float32; state0: (B, H, D, D) float32, k index
    first.  Returns (y (B, S, H, D) float32, state (B, H, D, D)):
    y_t = r_t S_{t-1} + (r_t . (u k_t)) v_t,
    S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T."""
    rf, kf, vf = r.float(), k.float(), v.float()
    state = state0
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]
        w = torch.exp(lw[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, state)
                  + torch.einsum("bhk,bhk,bhv->bhv", rt, u[None] * kt, vt))
        state = state * w[..., None] + torch.einsum("bhk,bhv->bhkv", kt, vt)
    if not ys:
        return torch.zeros_like(rf), state0
    return torch.stack(ys, 1), state
