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


def wkv6_bwd_ref(r, k, v, lw, u, state0, dy, dstate):
    """The backward of ``wkv6_ref``: its inputs and the cotangents dy (B,
    S, H, D) and dstate (B, H, D, D), float32 -> (dr, dk, dv in r's
    dtype, dlw (B, S, H, D), du (H, D), dstate0 (B, H, D, D) float32),
    from the sequential form with S_t the state after position t (S_0 =
    state0) and dS_S = dstate:
      dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t),
      dS_{t-1} = diag(w_t) dS_t + r_t^T dy_t,
      dk_t = dS_t v_t + u r_t (v_t . dy_t),
      dv_t = dS_t^T k_t + (r_t . (u k_t)) dy_t,
      dlw_t = w_t o sum_v S_{t-1} o dS_t  (w = exp(lw)),
      du = sum over (B, S) of r_t k_t (v_t . dy_t), dstate0 = dS_0.
    dlw is taken directly from the states, as the kernel takes it (not
    as a difference of two running sums over the sequence, which lands
    further from float64)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(lw)
    S = r.shape[1]
    state, prev, dr = state0, [], []
    for t in range(S):
        prev.append(state)
        dr.append(torch.einsum("bhkv,bhv->bhk", state, dy[:, t]))
        state = state * w[:, t, ..., None] + torch.einsum(
            "bhk,bhv->bhkv", kf[:, t], vf[:, t])
    vdy = (vf * dy).sum(-1, keepdim=True)                    # (B, S, H, 1)
    dS = dstate
    dk, dv, dlw = [None] * S, [None] * S, [None] * S
    for t in reversed(range(S)):
        rt, kt = rf[:, t], kf[:, t]
        dk[t] = torch.einsum("bhkv,bhv->bhk", dS, vf[:, t])
        dv[t] = (torch.einsum("bhkv,bhk->bhv", dS, kt)
                 + (rt * (u[None] * kt)).sum(-1, keepdim=True) * dy[:, t])
        dlw[t] = w[:, t] * (prev[t] * dS).sum(-1)
        dS = dS * w[:, t, ..., None] + torch.einsum("bhk,bhv->bhkv", rt,
                                                    dy[:, t])
    if not S:
        z = torch.zeros_like(rf)
        return (z.to(r.dtype), z.to(k.dtype), z.to(v.dtype), z,
                torch.zeros_like(u), dstate)
    stack = lambda ts: torch.stack(ts, 1)
    bonus = u[None, None] * vdy
    dr = stack(dr) + bonus * kf
    dk = stack(dk) + bonus * rf
    du = (rf * kf * vdy).sum((0, 1))
    return (dr.to(r.dtype), dk.to(k.dtype), stack(dv).to(v.dtype),
            stack(dlw), du, dS)
