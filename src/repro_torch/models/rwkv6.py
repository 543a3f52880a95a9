"""RWKV-6 "Finch" blocks (arXiv:2404.05892): attention-free time mixing
with data-dependent decay, and channel mixing.

The WKV recurrence per head (state S in R^{hd_k x hd_v}):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t @ S_{t-1} + (r_t . (u * k_t)) v_t

runs through ``kernels.wkv6`` (the hand-written kernel on a CUDA tensor,
its plain version, the reference's oracle ``wkv_sequential``, on a CPU
tensor), for a prefill as for a decode step (S = 1): the kernel walks the
sequence, so the port needs no chunked form.  The token-shift mixing, the
decay LoRA and the projections run in the activation dtype as in the
reference, the decay and the WKV in float32.  One card has no mesh, so
the reference's ``mesh`` hints have no counterpart.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import wkv6
from repro_torch.models.layers import PSpec

_LORA_MIX = 32      # token-shift mixing LoRA width
_LORA_DECAY = 64    # decay LoRA width


def time_mix_pspecs(cfg):
    d = cfg.d_model
    return {
        "mu_base": PSpec((d,), "zeros"),
        "mu_wkvrg": PSpec((5, d), "zeros"),
        "w1_mix": PSpec((d, 5 * _LORA_MIX)),
        "w2_mix": PSpec((5, _LORA_MIX, d)),
        "w0": PSpec((d,), "zeros"),
        "w1_decay": PSpec((d, _LORA_DECAY)),
        "w2_decay": PSpec((_LORA_DECAY, d), "zeros"),
        "u": PSpec((d,), "zeros"),
        "wr": PSpec((d, d)),
        "wk": PSpec((d, d)),
        "wv": PSpec((d, d)),
        "wg": PSpec((d, d)),
        "wo": PSpec((d, d), "out"),
        "ln_x_scale": PSpec((d,), "zeros"),
        "ln_x_bias": PSpec((d,), "zeros"),
    }


def _token_shift(x, prev):
    """prev: (B, 1, d) (zeros at the sequence's start) -> the x_{t-1}
    sequence."""
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _mix_vectors(p, x, sx):
    """Data-dependent token-shift mixing -> the five mixed inputs (w, k,
    v, r, g), (B, S, 5, d)."""
    xx = x + sx * p["mu_base"].to(x.dtype)
    lora = xx @ p["w1_mix"].to(x.dtype)
    B, S, _ = x.shape
    lora = torch.tanh(lora.reshape(B, S, 5, _LORA_MIX))
    mixes = torch.einsum("bsfl,fld->bsfd", lora, p["w2_mix"].to(x.dtype))
    mixes = mixes + p["mu_wkvrg"].to(x.dtype)[None, None]
    # x_i = x + sx * mix_i for each of the five streams
    return x[:, :, None] + sx[:, :, None] * mixes


def _decay(p, xw):
    """Log decay lw = -exp(w0 + lora(xw)) in float32, <= 0."""
    lora = xw.float() @ p["w1_decay"].float()
    lora = torch.tanh(lora) @ p["w2_decay"].float()
    return -torch.exp(torch.clamp(p["w0"].float() + lora, -12.0, 3.0))


def group_norm(y, scale, bias, H, eps=1e-5):
    """Per-head layer norm over head_dim (GroupNorm with H groups), float32
    out."""
    B, S, d = y.shape
    yh = y.reshape(B, S, H, d // H).float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, unbiased=False, keepdim=True)
    yh = ((yh - mu) * torch.rsqrt(var + eps)).reshape(B, S, d)
    return yh * (1.0 + scale.float()) + bias.float()


def time_mix_apply(cfg, p, x, cache=None, wkv=None):
    """x: (B, S, d).  cache: None (zeros) or {"shift": (B, 1, d), "state":
    (B, H, D, D) float32}.  ``wkv``: None for ``kernels.wkv6``, or its
    plain version.  Returns (out, new_cache)."""
    B, S, d = x.shape
    D = cfg.rwkv_head_size
    H = d // D
    prev = (cache["shift"] if cache is not None else
            torch.zeros((B, 1, d), dtype=x.dtype, device=x.device))
    state0 = (cache["state"] if cache is not None else
              torch.zeros((B, H, D, D), dtype=torch.float32,
                          device=x.device))
    sx = _token_shift(x, prev) - x
    mixed = _mix_vectors(p, x, sx)                           # (B,S,5,d)
    xw, xk, xv, xr, xg = (mixed[:, :, i] for i in range(5))
    lw = _decay(p, xw).reshape(B, S, H, D)
    r = (xr @ p["wr"].to(x.dtype)).reshape(B, S, H, D)
    k = (xk @ p["wk"].to(x.dtype)).reshape(B, S, H, D)
    v = (xv @ p["wv"].to(x.dtype)).reshape(B, S, H, D)
    g = F.silu(xg @ p["wg"].to(x.dtype))
    u = p["u"].float().reshape(H, D)
    y, state = (wkv or wkv6)(r.contiguous(), k.contiguous(),
                             v.contiguous(), lw.contiguous(), u.contiguous(),
                             state0.contiguous())
    y = group_norm(y.reshape(B, S, d), p["ln_x_scale"], p["ln_x_bias"], H)
    y = y.to(x.dtype) * g
    out = y @ p["wo"].to(x.dtype)
    return out, {"shift": x[:, -1:].clone(), "state": state}


def channel_mix_apply(cfg, p, x, cache=None):
    """RWKV channel mixing.  cache: None (zeros) or {"shift": (B, 1,
    d)}."""
    B, S, d = x.shape
    prev = (cache["shift"] if cache is not None else
            torch.zeros((B, 1, d), dtype=x.dtype, device=x.device))
    sx = _token_shift(x, prev) - x
    xk = x + sx * p["mix_k"].to(x.dtype)
    xr = x + sx * p["mix_r"].to(x.dtype)
    kk = torch.relu(xk @ p["wk"].to(x.dtype)).square()
    vv = kk @ p["wv"].to(x.dtype)
    rr = torch.sigmoid(xr @ p["wr"].to(x.dtype))
    return rr * vv, {"shift": x[:, -1:].clone()}


def init_rwkv_cache(cfg, batch, dtype=torch.bfloat16, device=None):
    d = cfg.d_model
    H, D = d // cfg.rwkv_head_size, cfg.rwkv_head_size
    shift = lambda: torch.zeros((batch, 1, d), dtype=dtype, device=device)
    return {"tmix": {"shift": shift(),
                     "state": torch.zeros((batch, H, D, D),
                                          dtype=torch.float32,
                                          device=device)},
            "cmix": {"shift": shift()}}
