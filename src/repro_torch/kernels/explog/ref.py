"""Plain PyTorch version of the s16.15 fixed-point exp/log accelerator.

The SpiNNaker2 elementary-function algorithm.  exp: range reduction by
ln 2, a 15-step shift-add ladder over ln(1 + 2^-k), a first-order
remainder and a saturating 2^n shift.  ln: normalisation to [1, 2) by
shifts, the same ladder run the other way, a floor-divided first-order
remainder.  Computed in int64 with every int32 wrap of the reference
made explicit (``wrap32``), so both are bit-identical to
``repro.kernels.explog.ref`` and to ``csrc/explog.cu``.
"""
from __future__ import annotations

import numpy as np
import torch

FRAC = 15
FX_ONE = 1 << FRAC                      # 1.0 in s16.15
LN2 = int(round(np.log(2.0) * FX_ONE))  # 22713

# ln(1 + 2^-k) table, k = 1..15, s16.15
LOG_TABLE = tuple(int(round(np.log1p(2.0 ** -k) * FX_ONE))
                  for k in range(1, 16))

MAX_EXP_ARG = 15 << FRAC                # overflow guard for s16.15 result
INT32_MAX = 2**31 - 1
LOG_BAD = -(2**30)                      # ln of x <= 0


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (still int64)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def fx_exp_ref(x: torch.Tensor) -> torch.Tensor:
    """x: int32 s16.15 -> exp(x) int32 s16.15 (saturating)."""
    x = x.to(torch.int64).clamp(-MAX_EXP_ARG, MAX_EXP_ARG)
    n = torch.div(x, LN2, rounding_mode="floor")       # integer part, base 2
    r = x - n * LN2                                    # r in [0, ln2)
    y = torch.full_like(x, FX_ONE)
    for k in range(1, 16):
        lk = LOG_TABLE[k - 1]
        take = r >= lk
        r = torch.where(take, r - lk, r)
        y = torch.where(take, y + (y >> k), y)
    # first-order remainder: y *= (1 + r),  r < 2^-15
    y = wrap32(y + (wrap32(y * r) >> FRAC))
    # apply 2^n with saturation
    n = n.clamp(-31, 31)
    up = torch.where(n >= 16, INT32_MAX, wrap32(y << n.clamp(0, 15)))
    down = y >> (-n).clamp(0, 31)
    return torch.where(n >= 0, up, down).to(torch.int32)


def fx_log_ref(x: torch.Tensor) -> torch.Tensor:
    """x: int32 s16.15, x > 0 -> ln(x) int32 s16.15 (x <= 0 -> -2^30)."""
    x = x.to(torch.int64)
    bad = x <= 0
    z = x.clamp_min(1)
    n = torch.zeros_like(z)               # z = x 2^-n, normalised to [1, 2)
    for shift in (15, 8, 4, 2, 1):                     # downward
        cond = z >= (FX_ONE << shift)
        z = torch.where(cond, z >> shift, z)
        n = torch.where(cond, n + shift, n)
    for shift in (8, 4, 2, 1, 1):                      # upward
        cond = z < (FX_ONE >> (shift - 1))
        z = torch.where(cond, wrap32(z << shift), z)
        n = torch.where(cond, n - shift, n)
    acc = wrap32(n * LN2)
    w = torch.full_like(z, FX_ONE)
    for k in range(1, 16):
        w_next = wrap32(w + (w >> k))
        take = w_next <= z
        w = torch.where(take, w_next, w)
        acc = torch.where(take, wrap32(acc + LOG_TABLE[k - 1]), acc)
    # first-order remainder: ln(z / w) ~ (z - w) / w, floor-divided
    rem = torch.div(wrap32((z - w) << FRAC), w, rounding_mode="floor")
    acc = wrap32(acc + rem)
    return torch.where(bad, LOG_BAD, acc).to(torch.int32)
