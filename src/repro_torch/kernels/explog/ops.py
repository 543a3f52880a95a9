"""``fx_exp`` wrapper (CPU: plain version, CUDA: ``csrc/explog.cu``) and
float <-> s16.15 helpers."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import expect_dtype, on_cpu
from repro_torch.kernels.explog.ref import FX_ONE, fx_exp_ref

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p)


def fx_exp(x: torch.Tensor) -> torch.Tensor:
    """x: int32 s16.15, any shape -> exp(x) int32 s16.15."""
    expect_dtype("fx_exp", torch.int32, x=x)
    if on_cpu("fx_exp", x):
        return fx_exp_ref(x)
    out = torch.empty_like(x)
    if x.numel():
        rc = _build.launcher("repro_fx_exp", _ARGS)(
            x.data_ptr(), out.data_ptr(), x.numel(),
            _build.stream_ptr(x.device))
        _build.check(rc, "fx_exp")
        fx_exp.launches += 1
    return out


fx_exp.launches = 0


def to_fx(x_float) -> np.ndarray:
    """float -> int32 s16.15, rounding half to even in float32."""
    return np.round(np.asarray(x_float, np.float32)
                    * np.float32(FX_ONE)).astype(np.int32)
