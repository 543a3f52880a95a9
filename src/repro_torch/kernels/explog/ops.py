"""``fx_exp`` and ``fx_log`` wrappers (CPU: plain versions, CUDA:
``csrc/explog.cu``) and float <-> s16.15 helpers."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels._wrap import expect_dtype, on_cpu
from repro_torch.kernels.explog.ref import FX_ONE, fx_exp_ref, fx_log_ref

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p)


def _elementwise(fn, launcher: str, plain, x: torch.Tensor) -> torch.Tensor:
    """Run ``fn``'s kernel over int32 ``x`` of any shape, or its plain
    version on the CPU; counts the launch on ``fn``."""
    name = fn.__name__
    expect_dtype(name, torch.int32, x=x)
    if on_cpu(name, x):
        return plain(x)
    out = torch.empty_like(x)
    if x.numel():
        rc = _build.launcher(launcher, _ARGS)(
            x.data_ptr(), out.data_ptr(), x.numel(),
            _build.stream_ptr(x.device))
        _build.check(rc, name)
        fn.launches += 1
    return out


def fx_exp(x: torch.Tensor) -> torch.Tensor:
    """x: int32 s16.15, any shape -> exp(x) int32 s16.15."""
    return _elementwise(fx_exp, "repro_fx_exp", fx_exp_ref, x)


def fx_log(x: torch.Tensor) -> torch.Tensor:
    """x: int32 s16.15, any shape, > 0 -> ln(x) int32 s16.15 (x <= 0 ->
    -2^30)."""
    return _elementwise(fx_log, "repro_fx_log", fx_log_ref, x)


fx_exp.launches = 0
fx_log.launches = 0


def to_fx(x_float) -> np.ndarray:
    """float -> int32 s16.15, rounding half to even in float32."""
    return np.round(np.asarray(x_float, np.float32)
                    * np.float32(FX_ONE)).astype(np.int32)


def from_fx(x_fx: torch.Tensor) -> torch.Tensor:
    """int32 s16.15 -> float32 (exact: a division by 2^15)."""
    return x_fx.to(torch.float32) / FX_ONE


def fx_log_float(x_float, device=None) -> torch.Tensor:
    """ln of floats through the s16.15 accelerator: round to s16.15 half
    to even in float32, ``fx_log``, back to float32. A tensor stays on
    its own device; an array-like goes to ``device`` (None: the card)."""
    if isinstance(x_float, torch.Tensor):
        x = x_float.to(torch.float32)
    else:
        x = torch.as_tensor(x_float, dtype=torch.float32,
                            device=resolve_device(device))
    return from_fx(fx_log(torch.round(x * FX_ONE).to(torch.int32)))
