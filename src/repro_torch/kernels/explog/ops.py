"""``fx_exp`` and ``fx_log`` wrappers (CPU: plain versions, CUDA:
``csrc/explog.cu``) and float <-> s16.15 helpers."""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels._wrap import expect_dtype, on_cpu
from repro_torch.kernels.explog.ref import (FX_ONE, LN2, fx_exp_ref,
                                            fx_log_ref)

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p)
_TABLE_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
_MANT_ARGS = _TABLE_ARGS[:4] + (ctypes.c_int,) + _TABLE_ARGS[4:]
_BUILD_ARGS = (ctypes.c_void_p,) * 4

# fx_exp's table on the card (``csrc/explog.cu``): for each residue r in
# [0, LN2) the mantissa minus floor(2^15 exp(r 2^-15)) as the card's
# ex2.approx gives it, int8, padded to whole 16-byte words
EXP_TABLE_ENTRIES = 22720
# fx_exp's routes by element count: the ladder below, the shared-memory
# table from here on.  Measured on an H100 (device time a launch, L2
# flushed; chip_smoke.py's fx_exp_routes line): at one element ladder
# 1.88-1.97 us, table 2.03-2.16; at 2^14 either within 0.15 of the
# other; at 2^15 ladder 2.24-2.28, table 2.22-2.25; at 2^18 ladder 3.33,
# table 2.76-2.94; at 2^20 ladder 8.53-8.62, table 4.5-5.5.  The table
# route runs a persistent grid of this many blocks an SM
EXP_TABLE_MIN_N = 1 << 15
EXP_TABLE_BLOCKS_PER_SM = 2

_exp_tables: dict = {}


def exp_tables(device: torch.device) -> tuple:
    """fx_exp's tables on CUDA ``device``, built by one kernel at the
    first call for the device and kept: the route's int8 corrections and
    the uint16 mantissas M[r] of the measured alternative
    (``fx_exp_mantissa_launch``).  The build counts the residues that
    break what the table route relies on (a remainder left by the ladder,
    a mantissa outside [2^15, 2^16), a correction outside int8) and
    raises on any; that check waits for the card, once."""
    tables = _exp_tables.get(device)
    if tables is None:
        tables = (torch.empty(EXP_TABLE_ENTRIES, dtype=torch.int8,
                              device=device),
                  torch.empty(EXP_TABLE_ENTRIES, dtype=torch.uint16,
                              device=device))
        bad = torch.zeros(1, dtype=torch.int32, device=device)
        rc = _build.launcher("repro_fx_exp_build_table", _BUILD_ARGS)(
            tables[0].data_ptr(), tables[1].data_ptr(), bad.data_ptr(),
            _build.stream_ptr(device))
        _build.check(rc, "fx_exp table")
        if int(bad) != 0:
            raise RuntimeError(f"fx_exp table: {int(bad)} of {LN2} "
                               f"residues leave a remainder, a mantissa "
                               f"outside [2^15, 2^16) or a correction "
                               f"outside int8")
        _exp_tables[device] = tables
    return tables


def exp_table(device: torch.device) -> torch.Tensor:
    """fx_exp's int8 correction table on CUDA ``device``."""
    return exp_tables(device)[0]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def exp_route(n: int) -> str:
    """fx_exp's kernel for ``n`` elements: "ladder" or "table"."""
    return "table" if n >= EXP_TABLE_MIN_N else "ladder"


def fx_exp_launch(x: torch.Tensor, out: torch.Tensor, route: str) -> None:
    """Launch fx_exp's ``route`` kernel on contiguous int32 CUDA ``x``
    into ``out`` (uncounted: ``fx_exp`` counts its own launches)."""
    stream = _build.stream_ptr(x.device)
    if route == "ladder":
        rc = _build.launcher("repro_fx_exp_ladder", _ARGS)(
            x.data_ptr(), out.data_ptr(), x.numel(), stream)
    else:
        blocks = EXP_TABLE_BLOCKS_PER_SM * _sm_count(x.device.index)
        rc = _build.launcher("repro_fx_exp_table", _TABLE_ARGS)(
            x.data_ptr(), out.data_ptr(), x.numel(),
            exp_table(x.device).data_ptr(), blocks, stream)
    _build.check(rc, "fx_exp")


def fx_exp_mantissa_launch(x: torch.Tensor, out: torch.Tensor,
                           multicast: bool) -> None:
    """Launch the uint16 mantissa-table kernel on contiguous int32 CUDA
    ``x`` into ``out``: the design the table route is measured against,
    on no path.  ``multicast``: clusters of four blocks share one load of
    the table.  Same grid as the table route."""
    blocks = EXP_TABLE_BLOCKS_PER_SM * _sm_count(x.device.index)
    rc = _build.launcher("repro_fx_exp_mantissa", _MANT_ARGS)(
        x.data_ptr(), out.data_ptr(), x.numel(),
        exp_tables(x.device)[1].data_ptr(), int(multicast), blocks,
        _build.stream_ptr(x.device))
    _build.check(rc, "fx_exp mantissa")


def fx_exp(x: torch.Tensor) -> torch.Tensor:
    """x: int32 s16.15, any shape -> exp(x) int32 s16.15."""
    expect_dtype("fx_exp", torch.int32, x=x)
    if on_cpu("fx_exp", x):
        return fx_exp_ref(x)
    out = torch.empty_like(x)
    if x.numel():
        fx_exp_launch(x, out, exp_route(x.numel()))
        fx_exp.launches += 1
    return out


def fx_log(x: torch.Tensor) -> torch.Tensor:
    """x: int32 s16.15, any shape, > 0 -> ln(x) int32 s16.15 (x <= 0 ->
    -2^30)."""
    expect_dtype("fx_log", torch.int32, x=x)
    if on_cpu("fx_log", x):
        return fx_log_ref(x)
    out = torch.empty_like(x)
    if x.numel():
        rc = _build.launcher("repro_fx_log", _ARGS)(
            x.data_ptr(), out.data_ptr(), x.numel(),
            _build.stream_ptr(x.device))
        _build.check(rc, "fx_log")
        fx_log.launches += 1
    return out


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
