"""``lif_step`` wrapper (CPU: plain version, CUDA: ``csrc/lif.cu``) and
the fixed-point LIF parameters."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels._wrap import expect_dtype, on_cpu
from repro_torch.kernels.explog.ops import fx_exp, to_fx
from repro_torch.kernels.lif.ref import lif_step_ref

_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int64,) + (ctypes.c_int32,) * 6
         + (ctypes.c_void_p,))


def lif_params_fx(*, tau_ms: float, v_th: float, v_reset: float,
                  ref_ticks: int, dt_ms: float = 1.0,
                  v_min: float | None = None, device=None) -> dict:
    """Fixed-point LIF parameters; alpha from the exp accelerator kernel,
    run on ``device`` (the CUDA device unless the caller asks for the
    CPU).  ``v_min`` is the optional inhibitory-reversal floor (see
    ``lif_step_ref``)."""
    arg = torch.tensor([int(to_fx(np.float32(-dt_ms / tau_ms)))],
                       dtype=torch.int32, device=resolve_device(device))
    alpha = int(fx_exp(arg)[0])
    return dict(alpha=alpha, v_th=int(to_fx(v_th)),
                v_reset=int(to_fx(v_reset)), ref_ticks=int(ref_ticks),
                v_min=None if v_min is None else int(to_fx(v_min)))


def lif_step(v, ref_ct, i_syn, *, alpha, v_th, v_reset, ref_ticks,
             v_min=None):
    """v, ref_ct, i_syn: int32 tensors of one shape.  Returns (v', ref',
    spikes), int32 of the same shape."""
    expect_dtype("lif_step", torch.int32, v=v, ref_ct=ref_ct, i_syn=i_syn)
    if not v.shape == ref_ct.shape == i_syn.shape:
        raise ValueError(f"lif_step: shapes differ {v.shape}, "
                         f"{ref_ct.shape}, {i_syn.shape}")
    kw = dict(alpha=alpha, v_th=v_th, v_reset=v_reset, ref_ticks=ref_ticks,
              v_min=v_min)
    if on_cpu("lif_step", v, ref_ct, i_syn):
        return lif_step_ref(v, ref_ct, i_syn, **kw)
    outs = [torch.empty_like(v) for _ in range(3)]
    if v.numel():
        rc = _build.launcher("repro_lif_step", _ARGS)(
            v.data_ptr(), ref_ct.data_ptr(), i_syn.data_ptr(),
            *(o.data_ptr() for o in outs), v.numel(), alpha, v_th, v_reset,
            ref_ticks, int(v_min is not None),
            0 if v_min is None else v_min, _build.stream_ptr(v.device))
        _build.check(rc, "lif_step")
        lif_step.launches += 1
    return tuple(outs)


lif_step.launches = 0
