"""``linear_scan`` wrapper (CPU: plain version, CUDA:
``csrc/linear_scan.cu``): RecurrentGemma's RG-LRU recurrence.  No Pallas
counterpart: the reference scans with ``jax.lax.associative_scan``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import expect_dtype, on_cpu, refuse_grad
from repro_torch.kernels.linear_scan.ref import linear_scan_ref

_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int32,) * 3 + (ctypes.c_void_p,)
_MAX_BATCH = 65535                 # gridDim.y: one row of blocks a batch


def linear_scan(xi, xa, u, lam, h0):
    """The RG-LRU's gates and recurrence in one pass.  xi, xa: the input
    and decay gates' pre-activations (B, S, w); u: the recurrence's input
    (B, S, w); lam: (w,); h0: (B, w); all float32.  Returns (y (B, S, w),
    h_final (B, w)) float32: h_t = a_t h_{t-1} + b_t with
    a_t = exp(-8 softplus(lam) sigmoid(xa_t)) and
    b_t = sqrt(max(1 - a_t^2, 1e-12)) sigmoid(xi_t) u_t, y_t = h_t."""
    expect_dtype("linear_scan", torch.float32, xi=xi, xa=xa, u=u, lam=lam,
                 h0=h0)
    if u.dim() != 3 or xi.shape != u.shape or xa.shape != u.shape:
        raise ValueError(f"linear_scan: xi, xa, u must share one (B, S, w) "
                         f"shape, got {tuple(xi.shape)}, {tuple(xa.shape)}, "
                         f"{tuple(u.shape)}")
    B, S, W = u.shape
    if tuple(lam.shape) != (W,) or tuple(h0.shape) != (B, W):
        raise ValueError(f"linear_scan: lam {tuple(lam.shape)} and h0 "
                         f"{tuple(h0.shape)} for u {tuple(u.shape)}")
    if on_cpu("linear_scan", xi, xa, u, lam, h0):
        return linear_scan_ref(xi, xa, u, lam, h0)
    refuse_grad("linear_scan", xi, xa, u, lam, h0)
    if B > _MAX_BATCH:
        raise ValueError(f"linear_scan: batch {B} > {_MAX_BATCH}")
    y = torch.empty_like(u)
    h_final = torch.empty_like(h0)
    if h0.numel():
        rc = _build.launcher("repro_linear_scan", _ARGS)(
            xi.data_ptr(), xa.data_ptr(), u.data_ptr(), lam.data_ptr(),
            h0.data_ptr(), y.data_ptr(), h_final.data_ptr(), B, S, W,
            _build.stream_ptr(u.device))
        _build.check(rc, "linear_scan")
        linear_scan.launches += 1
    return y, h_final


linear_scan.launches = 0
