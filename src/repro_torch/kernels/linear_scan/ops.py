"""``linear_scan`` wrapper (CPU: plain version, CUDA:
``csrc/linear_scan.cu``): RecurrentGemma's RG-LRU recurrence.  No Pallas
counterpart: the reference scans with ``jax.lax.associative_scan``.

When an input requires grad (under grad mode) the call goes through
``LinearScan``, a ``torch.autograd.Function`` whose backward is
``linear_scan_bwd`` (CPU: ``linear_scan_bwd_ref``, CUDA:
``linear_scan_bwd_kernel``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import expect_dtype, on_cpu
from repro_torch.kernels.linear_scan.ref import (linear_scan_bwd_ref,
                                                 linear_scan_ref)

_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int32,) * 3 + (ctypes.c_void_p,)
_BWD_ARGS = (ctypes.c_void_p,) * 13 + (ctypes.c_int32,) * 3 + (
    ctypes.c_void_p,)
_MAX_BATCH = 65535                 # gridDim.y: one row of blocks a batch


def linear_scan(xi, xa, u, lam, h0):
    """The RG-LRU's gates and recurrence in one pass.  xi, xa: the input
    and decay gates' pre-activations (B, S, w); u: the recurrence's input
    (B, S, w); lam: (w,); h0: (B, w); all float32.  Returns (y (B, S, w),
    h_final (B, w)) float32: h_t = a_t h_{t-1} + b_t with
    a_t = exp(-8 softplus(lam) sigmoid(xa_t)) and
    b_t = sqrt(max(1 - a_t^2, 1e-12)) sigmoid(xi_t) u_t, y_t = h_t.
    Differentiable in every input."""
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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xi, xa, u, lam, h0)):
        return LinearScan.apply(xi, xa, u, lam, h0)
    return _scan(xi, xa, u, lam, h0)


def _scan(xi, xa, u, lam, h0):
    if on_cpu("linear_scan", xi, xa, u, lam, h0):
        return linear_scan_ref(xi, xa, u, lam, h0)
    B, S, W = u.shape
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


class LinearScan(torch.autograd.Function):
    """``linear_scan`` with its backward: the forward saves its inputs
    and y, the backward is ``linear_scan_bwd``."""

    @staticmethod
    def forward(ctx, xi, xa, u, lam, h0):
        y, h_final = _scan(xi, xa, u, lam, h0)
        ctx.save_for_backward(xi, xa, u, lam, h0, y)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        return linear_scan_bwd(*ctx.saved_tensors, dy.contiguous(),
                               dh_final.contiguous())


def linear_scan_bwd(xi, xa, u, lam, h0, y, dy, dh_final):
    """The backward of ``linear_scan``: its inputs, its output y and the
    cotangents dy (B, S, w) and dh_final (B, w), float32 -> (dxi, dxa, du
    (B, S, w), dlam (w,), dh0 (B, w)).  CPU tensors: the plain version
    ``linear_scan_bwd_ref``; CUDA tensors: ``linear_scan_bwd_kernel``
    (the reverse scan and every derivative in one pass, a block per
    (batch, 32 channels); each block's dlam partial, summed over the
    batch here), counted in ``launches``.  No atomics: two calls give the
    same bits."""
    expect_dtype("linear_scan_bwd", torch.float32, y=y, dy=dy,
                 dh_final=dh_final)
    if y.shape != u.shape or dy.shape != u.shape \
            or dh_final.shape != h0.shape:
        raise ValueError(f"linear_scan_bwd: y {tuple(y.shape)}, dy "
                         f"{tuple(dy.shape)}, dh_final "
                         f"{tuple(dh_final.shape)} for u {tuple(u.shape)}")
    if on_cpu("linear_scan_bwd", xi, xa, u, lam, h0, y, dy, dh_final):
        return linear_scan_bwd_ref(xi, xa, u, lam, h0, y, dy, dh_final)
    B, S, W = u.shape
    if B > _MAX_BATCH:
        raise ValueError(f"linear_scan_bwd: batch {B} > {_MAX_BATCH}")
    dxi, dxa, du = (torch.empty_like(u) for _ in range(3))
    dlam_part = torch.empty_like(h0)
    dh0 = torch.empty_like(h0)
    if not h0.numel():
        return dxi, dxa, du, torch.zeros_like(lam), dh0
    rc = _build.launcher("repro_linear_scan_bwd", _BWD_ARGS)(
        *(t.data_ptr() for t in (xi, xa, u, lam, h0, y, dy, dh_final, dxi,
                                 dxa, du, dlam_part, dh0)),
        B, S, W, _build.stream_ptr(u.device))
    _build.check(rc, "linear_scan_bwd")
    linear_scan_bwd.launches += 1
    return dxi, dxa, du, dlam_part.sum(0), dh0


linear_scan.launches = 0
linear_scan_bwd.launches = 0
