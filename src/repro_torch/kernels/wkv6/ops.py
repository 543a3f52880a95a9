"""``wkv6`` wrapper (CPU: plain version, CUDA: ``csrc/wkv6.cu``): RWKV-6's
WKV recurrence.  No Pallas counterpart: the reference runs chunked
einsums (prefill) and a ``lax.scan`` (decode).

On a CUDA tensor the shape picks the kernel, with no knob: head size
``CHUNKED_D`` (64, every RWKV-6's) and at least ``CHUNK`` (64) positions
take the chunked kernel (``wkv6_chunked_kernel``, prefill); every other
shape, decode's S = 1 among them, the sequential one (``wkv6_kernel``),
whose state equals the plain version's bit for bit.  The chunked route's
y and state agree with the plain version within 2^-16 of their largest
magnitudes (another summation order).

When an input requires grad (under grad mode) the call goes through
``WKV6``, a ``torch.autograd.Function`` whose backward is ``wkv6_bwd``
(CPU: ``wkv6_bwd_ref``, CUDA: ``csrc/wkv6_bwd.cu``'s
``wkv6_bwd_kernel``, head sizes ``BWD_HEAD_SIZES``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import expect_dtype, on_cpu
from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref, wkv6_ref

_ARGS = (ctypes.c_void_p,) * 8 + (ctypes.c_int32,) * 5 + (ctypes.c_void_p,)
_BWD_ARGS = (ctypes.c_void_p,) * 15 + (ctypes.c_int32,) * 6 + (
    ctypes.c_void_p,)
HEAD_SIZES = (8, 16, 32, 64, 128)     # the sequential kernel's instantiations
BWD_HEAD_SIZES = (8, 16, 32, 64)      # the backward kernel's
CHUNKED_D, CHUNK = 64, 64             # the chunked kernel's head size, chunk
_DTYPES = (torch.float32, torch.bfloat16)


def route(S: int, D: int) -> str:
    """The kernel a CUDA call of S positions at head size D launches."""
    return "chunked" if D == CHUNKED_D and S >= CHUNK else "sequential"


def wkv6(r, k, v, lw, u, state0):
    """r, k, v: (B, S, H, D) float32 or bfloat16 (one dtype); lw: (B, S,
    H, D) float32 log decay (<= 0); u: (H, D) float32 bonus; state0: (B,
    H, D, D) float32, k index first.  Returns (y (B, S, H, D) float32,
    the final state (B, H, D, D) float32), the recurrence of
    ``wkv6_ref``.  Differentiable in every input."""
    _check(r, k, v, lw, u, state0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, lw, u, state0)):
        return WKV6.apply(r, k, v, lw, u, state0)
    return _forward(r, k, v, lw, u, state0)


def _check(r, k, v, lw, u, state0) -> None:
    if not (r.dtype == k.dtype == v.dtype and r.dtype in _DTYPES):
        raise TypeError(f"wkv6: r, k, v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    expect_dtype("wkv6", torch.float32, lw=lw, u=u, state0=state0)
    if r.dim() != 4 or not r.shape == k.shape == v.shape == lw.shape:
        raise ValueError(f"wkv6: r, k, v, lw must share one (B, S, H, D) "
                         f"shape, got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(lw.shape)}")
    B, S, H, D = r.shape
    if tuple(u.shape) != (H, D) or tuple(state0.shape) != (B, H, D, D):
        raise ValueError(f"wkv6: u {tuple(u.shape)} and state0 "
                         f"{tuple(state0.shape)} for r {tuple(r.shape)}")


def _forward(r, k, v, lw, u, state0):
    if on_cpu("wkv6", r, k, v, lw, u, state0):
        return wkv6_ref(r, k, v, lw, u, state0)
    B, S, H, D = r.shape
    if D not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {D} not one of {HEAD_SIZES}")
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    state = torch.empty_like(state0)
    if state0.numel():
        which = route(S, D)
        args = (r, k, v, lw, u, state0, y, state)
        if which == "chunked" and any(t.data_ptr() % 16 for t in args):
            raise ValueError("wkv6: the chunked kernel copies 16-byte "
                             "pieces: every tensor must start 16-byte "
                             "aligned")
        name = "repro_wkv6_chunked" if which == "chunked" else "repro_wkv6"
        rc = _build.launcher(name, _ARGS)(
            *(t.data_ptr() for t in args), B, S, H, D,
            int(r.dtype == torch.bfloat16), _build.stream_ptr(r.device))
        _build.check(rc, "wkv6")
        wkv6.launches += 1
        wkv6.route_launches[which] += 1
    return y, state


class WKV6(torch.autograd.Function):
    """``wkv6`` with its backward: the forward saves its inputs, the
    backward is ``wkv6_bwd``."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, state0):
        if r.is_cuda and r.shape[3] not in BWD_HEAD_SIZES:
            raise ValueError(f"wkv6: the backward kernel takes head sizes "
                             f"{BWD_HEAD_SIZES}, not {r.shape[3]}")
        ctx.save_for_backward(r, k, v, lw, u, state0)
        return _forward(r, k, v, lw, u, state0)

    @staticmethod
    def backward(ctx, dy, dstate):
        return wkv6_bwd(*ctx.saved_tensors, dy.contiguous(),
                        dstate.contiguous())


def bwd_chunk(D: int) -> int:
    """Positions a chunk of ``wkv6_bwd_kernel`` at head size D: its
    checkpoints of the state, and the states it rebuilds at once."""
    return 4 if D >= 64 else 16


def wkv6_bwd(r, k, v, lw, u, state0, dy, dstate):
    """The backward of ``wkv6``: its inputs and the cotangents dy (B, S,
    H, D) and dstate (B, H, D, D), float32 -> (dr, dk, dv in r's dtype,
    dlw (B, S, H, D), du (H, D), dstate0 (B, H, D, D) float32).  CPU
    tensors: the plain version ``wkv6_bwd_ref``; CUDA tensors:
    ``wkv6_bwd_kernel`` (a block per (batch, head): a forward walk that
    checkpoints the state every ``bwd_chunk(D)`` positions, then a
    backward walk a chunk at a time that rebuilds the chunk's states from
    its checkpoint; each block's du partial, summed over the batch here),
    counted in ``launches``.  No atomics: two calls give the same bits."""
    _check(r, k, v, lw, u, state0)
    expect_dtype("wkv6_bwd", torch.float32, dy=dy, dstate=dstate)
    if dy.shape != r.shape or dstate.shape != state0.shape:
        raise ValueError(f"wkv6_bwd: dy {tuple(dy.shape)} and dstate "
                         f"{tuple(dstate.shape)} for r {tuple(r.shape)}")
    if on_cpu("wkv6_bwd", r, k, v, lw, u, state0, dy, dstate):
        return wkv6_bwd_ref(r, k, v, lw, u, state0, dy, dstate)
    B, S, H, D = r.shape
    if D not in BWD_HEAD_SIZES:
        raise ValueError(f"wkv6_bwd: head size {D} not one of "
                         f"{BWD_HEAD_SIZES}")
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dlw = torch.empty_like(lw)
    dstate0 = torch.empty_like(state0)
    du_part = torch.empty((B, H, D), dtype=torch.float32, device=r.device)
    if not state0.numel():
        return dr, dk, dv, dlw, torch.zeros_like(u), dstate0
    chunk = bwd_chunk(D)
    ckpt = torch.empty((B * H, -(-S // chunk), D, D), dtype=torch.float32,
                       device=r.device)
    rc = _build.launcher("repro_wkv6_bwd", _BWD_ARGS)(
        *(t.data_ptr() for t in (r, k, v, lw, u, state0, dy, dstate, dr, dk,
                                 dv, dlw, du_part, dstate0, ckpt)),
        B, S, H, D, chunk, int(r.dtype == torch.bfloat16),
        _build.stream_ptr(r.device))
    _build.check(rc, "wkv6_bwd")
    wkv6_bwd.launches += 1
    return dr, dk, dv, dlw, du_part.sum(0), dstate0


wkv6.launches = 0
wkv6_bwd.launches = 0
# launches by route ("sequential", "chunked"), zeroed with ``launches``
wkv6.route_launches = {"sequential": 0, "chunked": 0}
