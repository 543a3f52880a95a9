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
(CPU: ``wkv6_bwd_ref``; CUDA, by shape with no knob (``bwd_route``): the
same rule as the forward's, head size 64 and at least 64 positions, takes
``csrc/wkv6_bwd_chunked.cu``'s kernels, every other shape of head
sizes ``BWD_HEAD_SIZES`` ``csrc/wkv6_bwd.cu``'s walk)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import expect_dtype, on_cpu
from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref, wkv6_ref

_ARGS = (ctypes.c_void_p,) * 8 + (ctypes.c_int32,) * 5 + (ctypes.c_void_p,)
_BWD_ARGS = (ctypes.c_void_p,) * 15 + (ctypes.c_int32,) * 6 + (
    ctypes.c_void_p,)
_BWD_CHUNKED_ARGS = (ctypes.c_void_p,) * 18 + (ctypes.c_int32,) * 6 + (
    ctypes.c_void_p,)
HEAD_SIZES = (8, 16, 32, 64, 128)     # the sequential kernel's instantiations
BWD_HEAD_SIZES = (8, 16, 32, 64)      # the backward walk's
CHUNKED_D, CHUNK = 64, 64             # the chunked kernels' head size, chunk
SUB_CHUNKS = 4                        # the chunked backward's du partials a chunk
# up to this many chunks a (batch, head) the chunked backward's scans run
# in its state kernel's last block (one SM a (batch, head)); past it in a
# kernel of their own (8 blocks a (batch, head)), whose bandwidth a long
# scan needs.  The crossover by ``scripts/recurrent_bwd_check.py
# --scans``: at 256 (batch, head) pairs the fused scans are ahead up to 3
# chunks and even at 4; at 8 and 64 pairs a few µs behind at any count
FUSED_SCAN_CHUNKS = 3
_DTYPES = (torch.float32, torch.bfloat16)


def route(S: int, D: int) -> str:
    """The kernel a CUDA call of S positions at head size D launches."""
    return "chunked" if D == CHUNKED_D and S >= CHUNK else "sequential"


def bwd_route(S: int, D: int) -> str:
    """The kernels a CUDA backward of S positions at head size D launches:
    "chunked" (``csrc/wkv6_bwd_chunked.cu``) where the forward takes its
    chunked kernel, else "walk" (``csrc/wkv6_bwd.cu``)."""
    return "chunked" if D == CHUNKED_D and S >= CHUNK else "walk"


def bwd_launches(S: int, D: int) -> int:
    """Kernels a CUDA ``wkv6_bwd`` call of S positions at head size D
    launches: the chunked route's two (the chunks' own states and
    cotangents with the two scans over the chunks, then the chunks'
    gradients; past ``FUSED_SCAN_CHUNKS`` chunks the scans take a kernel
    of their own: three), the walk's one."""
    if bwd_route(S, D) == "walk":
        return 1
    return 2 if -(-S // CHUNK) <= FUSED_SCAN_CHUNKS else 3


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
    """Positions a chunk of ``wkv6_bwd_kernel`` (the walk) at head size D:
    its checkpoints of the state, and the states it rebuilds at once."""
    return 4 if D >= 64 else 16


def wkv6_bwd(r, k, v, lw, u, state0, dy, dstate):
    """The backward of ``wkv6``: its inputs and the cotangents dy (B, S,
    H, D) and dstate (B, H, D, D), float32 -> (dr, dk, dv in r's dtype,
    dlw (B, S, H, D), du (H, D), dstate0 (B, H, D, D) float32).  CPU
    tensors: the plain version ``wkv6_bwd_ref``; CUDA tensors: the kernels
    of ``bwd_route(S, D)``, each launch counted in ``launches`` (and by
    route in ``route_launches``).  No sum takes an atomic: two calls give
    the same bits.

    "chunked" (D 64, S >= 64): ``wkv6_bwd_state_kernel`` (a block a
    (batch, head, chunk of 64): the chunk's own state and cotangent; the
    last block of a (batch, head) then scans its chunks for the states at
    their starts and the cotangents at their ends, or past
    ``FUSED_SCAN_CHUNKS`` chunks ``wkv6_bwd_scan_kernel`` does) and
    ``wkv6_bwd_chunk_kernel`` (a block a chunk: its gradients, the
    products in 3xTF32 on the tensor cores); du's partials, a (batch,
    head, chunk, sub-chunk), summed here.  The gradients agree with the
    plain version within 2^-16 of their largest magnitudes (another
    summation order; dlw by the running-sum identity restarted at every
    chunk).
    "walk": ``wkv6_bwd_kernel`` (a block a (batch, head): a forward walk
    that checkpoints the state every ``bwd_chunk(D)`` positions, then a
    backward walk a chunk at a time that rebuilds the chunk's states from
    its checkpoint; each block's du partial, summed over the batch here);
    dstate0 bit for bit the plain version's."""
    _check(r, k, v, lw, u, state0)
    expect_dtype("wkv6_bwd", torch.float32, dy=dy, dstate=dstate)
    if dy.shape != r.shape or dstate.shape != state0.shape:
        raise ValueError(f"wkv6_bwd: dy {tuple(dy.shape)} and dstate "
                         f"{tuple(dstate.shape)} for r {tuple(r.shape)}")
    if on_cpu("wkv6_bwd", r, k, v, lw, u, state0, dy, dstate):
        return wkv6_bwd_ref(r, k, v, lw, u, state0, dy, dstate)
    B, S, H, D = r.shape
    return _bwd_kernels(bwd_route(S, D), r, k, v, lw, u, state0, dy, dstate)


def _bwd_kernels(which, r, k, v, lw, u, state0, dy, dstate, fused=None):
    """``wkv6_bwd`` on CUDA tensors through route ``which``'s kernels
    (``wkv6_bwd`` takes ``bwd_route``'s; the walk runs any shape of head
    sizes ``BWD_HEAD_SIZES``, the chunked route D 64 and S >= 64).
    ``fused``, on the chunked route: the scans in the state kernel's last
    blocks (True) or in their own kernel (False); None takes
    ``bwd_launches``' rule, as ``wkv6_bwd`` does (the other choice is for
    measuring the rule)."""
    B, S, H, D = r.shape
    if D not in BWD_HEAD_SIZES:
        raise ValueError(f"wkv6_bwd: head size {D} not one of "
                         f"{BWD_HEAD_SIZES}")
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dlw = torch.empty_like(lw)
    dstate0 = torch.empty_like(state0)
    if not state0.numel():
        return dr, dk, dv, dlw, torch.zeros_like(u), dstate0
    bf16 = int(r.dtype == torch.bfloat16)
    stream = _build.stream_ptr(r.device)
    f32 = dict(dtype=torch.float32, device=r.device)
    if which == "chunked":
        if D != CHUNKED_D or S < CHUNK:
            raise ValueError(f"wkv6_bwd: the chunked route takes head size "
                             f"{CHUNKED_D} and at least {CHUNK} positions, "
                             f"not {D} and {S}")
        args = (r, k, v, lw, u, state0, dy, dstate, dr, dk, dv, dlw)
        if any(t.data_ptr() % 16 for t in args):
            raise ValueError("wkv6_bwd: the chunked kernels load 16-byte "
                             "pieces: every tensor must start 16-byte "
                             "aligned")
        N = -(-S // CHUNK)
        if fused is None:
            fused = N <= FUSED_SCAN_CHUNKS
        du_part = torch.empty((B, H, N * SUB_CHUNKS, D), **f32)
        # the chunks' states (slot N: the final state) and end cotangents
        sbuf = torch.empty((B * H, N + 1, D, D), **f32)
        dsbuf = torch.empty((B * H, N, D, D), **f32)
        decay = torch.empty((B * H, N, D), **f32)
        # each (batch, head)'s count of finished chunk blocks (zeroed by
        # the launcher when the scans are fused)
        done = torch.empty(B * H, dtype=torch.int32, device=r.device)
        rc = _build.launcher("repro_wkv6_bwd_chunked", _BWD_CHUNKED_ARGS)(
            *(t.data_ptr() for t in (*args, du_part, dstate0, sbuf, dsbuf,
                                     decay, done)),
            B, S, H, D, bf16, int(fused), stream)
        du_sum = (0, 2)
        n = 2 if fused else 3
    else:
        du_part = torch.empty((B, H, D), **f32)
        chunk = bwd_chunk(D)
        ckpt = torch.empty((B * H, -(-S // chunk), D, D), **f32)
        rc = _build.launcher("repro_wkv6_bwd", _BWD_ARGS)(
            *(t.data_ptr() for t in (r, k, v, lw, u, state0, dy, dstate, dr,
                                     dk, dv, dlw, du_part, dstate0, ckpt)),
            B, S, H, D, chunk, bf16, stream)
        du_sum = (0,)
        n = 1
    _build.check(rc, "wkv6_bwd")
    wkv6_bwd.launches += n
    wkv6_bwd.route_launches[which] += n
    return dr, dk, dv, dlw, du_part.sum(du_sum), dstate0


wkv6.launches = 0
wkv6_bwd.launches = 0
# launches by route ("sequential", "chunked"; "walk", "chunked"), zeroed
# with ``launches``
wkv6.route_launches = {"sequential": 0, "chunked": 0}
wkv6_bwd.route_launches = {"walk": 0, "chunked": 0}
