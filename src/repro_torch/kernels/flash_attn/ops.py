"""``flash_attention_kernel`` wrapper (CPU: plain version, CUDA:
``csrc/flash_attn.cu``), differentiable: ``flash_attention_bwd`` (CUDA:
``csrc/flash_attn_bwd.cu``) is its backward.

Forward routes, by dtype and head size alone: bfloat16 at D <= 128
``flash_attn_wgmma_kernel`` (one warpgroup of 64 query rows a block, two
blocks an SM), at 128 < D <= 256 ``flash_attn_wgmma_d256_kernel`` (a TMA
producer warpgroup and two consumer warpgroups that share each K/V tile);
float32 at D <= 128 ``flash_attn_tf32_kernel``, at 128 < D <= 256
``flash_attn_tf32_d256_kernel`` (both 3xTF32 ``wgmma``).  Every route
reads K and V at their own head count.

When q, k or v requires grad (under grad mode), the call goes through
``FlashAttention``, a ``torch.autograd.Function``: its forward also
writes each row's log-sum-exp and saves (q, k, v, o, lse), its backward
is ``flash_attention_bwd`` (kernels on CUDA tensors, D <= 128, routed by
``bwd_route``; ``flash_attention_bwd_ref`` on CPU tensors), the
reference model attention's recompute-from-lse backward.  Otherwise
nothing is saved and no lse is written: serving runs the kernels as they
were."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import on_cpu
from repro_torch.kernels.flash_attn.ref import (flash_attention_bwd_ref,
                                                flash_attention_ref)

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int32,) * 5 + (
    ctypes.c_float, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ctypes.c_void_p, ctypes.c_void_p)
_DELTA_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int32,) * 5 + (
    ctypes.c_void_p,)
_BWD_ARGS = lambda n_ptrs: (ctypes.c_void_p,) * n_ptrs + (
    ctypes.c_int32,) * 5 + (ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
                            ctypes.c_int32, ctypes.c_void_p)
_PREP_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int32,) * 5 + (
    ctypes.c_void_p,)
_WB_ARGS = lambda n_ptrs: (ctypes.c_void_p,) * n_ptrs + (
    ctypes.c_int32,) * 6 + (ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
                            ctypes.c_void_p)
_REDUCE_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int32,) * 6 + (
    ctypes.c_void_p,)
_DTYPES = (torch.float32, torch.bfloat16)
_WB_BLOCK = 128                    # rows of a wgmma backward block
MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 128
_MAX_HEADS = 65535                 # gridDim.y: one row of blocks per (b, h)


def flash_attention_kernel(q, k, v, *, causal=True, window=0, bq=128,
                           bk=128):
    """q: (B, S, H, D), k, v: (B, S, H_kv, D) with H % H_kv == 0, float32
    or bfloat16 -> (B, S, H, D) softmax attention in q's dtype, scale
    1/sqrt(D), float32 inside.  Query head h meets KV head h // (H / H_kv)
    (the reference's model attention's grouping, ``bqhgd,bkhd``); H_kv == H
    is plain multi-head attention, and K and V expanded to every query
    head give the same result as the unexpanded ones.  The kernels read
    the KV head in place; the plain version expands K and V first.
    ``window`` > 0 is a sliding window: query i sees keys j > i - window
    (the reference's model attention's band); the kernels start each
    query tile's kv loop at the first tile inside the band.  0 leaves the
    plain causal (or full) attention.  Differentiable in q, k and v (the
    backward at D <= 128 on the card).

    ``bq`` and ``bk`` are the reference's query and kv block sizes, kept
    for parity of the signature and ignored: the kernels tile 64 or 128
    query rows against kv tiles of 64 (bfloat16) or 32 (float32) rows and
    bounds-check any S, so the result does not depend on them.  D is at
    most 256."""
    _check(q, k, v)
    window = int(window)
    if window < 0:
        raise ValueError(f"flash_attention_kernel: window {window} < 0")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal), window)
    return _forward(q, k, v, causal, window, False)[0]


def _check(q, k, v) -> None:
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES):
        raise TypeError(f"flash_attention_kernel: q, k, v must all be "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if (q.dim() != 4 or k.shape != v.shape or k.dim() != 4
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]):
        raise ValueError(f"flash_attention_kernel: q (B, S, H, D) and k, v "
                         f"(B, S, H_kv, D) must share one B, S and D, with "
                         f"H % H_kv == 0, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def _fold(t):
    """(B, S, h, D) -> (B h, S, D), the plain version's layout."""
    B, S, h, D = t.shape
    return t.transpose(1, 2).reshape(B * h, S, D)


def _forward(q, k, v, causal, window, want_lse):
    """(out, lse (B, H, S) float32 or None without ``want_lse``)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if on_cpu("flash_attention_kernel", q, k, v):
        if Hkv != H:
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
        res = flash_attention_ref(_fold(q), _fold(k), _fold(v),
                                  causal=causal, window=window,
                                  return_lse=want_lse)
        out, lse = res if want_lse else (res, None)
        out = out.reshape(B, H, S, D).transpose(1, 2)
        return out, (lse.reshape(B, H, S) if want_lse else None)
    if not 0 < D <= MAX_HEAD_DIM or B * H > _MAX_HEADS:
        raise ValueError(f"flash_attention_kernel: shape {tuple(q.shape)} "
                         f"outside the kernel's limits (D <= "
                         f"{MAX_HEAD_DIM}, B H <= {_MAX_HEADS})")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if out.numel():
        rc = _build.launcher("repro_flash_attn", _ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, Hkv, D, 1.0 / math.sqrt(D), int(causal), window,
            int(q.dtype == torch.bfloat16),
            lse.data_ptr() if want_lse else None,
            _build.stream_ptr(q.device))
        _build.check(rc, "flash_attention_kernel")
        flash_attention_kernel.launches += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """``flash_attention_kernel`` with its backward: the forward saves
    (q, k, v, o, lse), the backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.is_cuda and q.shape[3] > MAX_BWD_HEAD_DIM:
            raise NotImplementedError(
                f"flash_attention_kernel: head_dim {q.shape[3]} > "
                f"{MAX_BWD_HEAD_DIM} has no backward kernel yet (ROADMAP "
                f"queue A, slice 17); call it without grad")
        out, lse = _forward(q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def bwd_route(q, k, v, o, do) -> str:
    """The backward's route on the card, by dtype, head size and layout
    alone: "wgmma" (``flash_bwd_dkdv_wgmma_kernel`` and
    ``flash_bwd_dq_wgmma_kernel``, their tiles brought in by TMA) for
    bfloat16 with D % 8 == 0 and D <= 128, every tensor contiguous and its
    base 16-byte aligned: TMA reads rows of D values, which must fill
    whole 16-byte chunks, from aligned bases; every LM path (D 64 and 128,
    contiguous (B, S, H, D)) takes it.  "mma" otherwise (float32, a head
    size that is not a multiple of 8, an unaligned view): the
    ``mma.sync`` kernels ``flash_bwd_dkdv_kernel`` and
    ``flash_bwd_dq_kernel``.  Not a fallback: a kernel of either route
    that fails to build or launch raises."""
    D = q.shape[3]
    if q.dtype != torch.bfloat16 or D % 8 or D > MAX_BWD_HEAD_DIM:
        return "mma"
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v, o, do)):
        return "mma"
    return "wgmma"


def bwd_launches(q, k, v, o, do) -> int:
    """Kernels one ``flash_attention_bwd`` call launches on the card: the
    row pass (delta, or on the wgmma route lse and delta), dK and dV, dQ,
    and with H_kv < H on the wgmma route or in float32 the pass that sums
    the query heads' partial dK and dV (``_split_group``)."""
    return 3 + int(_split_group(q, k, bwd_route(q, k, v, o, do)))


def _split_group(q, k, route) -> bool:
    """dK and dV a query head at a time, summed after: at H_kv < H on the
    wgmma route (the group across blocks) and in float32 (the tensor
    cores' float32 accumulation truncates; one accumulator over a group's
    G S / 8 k steps passes float32's limit at G 8)."""
    return q.shape[2] != k.shape[2] and (route == "wgmma"
                                         or q.dtype == torch.float32)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0):
    """The backward of ``flash_attention_kernel``: q, o, do (B, S, H, D),
    k, v (B, S, H_kv, D), lse (B, H, S) float32 (the forward's) -> dq, dk,
    dv in the inputs' dtype, float32 inside.  CPU tensors: the plain
    version ``flash_attention_bwd_ref``; CUDA tensors: the kernels of
    ``csrc/flash_attn_bwd.cu`` on ``bwd_route``'s route, each launch
    counted in ``launches`` (``bwd_launches`` a call); D in (128, 256]
    raises.

    "wgmma": ``flash_bwd_prep_kernel`` (each row's lse log2(e) and delta
    = rowsum(dO o O), padded to 128 rows), ``flash_bwd_dkdv_wgmma_kernel``
    (a block per (batch, query head, 128 kv rows): S^T, dP^T, dV += P^T
    dO and dK += dS^T Q on wgmma, the query tiles streamed by TMA), with
    H_kv < H ``flash_bwd_reduce_kernel`` (each query head's float32
    partial dK and dV summed in head order, rounded once: the same bits
    every call), then ``flash_bwd_dq_wgmma_kernel`` (a block per (batch,
    head, 128 query rows), the kv tiles streamed).  "mma": delta, then
    dK and dV a KV head's kv tile at a time (float32 with H_kv < H: a
    query head's, summed by ``flash_bwd_reduce_kernel``), then dQ a query
    tile at a time.  Bound: the five products, 5 x 2 D per (query, key)
    pair the mask keeps, at the bf16 tensor-core rate."""
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o and do must match q "
                         f"{tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(o.shape)} {o.dtype}, {tuple(do.shape)} "
                         f"{do.dtype}")
    B, S, H, D = q.shape
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be (B, H, S) = "
                         f"{(B, H, S)} float32, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    window = int(window)
    if on_cpu("flash_attention_bwd", q, k, v, o, lse, do):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    if D > MAX_BWD_HEAD_DIM:
        raise NotImplementedError(
            f"flash_attention_bwd: head_dim {D} > {MAX_BWD_HEAD_DIM} has no "
            f"backward kernel yet (ROADMAP queue A, slice 17)")
    if D < 1 or B * max(H, 1) > _MAX_HEADS:
        raise ValueError(f"flash_attention_bwd: shape {tuple(q.shape)} "
                         f"outside the kernel's limits")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not q.numel():
        return dq, dk, dv
    route = bwd_route(q, k, v, o, do)
    # with the group split, each query head's float32 dK and dV, summed
    # after by flash_bwd_reduce_kernel
    part = (torch.empty((2, B, S, H, D), dtype=torch.float32,
                        device=q.device)
            if _split_group(q, k, route) else None)
    if route == "wgmma":
        _bwd_wgmma(q, k, v, o, lse, do, dq, dk, dv, part, causal, window)
    else:
        _bwd_mma(q, k, v, o, lse, do, dq, dk, dv, part, causal, window)
    return dq, dk, dv


def _bwd_mma(q, k, v, o, lse, do, dq, dk, dv, part, causal, window):
    """The mma.sync route's launches into dq, dk and dv (see
    ``flash_attention_bwd``)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    bf16 = int(q.dtype == torch.bfloat16)
    stream = _build.stream_ptr(q.device)
    rc = _build.launcher("repro_flash_bwd_delta", _DELTA_ARGS)(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), B, S, H, D, bf16,
        stream)
    _build.check(rc, "flash_attention_bwd (delta)")
    flash_attention_bwd.launches += 1
    common = (B, S, H, Hkv, D, 1.0 / math.sqrt(D), int(causal), window,
              bf16, stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    rc = _build.launcher("repro_flash_bwd_dkdv", _BWD_ARGS(9))(
        *ins, dk.data_ptr(), dv.data_ptr(),
        part.data_ptr() if part is not None else None, *common)
    _build.check(rc, "flash_attention_bwd (dk, dv)")
    flash_attention_bwd.launches += 1
    _reduce(part, dk, dv, bf16, stream)
    rc = _build.launcher("repro_flash_bwd_dq", _BWD_ARGS(7))(
        *ins, dq.data_ptr(), *common)
    _build.check(rc, "flash_attention_bwd (dq)")
    flash_attention_bwd.launches += 1


def _reduce(part, dk, dv, bf16, stream):
    """dk and dv = part's query heads summed in head order (nothing
    without ``part``)."""
    if part is None:
        return
    _, B, S, H, D = part.shape
    rc = _build.launcher("repro_flash_bwd_reduce", _REDUCE_ARGS)(
        part.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, dk.shape[2],
        D, bf16, stream)
    _build.check(rc, "flash_attention_bwd (dk, dv sums)")
    flash_attention_bwd.launches += 1


def _bwd_wgmma(q, k, v, o, lse, do, dq, dk, dv, part, causal, window):
    """The wgmma route's launches into dq, dk and dv (see
    ``flash_attention_bwd``)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    S_pad = -(-S // _WB_BLOCK) * _WB_BLOCK
    rows = torch.empty((2, B, H, S_pad), dtype=torch.float32,
                       device=q.device)
    lse2, delta = rows[0], rows[1]
    stream = _build.stream_ptr(q.device)
    rc = _build.launcher("repro_flash_bwd_prep", _PREP_ARGS)(
        o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        lse2.data_ptr(), delta.data_ptr(), B, S, S_pad, H, D, stream)
    _build.check(rc, "flash_attention_bwd (lse, delta)")
    flash_attention_bwd.launches += 1
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse2.data_ptr(), delta.data_ptr())
    common = (B, S, S_pad, H, Hkv, D, 1.0 / math.sqrt(D), int(causal),
              window, stream)
    rc = _build.launcher("repro_flash_bwd_dkdv_wgmma", _WB_ARGS(9))(
        *ins, dk.data_ptr(), dv.data_ptr(),
        part.data_ptr() if part is not None else None, *common)
    _build.check(rc, "flash_attention_bwd (dk, dv)")
    flash_attention_bwd.launches += 1
    _reduce(part, dk, dv, 1, stream)
    rc = _build.launcher("repro_flash_bwd_dq_wgmma", _WB_ARGS(7))(
        *ins, dq.data_ptr(), *common)
    _build.check(rc, "flash_attention_bwd (dq)")
    flash_attention_bwd.launches += 1


flash_attention_kernel.launches = 0
flash_attention_bwd.launches = 0
