"""``flash_attention_kernel`` wrapper (CPU: plain version, CUDA:
``csrc/flash_attn.cu``).  No backward: the reference's kernel has none.

Routes, by dtype and head size alone: bfloat16 at D <= 128
``flash_attn_wgmma_kernel`` (one warpgroup of 64 query rows a block, two
blocks an SM), at 128 < D <= 256 ``flash_attn_wgmma_d256_kernel`` (a TMA
producer warpgroup and two consumer warpgroups that share each K/V tile);
float32 at D <= 128 ``flash_attn_tf32_kernel``, at 128 < D <= 256
``flash_attn_tf32_d256_kernel`` (both 3xTF32 ``wgmma``).  Every route
reads K and V at their own head count."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import on_cpu
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int32,) * 5 + (
    ctypes.c_float, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ctypes.c_void_p)
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
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
    plain causal (or full) attention.

    ``bq`` and ``bk`` are the reference's query and kv block sizes, kept
    for parity of the signature and ignored: the kernels tile 64 or 128
    query rows against kv tiles of 64 (bfloat16) or 32 (float32) rows and
    bounds-check any S, so the result does not depend on them.  D is at
    most 256."""
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
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    window = int(window)
    if window < 0:
        raise ValueError(f"flash_attention_kernel: window {window} < 0")
    if on_cpu("flash_attention_kernel", q, k, v):
        if Hkv != H:
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
        fold = lambda t: t.transpose(1, 2).reshape(B * H, S, D)
        out = flash_attention_ref(fold(q), fold(k), fold(v), causal=causal,
                                  window=window)
        return out.reshape(B, H, S, D).transpose(1, 2)
    if not 0 < D <= MAX_HEAD_DIM or B * H > _MAX_HEADS:
        raise ValueError(f"flash_attention_kernel: shape {tuple(q.shape)} "
                         f"outside the kernel's limits (D <= "
                         f"{MAX_HEAD_DIM}, B H <= {_MAX_HEADS})")
    out = torch.empty_like(q)
    if out.numel():
        rc = _build.launcher("repro_flash_attn", _ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, Hkv, D, 1.0 / math.sqrt(D), int(causal), window,
            int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
        _build.check(rc, "flash_attention_kernel")
        flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
