"""``mac_gemm`` wrapper (CPU: plain version, CUDA: ``csrc/mac_gemm.cu``)
and the W8A8 dequantizing product."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import on_cpu
from repro_torch.kernels.mac_gemm.ref import mac_gemm_ref

_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int32,) * 5 + (ctypes.c_void_p,)
_OPERAND_TYPES = (torch.int8, torch.uint8)
_MAX_ROW_TILES = 65535             # gridDim.y limit, 64 rows a tile


def mac_gemm(a, b):
    """int8/uint8 (M, K) x int8/uint8 (K, N) -> (M, N) int32 with exact
    int32 accumulation, for any M, K, N and either signedness on either
    side (the kernel bounds-checks its tiles; no padding)."""
    for arg, t in (("a", a), ("b", b)):
        if t.dtype not in _OPERAND_TYPES:
            raise TypeError(f"mac_gemm: {arg} must be int8 or uint8, got "
                            f"{t.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mac_gemm: bad shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if on_cpu("mac_gemm", a, b):
        return mac_gemm_ref(a, b)
    M, K = a.shape
    N = b.shape[1]
    if max(M, K, N) >= 2**31 or -(-M // 64) > _MAX_ROW_TILES:
        raise ValueError(f"mac_gemm: shape {M}x{K}x{N} exceeds the "
                         f"kernel's grid")
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if out.numel():
        rc = _build.launcher("repro_mac_gemm", _ARGS)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
            int(a.dtype == torch.int8), int(b.dtype == torch.int8),
            _build.stream_ptr(a.device))
        _build.check(rc, "mac_gemm")
        mac_gemm.launches += 1
    return out


mac_gemm.launches = 0


def mac_gemm_dequant(a, b, a_scale, b_scale):
    """W8A8 path: int32 accumulate, then per-row/col rescale to float32."""
    acc = mac_gemm(a, b).to(torch.float32)
    return acc * a_scale[:, None] * b_scale[None, :]
