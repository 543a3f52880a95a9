"""``mac_gemm`` wrapper (CPU: plain version, CUDA: ``csrc/mac_gemm.cu``)
and the W8A8 dequantizing product."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import on_cpu
from repro_torch.kernels.mac_gemm.ref import mac_gemm_ref

_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int32,) * 5 + (ctypes.c_void_p,)
_DP4A_ARGS = ((ctypes.c_void_p,) * 3 + (ctypes.c_int32,) * 5
              + (ctypes.c_void_p,))
_OPERAND_TYPES = (torch.int8, torch.uint8)
_MAX_ROW_TILES = 65535             # gridDim.y limit: tiles of M
# up to this K the product takes one launch of the CUDA-core dp4a kernel:
# the tensor-core path's two launches (operand pack, product) cost more
# than the whole product there (PERF.md, the hybrid encode's K = 1)
DP4A_MAX_K = 32


def mac_gemm(a, b):
    """int8/uint8 (M, K) x int8/uint8 (K, N) -> (M, N) int32 with exact
    int32 accumulation (wrapping as int32 does), for any M, K, N and
    either signedness on either side (the kernel bounds-checks its tiles;
    the operands are not padded here)."""
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
    tile_rows = 64 if K <= DP4A_MAX_K else 128
    if max(M, K + 15, N) >= 2**31 or -(-M // tile_rows) > _MAX_ROW_TILES:
        raise ValueError(f"mac_gemm: shape {M}x{K}x{N} exceeds the "
                         f"kernel's grid")
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if not out.numel():
        return out
    signs = int(a.dtype == torch.int8), int(b.dtype == torch.int8)
    stream = _build.stream_ptr(a.device)
    if K <= DP4A_MAX_K:
        rc = _build.launcher("repro_mac_gemm_dp4a", _DP4A_ARGS)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, *signs,
            stream)
    else:
        # scratch of the kernel's operand pack: B transposed to (N, Kp),
        # and A zero-padded to (M, Kp) unless its rows are 16-byte aligned
        kp = -(-K // 16) * 16
        bt = torch.empty((N, kp), dtype=torch.uint8, device=a.device)
        ap = (torch.empty((M, kp), dtype=torch.uint8, device=a.device)
              if kp != K or a.data_ptr() % 16 else None)
        rc = _build.launcher("repro_mac_gemm", _ARGS)(
            a.data_ptr(), b.data_ptr(), None if ap is None else ap.data_ptr(),
            bt.data_ptr(), out.data_ptr(), M, N, K, *signs, stream)
    _build.check(rc, "mac_gemm")
    mac_gemm.launches += 1
    return out


mac_gemm.launches = 0


def mac_gemm_dequant(a, b, a_scale, b_scale):
    """W8A8 path: int32 accumulate, then per-row/col rescale to float32."""
    acc = mac_gemm(a, b).to(torch.float32)
    return acc * a_scale[:, None] * b_scale[None, :]
