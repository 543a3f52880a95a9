"""Plain PyTorch version of the MAC-array GEMM (int8/uint8 -> int32).

PyTorch's CUDA matmul has no integer path, so the exact int32 product is
taken in float64: every product of two 8-bit operands is an integer of
at most 255**2, and every partial sum stays an integer below 2**53 while
K * 255**2 < 2**53 (K below about 1.4e11), so float64 accumulation is
exact in any order.  The exact sum goes through int64 to int32, which
keeps its low 32 bits: the two's-complement wrap of the reference's int32
matmul, also once a sum leaves the int32 range (a uint8 sum can from
K = 33025 on).  A float64 -> int32 cast would saturate instead.
"""
from __future__ import annotations

import torch


def mac_gemm_ref(a, b):
    """a: (M, K) int8/uint8; b: (K, N) int8/uint8 -> (M, N) int32, the
    exact sum wrapped to int32."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int64).to(torch.int32)


def mac_gemm_dequant_ref(a, b, a_scale, b_scale):
    """Dequantized W8A8 matmul: per-row a_scale (M,), per-col b_scale (N,)."""
    acc = mac_gemm_ref(a, b).to(torch.float32)
    return acc * a_scale[:, None] * b_scale[None, :]
