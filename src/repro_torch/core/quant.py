"""int8 quantization for the MAC-array compute path (W8A8)."""
from __future__ import annotations

import torch

from repro_torch.kernels.mac_gemm.ops import mac_gemm


def quantize_per_axis(x, axis: int, bits: int = 8):
    """Symmetric per-slice quantization along ``axis`` (the contraction's
    counterpart axis keeps its own scale).  Returns (q int8, scale f32).

    Bitwise the reference's on float32 input: ``max(amax, 1e-8) / qmax``,
    ``round(x / scale)`` half to even, clip.  ``qmax`` divides as a 0-d
    tensor on x's device: CUDA divides by a Python scalar as a multiply
    by its reciprocal, which can move the scale by one ulp."""
    qmax = 2 ** (bits - 1) - 1
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / torch.tensor(
        float(qmax), dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale.squeeze(axis)


def quantized_linear(x, wq, w_scale):
    """x: (M, K) float; wq: (K, N) int8 with per-col w_scale (N,).

    Activations are quantized per row on the fly (the MAC array's graded
    "spike payload"), multiplied in int8 with int32 accumulation, then
    rescaled: the W8A8 serve path.
    """
    xq, x_scale = quantize_per_axis(x, axis=1)
    acc = mac_gemm(xq, wq)
    return acc.to(torch.float32) * x_scale[:, None] * w_scale[None, :]


def quantize_params_linear(w):
    """w: (K, N) float -> (int8, per-col scale)."""
    return quantize_per_axis(w, axis=0)
