"""``mac_conv2d`` wrapper (CPU: plain version, CUDA: ``csrc/mac_conv.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import on_cpu
from repro_torch.kernels.mac_conv.ref import conv_geometry, mac_conv2d_ref

_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int32,) * 15 + (ctypes.c_void_p,)
_OPERAND_TYPES = (torch.int8, torch.uint8)


def mac_conv2d(x, w, *, stride=(1, 1), padding="VALID", bh=8, bcout=128):
    """x: (B, H, W, Cin) int8/uint8 NHWC; w: (KH, KW, Cin, Cout)
    int8/uint8 HWIO -> (B, Ho, Wo, Cout) int32, exact int32 accumulation
    for either signedness on either side.

    ``stride`` is (sh, sw); ``padding`` is "VALID" or "SAME" with the
    reference's split (half the padding, rounded down, before).  ``bh``
    and ``bcout`` are the reference's row and channel blocking, kept for
    parity of the signature and ignored: the kernel tiles the output
    itself and bounds-checks every edge, and padding is index arithmetic
    in the kernel, so nothing is padded or blocked here."""
    for arg, t in (("x", x), ("w", w)):
        if t.dtype not in _OPERAND_TYPES:
            raise TypeError(f"mac_conv2d: {arg} must be int8 or uint8, got "
                            f"{t.dtype}")
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"mac_conv2d: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    stride = tuple(int(s) for s in stride)
    if on_cpu("mac_conv2d", x, w):
        return mac_conv2d_ref(x, w, stride=stride, padding=padding)
    B, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    pt, _, pl, _, Ho, Wo = conv_geometry(H, W, KH, KW, stride, padding)
    if max(B * Ho * Wo, B * H, KH * KW * Cin, Cout) >= 2**31:
        raise ValueError(f"mac_conv2d: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)} exceed the kernel's int32 "
                         f"indexing")
    out = torch.empty((B, Ho, Wo, Cout), dtype=torch.int32, device=x.device)
    if out.numel():
        rc = _build.launcher("repro_mac_conv", _ARGS)(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W, Cin, KH,
            KW, Cout, *stride, pt, pl, Ho, Wo, int(x.dtype == torch.int8),
            int(w.dtype == torch.int8), _build.stream_ptr(x.device))
        _build.check(rc, "mac_conv2d")
        mac_conv2d.launches += 1
    return out


mac_conv2d.launches = 0
