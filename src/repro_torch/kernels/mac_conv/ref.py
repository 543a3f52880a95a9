"""Plain PyTorch version of the MAC-array 2-D convolution (CONV mode).

The reference's per-tap sum: for each of the KH x KW taps, one product of
the strided input slice with that tap's (Cin, Cout) weights.  PyTorch's
CUDA matmul has no integer path, so it runs in float64: every product of
two 8-bit operands is an integer of at most 255**2, and every partial sum
stays an integer below 2**53 while KH * KW * Cin * 255**2 < 2**53 (a
reduction below about 1.4e11), so the sum is exact in any order.  The
exact sum goes through int64 to int32, which keeps its low 32 bits: the
two's-complement wrap of the reference's int32 sum, also once it leaves
the int32 range.  A float64 -> int32 cast would saturate instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PADDINGS = ("VALID", "SAME")


def conv_geometry(H, W, KH, KW, stride, padding):
    """The reference's padding: (pad_top, pad_bottom, pad_left,
    pad_right, Ho, Wo).  SAME pads (Ho - 1) sh + KH - H rows, half of
    them (rounded down) before, the rest after; VALID pads nothing."""
    if padding not in PADDINGS:
        raise ValueError(f"padding must be one of {PADDINGS}, got "
                         f"{padding!r}")
    sh, sw = stride
    if min(sh, sw) < 1:
        raise ValueError(f"stride must be positive, got {stride}")
    pt = pb = pl = pr = 0
    if padding == "SAME":
        ph = max((-(-H // sh) - 1) * sh + KH - H, 0)
        pw = max((-(-W // sw) - 1) * sw + KW - W, 0)
        pt, pb, pl, pr = ph // 2, ph - ph // 2, pw // 2, pw - pw // 2
    Ho = (H + pt + pb - KH) // sh + 1
    Wo = (W + pl + pr - KW) // sw + 1
    if Ho < 1 or Wo < 1:
        raise ValueError(f"kernel {KH}x{KW} does not fit the {padding} "
                         f"input {H}x{W}")
    return pt, pb, pl, pr, Ho, Wo


def mac_conv2d_ref(x, w, *, stride=(1, 1), padding="VALID"):
    """x: (B, H, W, Cin) int8/uint8; w: (KH, KW, Cin, Cout) int8/uint8
    -> (B, Ho, Wo, Cout) int32, the exact sum wrapped to int32 (see the
    module docstring)."""
    B, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    sh, sw = stride
    pt, pb, pl, pr, Ho, Wo = conv_geometry(H, W, KH, KW, stride, padding)
    xf = F.pad(x.to(torch.float64), (0, 0, pl, pr, pt, pb))
    wf = w.to(torch.float64)
    out = torch.zeros((B, Ho, Wo, Cout), dtype=torch.float64,
                      device=x.device)
    for dh in range(KH):
        for dw in range(KW):
            patch = xf[:, dh:dh + sh * (Ho - 1) + 1:sh,
                       dw:dw + sw * (Wo - 1) + 1:sw, :]
            out += patch @ wf[dh, dw]
    return out.to(torch.int64).to(torch.int32)
