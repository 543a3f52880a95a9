"""``mac_conv2d`` wrapper (CPU: plain version, CUDA: ``csrc/mac_conv.cu``).

Two kernels, chosen by shape: ``Cin % 16 == 0`` (every 16-byte chunk of a
patch row inside one tap) takes the int8 tensor cores (``wgmma``), any
other ``Cin`` the CUDA cores' ``dp4a`` (``route``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import on_cpu
from repro_torch.kernels.mac_conv.ref import conv_geometry, mac_conv2d_ref

_SHAPE_ARGS = (ctypes.c_int32,) * 15 + (ctypes.c_void_p,)
_DP4A_ARGS = (ctypes.c_void_p,) * 3 + _SHAPE_ARGS
_WGMMA_ARGS = (ctypes.c_void_p,) * 4 + _SHAPE_ARGS
_OPERAND_TYPES = (torch.int8, torch.uint8)


def route(x, w) -> str:
    """The kernel a CUDA call of ``mac_conv2d(x, w)`` launches: "wgmma"
    when each 16-byte chunk of a patch row lies in one tap and starts on
    a 16-byte boundary of x (Cin % 16 == 0, x 16-byte aligned), else
    "dp4a".  ``x`` and ``w`` are tensors or their shapes."""
    aligned = not isinstance(x, torch.Tensor) or x.data_ptr() % 16 == 0
    cin = w.shape[2] if isinstance(w, torch.Tensor) else w[2]
    return "wgmma" if cin % 16 == 0 and aligned else "dp4a"


def mac_conv2d(x, w, *, stride=(1, 1), padding="VALID", bh=8, bcout=128):
    """x: (B, H, W, Cin) int8/uint8 NHWC; w: (KH, KW, Cin, Cout)
    int8/uint8 HWIO -> (B, Ho, Wo, Cout) int32, exact int32 accumulation
    for either signedness on either side.

    ``stride`` is (sh, sw); ``padding`` is "VALID" or "SAME" with the
    reference's split (half the padding, rounded down, before).  ``bh``
    and ``bcout`` are the reference's row and channel blocking, kept for
    parity of the signature and ignored: each kernel tiles the output
    itself (128 pixels x 64, 128 or 256 channels on the tensor cores, 64
    x 64 with dp4a) and bounds-checks every edge, and padding is index
    arithmetic in the kernel, so nothing is padded or blocked here."""
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
        launch(x, w, out, stride, pt, pl, route(x, w))
        mac_conv2d.launches += 1
    return out


def launch(x, w, out, stride, pad_top, pad_left, kernel):
    """Launch ``kernel`` ("wgmma" or "dp4a") on checked CUDA operands
    into ``out``; ``mac_conv2d`` calls it with ``route(x, w)``.  The
    wgmma kernel needs Cin % 16 == 0 and a 16-byte aligned x."""
    B, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    shape = (B, H, W, Cin, KH, KW, Cout, *stride, pad_top, pad_left,
             *out.shape[1:3], int(x.dtype == torch.int8),
             int(w.dtype == torch.int8), _build.stream_ptr(x.device))
    if kernel == "wgmma":
        if route(x, w) != "wgmma":
            raise ValueError("mac_conv2d: the wgmma kernel takes Cin % 16 "
                             "== 0 and a 16-byte aligned x")
        # the operand pack's scratch: the weights transposed to (Cout, K)
        bt = torch.empty((Cout, KH * KW * Cin), dtype=torch.uint8,
                         device=x.device)
        rc = _build.launcher("repro_mac_conv_igmma", _WGMMA_ARGS)(
            x.data_ptr(), w.data_ptr(), bt.data_ptr(), out.data_ptr(),
            *shape)
    else:
        rc = _build.launcher("repro_mac_conv", _DP4A_ARGS)(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), *shape)
    _build.check(rc, f"mac_conv2d ({kernel})")


mac_conv2d.launches = 0
