"""Argument checks shared by the kernel wrappers.

A wrapper dispatches on the device of its tensors: all on the CPU runs
the plain PyTorch version, all on one CUDA device launches the kernel.
Anything else raises; there is no fallback from one to the other.
"""
from __future__ import annotations

import torch


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True for all-CPU inputs, False for all-CUDA inputs on one device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return False


def expect_dtype(name: str, dtype: torch.dtype, **tensors) -> None:
    for arg, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
