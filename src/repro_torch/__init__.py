"""PyTorch port of the SpiNNaker 2 PE simulator, for one CUDA GPU.

Mirrors ``repro``'s module tree (``configs/``, ``core/``, ``chip/``,
``kernels/``).  Imports ``torch`` and ``numpy`` only: nothing of JAX and
nothing of the ``repro`` package, which stays the reference the port is
tested against.

Entry points take ``device=`` and run on the CUDA device unless the
caller asks for the CPU; there is no silent CPU fallback.  On a CPU
tensor each kernel wrapper runs its plain PyTorch version, on a CUDA
tensor it launches the hand-written kernel (``csrc/``) or raises.
"""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA device; raises when the process has none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``default_device()``."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return default_device()          # raises with the reason
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or "
                         f"'cpu'")
    return device
