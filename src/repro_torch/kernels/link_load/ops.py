"""``link_loads_csc`` wrapper (CPU: plain version, CUDA:
``csrc/link_load.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import expect_dtype, on_cpu
from repro_torch.kernels.link_load.ref import link_loads_csc_ref

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 3 + (ctypes.c_void_p,)


def link_loads_csc(weights, src_sorted, link_ptr, *, n_links: int):
    """weights: (P,) or (B, P) float32 per-source counts; src_sorted
    (nnz,) int32 and link_ptr (n_links + 1,) int64: the
    ``SparseIncidence.csc`` layout.  Returns (n_links,) or (B, n_links)
    float32 link loads; a leading batch axis goes in one launch."""
    expect_dtype("link_loads_csc", torch.float32, weights=weights)
    expect_dtype("link_loads_csc", torch.int32, src_sorted=src_sorted)
    expect_dtype("link_loads_csc", torch.int64, link_ptr=link_ptr)
    if weights.dim() not in (1, 2) or src_sorted.dim() != 1 \
            or tuple(link_ptr.shape) != (n_links + 1,):
        raise ValueError(
            f"link_loads_csc: bad shapes weights {tuple(weights.shape)}, "
            f"src_sorted {tuple(src_sorted.shape)}, link_ptr "
            f"{tuple(link_ptr.shape)} for n_links={n_links}")
    if on_cpu("link_loads_csc", weights, src_sorted, link_ptr):
        return link_loads_csc_ref(weights, src_sorted, link_ptr, n_links)
    w2 = weights.reshape(-1, weights.shape[-1])
    out = torch.empty((w2.shape[0], n_links), dtype=torch.float32,
                      device=weights.device)
    if out.numel():
        rc = _build.launcher("repro_link_loads_csc", _ARGS)(
            w2.data_ptr(), src_sorted.data_ptr(), link_ptr.data_ptr(),
            out.data_ptr(), w2.shape[0], w2.shape[1], n_links,
            _build.stream_ptr(weights.device))
        _build.check(rc, "link_loads_csc")
        link_loads_csc.launches += 1
    return out.reshape(weights.shape[:-1] + (n_links,))


link_loads_csc.launches = 0
