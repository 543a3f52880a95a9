"""``noc_link_loads`` and ``link_loads_csc`` wrappers (CPU: plain
versions, CUDA: ``csrc/link_load.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import expect_dtype, on_cpu
from repro_torch.kernels.link_load.ref import (link_loads_csc_ref,
                                               noc_link_loads_ref)

_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int64,) * 4 + (ctypes.c_void_p,)


# rows of counts a launch takes: the grid's y extent
MAX_ROWS = 65535


def _launch(counter, w, flits, ids, link_ptr, out):
    """One ``repro_noc_link_loads`` launch over the (B, P) rows ``w``, B
    at most ``MAX_ROWS``, into ``out`` ((B, n_links), then with ``flits``
    B more rows), counted on ``counter``."""
    w, ids = w.contiguous(), ids.contiguous()
    flits = None if flits is None else flits.contiguous()
    link_ptr = None if link_ptr is None else link_ptr.contiguous()
    if out.numel():
        rc = _build.launcher("repro_noc_link_loads", _ARGS)(
            w.data_ptr(), None if flits is None else flits.data_ptr(),
            ids.data_ptr(), None if link_ptr is None else link_ptr.data_ptr(),
            out.data_ptr(), w.shape[0], w.shape[1], out.shape[-1],
            ids.shape[0] if link_ptr is None else 0,
            _build.stream_ptr(w.device))
        _build.check(rc, counter.__name__)
        counter.launches += 1
    return out


def noc_link_loads(packets, flits, ids, link_ptr=None, *, n_links: int):
    """One tick's link and flit loads in one launch.  packets, flits: (P,)
    float32 packets per source and flits per packet; the plan of
    ``MeshNoc.device_plan``: ``ids`` (F, n_links) int32, the padded
    link-major table with sentinel P, when ``link_ptr`` is None, else
    ``ids`` = src_sorted (nnz,) int32 with ``link_ptr`` (n_links + 1,)
    int32.  The kernel's route follows the plan's shape.  Returns
    (2, n_links) float32: link loads, flit loads.

    A fleet's tick passes (w, P) packets, and flits (P,) or (w, P): the
    rows ``packets`` and ``packets * flits`` go through the kernel as 2w
    rows of counts, one launch for every ``MAX_ROWS``, and the result is
    (2, w, n_links)."""
    expect_dtype("noc_link_loads", torch.float32, packets=packets,
                 flits=flits)
    expect_dtype("noc_link_loads", torch.int32, ids=ids)
    tensors = (packets, flits, ids)
    if link_ptr is None:
        plan_ok = ids.dim() == 2 and ids.shape[1] == n_links
    else:
        expect_dtype("noc_link_loads", torch.int32, link_ptr=link_ptr)
        plan_ok = ids.dim() == 1 and tuple(link_ptr.shape) == (n_links + 1,)
        tensors += (link_ptr,)
    batched = packets.dim() == 2 and flits.shape in (packets.shape,
                                                    packets.shape[-1:])
    if not plan_ok or not (batched or packets.dim() == 1
                           and flits.shape == packets.shape) \
            or max(ids.numel(), packets.shape[-1], n_links + 1) >= 2**31:
        raise ValueError(
            f"noc_link_loads: bad shapes packets {tuple(packets.shape)}, "
            f"flits {tuple(flits.shape)}, ids {tuple(ids.shape)}, link_ptr "
            f"{None if link_ptr is None else tuple(link_ptr.shape)} for "
            f"n_links={n_links}")
    if on_cpu("noc_link_loads", *tensors):
        return noc_link_loads_ref(packets, flits, ids, link_ptr, n_links)
    if packets.dim() == 1:
        out = torch.empty((2, n_links), dtype=torch.float32,
                          device=packets.device)
        return _launch(noc_link_loads, packets[None], flits, ids, link_ptr,
                       out)
    rows = torch.cat([packets, packets * flits])
    out = torch.empty((rows.shape[0], n_links), dtype=torch.float32,
                      device=packets.device)
    for i in range(0, rows.shape[0], MAX_ROWS):
        _launch(noc_link_loads, rows[i:i + MAX_ROWS], None, ids, link_ptr,
                out[i:i + MAX_ROWS])
    return out.reshape(2, packets.shape[0], n_links)


def link_loads_csc(weights, src_sorted, link_ptr, *, n_links: int):
    """weights: (P,) or (B, P) float32 per-source counts; src_sorted
    (nnz,) int32 and link_ptr (n_links + 1,) int64: the
    ``SparseIncidence.csc`` layout.  Returns (n_links,) or (B, n_links)
    float32 link loads, from ``noc_link_loads``' kernel on its CSC route
    with no flits row: a leading batch axis goes in one launch for every
    ``MAX_ROWS`` rows.  The engine's tick calls ``noc_link_loads``
    instead."""
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
    if max(src_sorted.numel(), w2.shape[1], n_links + 1) >= 2**31:
        raise ValueError(f"link_loads_csc: sizes past int32: weights "
                         f"{tuple(weights.shape)}, {src_sorted.numel()} "
                         f"entries, n_links={n_links}")
    out = torch.empty((w2.shape[0], n_links), dtype=torch.float32,
                      device=weights.device)
    ptr = link_ptr.to(torch.int32)
    for i in range(0, w2.shape[0], MAX_ROWS):
        _launch(link_loads_csc, w2[i:i + MAX_ROWS], None, src_sorted, ptr,
                out[i:i + MAX_ROWS])
    return out.reshape(weights.shape[:-1] + (n_links,))


noc_link_loads.launches = 0
link_loads_csc.launches = 0
