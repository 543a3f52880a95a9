"""Event-mode NoC accounting: the active-source compaction and the
``event_link_loads`` wrapper (CPU: plain version, CUDA:
``csrc/event_gather.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import expect_dtype, on_cpu
from repro_torch.kernels.event_gather.ref import event_link_loads_ref

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 5 + (ctypes.c_void_p,)


def active_source_set(weights, cap: int):
    """Compact the nonzero lanes of ``weights`` (..., P) into a (..., cap)
    int32 index buffer: ascending ids first, sentinel P after, by one
    static-size sort (no host synchronisation).  Returns (idx, n_active);
    ``n_active > cap`` flags overflow.  The tags are int32 (the reference
    sorts uint16 below 2**16 PEs): the same values, so the same order."""
    P = weights.shape[-1]
    act = weights != 0
    lanes = torch.arange(P, dtype=torch.int32, device=weights.device)
    tags = torch.where(act, lanes, P)
    idx = torch.sort(tags, dim=-1).values[..., :cap]
    return idx, act.sum(-1, dtype=torch.int32)


def gather_entries(idx, weights, rows_padded):
    """The gathered entries ``event_link_loads`` accumulates: (cap * L,)
    link ids and per-entry float32 weights (0.0 on unused lanes)."""
    P = weights.shape[-1]
    safe = idx.long().clamp(max=P - 1)
    w = torch.where(idx < P, weights.to(torch.float32)[safe], 0.0)
    ids = rows_padded[safe]                                  # (cap, L)
    return ids.reshape(-1), w[:, None].expand(ids.shape).reshape(-1)


def event_link_loads(idx, weights, rows_padded, *, n_links: int):
    """Per-link loads from a compacted active-source buffer.

    idx (cap,) int32, sentinel P on unused lanes; weights (P,) or (B, P)
    float32 per-source counts (a leading batch axis, packets and flits,
    goes in one launch); rows_padded (P, L) int32 link ids padded with
    ``n_links``.  Returns (n_links,) or (B, n_links) float32."""
    expect_dtype("event_link_loads", torch.int32, idx=idx,
                 rows_padded=rows_padded)
    expect_dtype("event_link_loads", torch.float32, weights=weights)
    if (idx.dim() != 1 or weights.dim() not in (1, 2)
            or rows_padded.dim() != 2
            or rows_padded.shape[0] != weights.shape[-1]):
        raise ValueError(
            f"event_link_loads: bad shapes idx {tuple(idx.shape)}, "
            f"weights {tuple(weights.shape)}, rows_padded "
            f"{tuple(rows_padded.shape)}")
    if on_cpu("event_link_loads", idx, weights, rows_padded):
        return event_link_loads_ref(idx, weights, rows_padded, n_links)
    w2 = weights.reshape(-1, weights.shape[-1])
    out = torch.empty((w2.shape[0], n_links), dtype=torch.float32,
                      device=weights.device)
    if out.numel():
        rc = _build.launcher("repro_event_link_loads", _ARGS)(
            idx.data_ptr(), w2.data_ptr(), rows_padded.data_ptr(),
            out.data_ptr(), w2.shape[0], w2.shape[1], idx.shape[0],
            rows_padded.shape[1], n_links, _build.stream_ptr(idx.device))
        _build.check(rc, "event_link_loads")
        event_link_loads.launches += 1
    return out.reshape(weights.shape[:-1] + (n_links,))


event_link_loads.launches = 0
