"""Event-mode accounting wrappers (CPU: plain versions, CUDA:
``csrc/event_gather.cu``): the active-lane compaction ``compact_lanes``
and ``active_source_set`` on top of it, and ``event_link_loads``, whose
two kernels are chosen by shape (``route``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import expect_dtype, on_cpu
from repro_torch.kernels.event_gather.ref import (compact_geometry,
                                                  compact_lanes_ref,
                                                  event_link_loads_ref)

_COMPACT_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int32,) * 4 + (
    ctypes.c_void_p,)
_LOADS_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int32,) * 6 + (
    ctypes.c_void_p,)
# one block of the compaction kernel holds 1024 chunks of 64 lanes
MAX_COMPACT_LANES = 1 << 16
# the shared-memory route holds the (batch, n_links) counts in 48 KB
SMEM_BYTES = 48 * 1024


def compact_lanes(mask, cap: int, max_chunks: int | None = None):
    """See ``compact_lanes_ref``: mask (..., P) bool -> (idx (...,
    cap_eff) int32, fits (...) bool, n_active (...) int32), the set lanes
    of the first ``max_chunks`` active 64-lane chunks (None: all) in
    ascending order, sentinel P after.  One kernel launch on a CUDA
    device, no host synchronisation; P above 65536 is refused there."""
    expect_dtype("compact_lanes", torch.bool, mask=mask)
    if mask.dim() < 1:
        raise ValueError("compact_lanes: mask must have a lane axis")
    if on_cpu("compact_lanes", mask):
        return compact_lanes_ref(mask, cap, max_chunks)
    P = mask.shape[-1]
    if P > MAX_COMPACT_LANES:
        raise ValueError(f"compact_lanes: {P} lanes; the kernel's one "
                         f"block takes at most {MAX_COMPACT_LANES}")
    _, kc, cap_eff = compact_geometry(P, cap, max_chunks)
    batch = mask.shape[:-1]
    idx = torch.empty(batch + (cap_eff,), dtype=torch.int32,
                      device=mask.device)
    fits = torch.empty(batch, dtype=torch.bool, device=mask.device)
    n_active = torch.empty(batch, dtype=torch.int32, device=mask.device)
    rc = _build.launcher("repro_compact_lanes", _COMPACT_ARGS)(
        mask.data_ptr(), idx.data_ptr(), fits.data_ptr(),
        n_active.data_ptr(), fits.numel(), P, kc, cap_eff,
        _build.stream_ptr(mask.device))
    _build.check(rc, "compact_lanes")
    compact_lanes.launches += 1
    return idx, fits, n_active


compact_lanes.launches = 0


def active_source_set(weights, cap: int):
    """Compact the nonzero lanes of ``weights`` (..., P) into a (...,
    min(cap, P)) int32 index buffer: ascending ids first, sentinel P
    after (the reference's one sort; ``compact_lanes`` over every
    chunk).  Returns (idx, n_active); ``n_active > cap`` flags
    overflow."""
    idx, _, n_active = compact_lanes(weights != 0, cap)
    return idx, n_active


def gather_entries(idx, weights, rows_padded):
    """The gathered entries ``event_link_loads`` accumulates: (cap * L,)
    link ids and per-entry float32 weights (0.0 on unused lanes)."""
    P = weights.shape[-1]
    safe = idx.long().clamp(max=P - 1)
    w = torch.where(idx < P, weights.to(torch.float32)[safe], 0.0)
    ids = rows_padded[safe]                                  # (cap, L)
    return ids.reshape(-1), w[:, None].expand(ids.shape).reshape(-1)


def route(batch: int, n_links: int) -> str:
    """The kernel a CUDA call of ``event_link_loads`` launches: "smem"
    (one launch, counts in a cluster's shared memory) for one or two rows
    whose (batch, n_links) int32 counts fit in 48 KB, as on the 4096-PE
    mesh, else "global" (zeroed output, global atomics)."""
    return ("smem" if batch <= 2 and batch * n_links * 4 <= SMEM_BYTES
            else "global")


def launch(idx, w2, rows_padded, out, kernel: str) -> None:
    """Launch ``kernel`` ("smem" or "global") on checked CUDA operands
    into ``out`` (B, n_links); ``event_link_loads`` calls it with
    ``route``.  ``idx`` None walks every source."""
    B, n_links = out.shape
    if kernel == "smem" and route(B, n_links) != "smem":
        raise ValueError("event_link_loads: the counts do not fit the "
                         "shared-memory kernel")
    n_items = w2.shape[1] if idx is None else idx.shape[0]
    rc = _build.launcher("repro_event_link_loads", _LOADS_ARGS)(
        None if idx is None else idx.data_ptr(), w2.data_ptr(),
        rows_padded.data_ptr(), out.data_ptr(), B, w2.shape[1], n_items,
        rows_padded.shape[1], n_links, int(kernel != "smem"),
        _build.stream_ptr(out.device))
    _build.check(rc, f"event_link_loads ({kernel})")


def event_link_loads(idx, weights, rows_padded, *, n_links: int):
    """Per-link loads of the active sources.

    idx (cap,) int32 compacted active-source ids, sentinel P on unused
    lanes, or None for every source (the kernel skips quiet ones);
    weights (..., P) float32 per-source counts (leading axes, packets
    and flits of a fleet's instances, go in one launch): integers with every
    link's sum below 2**24, for which the kernels are exact in any order
    (the shared-memory route counts in int32); rows_padded (P, L) int32
    link ids padded with ``n_links``.  Returns (..., n_links) float32."""
    listed = () if idx is None else (idx,)
    expect_dtype("event_link_loads", torch.int32, rows_padded=rows_padded,
                 **{"idx": t for t in listed})
    expect_dtype("event_link_loads", torch.float32, weights=weights)
    if (any(t.dim() != 1 for t in listed) or weights.dim() < 1
            or rows_padded.dim() != 2
            or rows_padded.shape[0] != weights.shape[-1]):
        raise ValueError(
            f"event_link_loads: bad shapes idx "
            f"{None if idx is None else tuple(idx.shape)}, weights "
            f"{tuple(weights.shape)}, rows_padded "
            f"{tuple(rows_padded.shape)}")
    if on_cpu("event_link_loads", *listed, weights, rows_padded):
        return event_link_loads_ref(idx, weights, rows_padded, n_links)
    w2 = weights.reshape(-1, weights.shape[-1])
    out = torch.empty((w2.shape[0], n_links), dtype=torch.float32,
                      device=weights.device)
    if out.numel():
        launch(idx, w2, rows_padded, out, route(*out.shape))
        event_link_loads.launches += 1
    return out.reshape(weights.shape[:-1] + (n_links,))


event_link_loads.launches = 0
