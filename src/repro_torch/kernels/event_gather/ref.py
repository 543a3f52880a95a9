"""Plain PyTorch versions of the event-mode accounting: the active-lane
compaction and the NoC link loads of the active sources.

Compaction: the reference's tag sorts.  A (P,) bool mask is cut into
chunks of ``CHUNK`` lanes; the first ``kc`` chunks that hold a set lane
are selected by a chunk-tag sort, and the set lanes of those chunks by a
lane-tag sort, into a (cap_eff,) list: ascending ids, sentinel P after.
With kc = every chunk this is the reference's one-level
``active_source_set``.

Link loads: one tick of event-driven NoC accounting.  A bounded
compacted index buffer ``idx`` lists the sources active this tick
(sentinel ``P`` on unused lanes), and only their multicast-tree rows of
the incidence are touched:

    loads[l] = sum_{k : idx[k] < P}  weights[idx[k]] * [l in tree(idx[k])]

Rows come in the padded layout ``SparseIncidence.padded_rows`` (link ids
right-padded with the sentinel ``n_links``), so the gather is
rectangular.  Every term is an integer-valued float32 (packet or flit
counts), so while each link's sum stays below 2**24 every partial sum is
exact and any summation order gives the same bits; as long as ``idx``
covers every source with a nonzero weight, this equals the dense product
over the full vector bitwise.
"""
from __future__ import annotations

import torch

CHUNK = 64


def compact_geometry(P: int, cap: int, max_chunks: int | None):
    """(chunks, kc, cap_eff) of a compaction of P lanes into ``cap``
    slots over at most ``max_chunks`` active chunks (None: every
    chunk)."""
    nc = -(-P // CHUNK)
    kc = nc if max_chunks is None else min(max_chunks, nc)
    return nc, kc, min(cap, P, kc * CHUNK)


def compact_lanes_ref(mask, cap: int, max_chunks: int | None = None):
    """mask (..., P) bool.  Returns ``(idx, fits, n_active)``: idx
    (..., cap_eff) int32 holds the set lanes of the first ``kc`` active
    chunks in ascending order, sentinel P after; fits (...) bool says
    that every set lane is listed (no more than cap_eff lanes in no more
    than kc chunks); n_active (...) int32 counts the set lanes.  Two
    static-size sorts over int32 tags (the reference sorts uint16 below
    2**16 PEs: same values, same order)."""
    P = mask.shape[-1]
    nc, kc, cap_eff = compact_geometry(P, cap, max_chunks)
    dev = mask.device
    m = mask.reshape(-1, P)
    m = torch.nn.functional.pad(m, (0, nc * CHUNK - P))
    m = m.reshape(m.shape[0], nc, CHUNK)
    c_any = m.any(-1)                                       # (R, nc)
    ctags = torch.where(c_any, torch.arange(nc, dtype=torch.int32,
                                            device=dev), nc)
    cidx = torch.sort(ctags, dim=-1).values[:, :kc]
    csafe = cidx.clamp(max=nc - 1).long()
    rows = torch.arange(m.shape[0], device=dev)[:, None]
    sub = m[rows, csafe] & (cidx < nc)[..., None]          # (R, kc, 64)
    pos = (csafe[..., None] * CHUNK
           + torch.arange(CHUNK, dtype=torch.int64, device=dev))
    stags = torch.where(sub, pos.to(torch.int32), P)
    idx = torch.sort(stags.reshape(m.shape[0], -1), dim=-1).values
    n_active = m.sum((-2, -1), dtype=torch.int32)
    fits = (n_active <= cap_eff) & (c_any.sum(-1) <= kc)
    batch = mask.shape[:-1]
    return (idx[:, :cap_eff].reshape(batch + (cap_eff,)),
            fits.reshape(batch), n_active.reshape(batch))


def event_link_loads_ref(idx, weights, rows_padded, n_links: int):
    """idx: (cap,) int32 active-source ids, sentinel P on unused lanes, or
    None for every source (compacted here at full width); weights: (P,)
    or (B, P) per-source counts; rows_padded: (P, L) int32 padded link
    ids.  Returns (n_links,) or (B, n_links) float32 loads."""
    P = weights.shape[-1]
    if idx is None:
        active = (weights.reshape(-1, P) != 0).any(0)
        idx = compact_lanes_ref(active, P)[0]
    safe = idx.long().clamp(max=P - 1)
    w = torch.where(idx < P, weights.to(torch.float32).index_select(
        -1, safe), 0.0)                                       # (..., cap)
    ids = rows_padded.index_select(0, safe)                   # (cap, L)
    w_entry = w[..., None].expand(w.shape + (ids.shape[1],))
    out = torch.zeros(weights.shape[:-1] + (n_links + 1,),
                      dtype=torch.float32, device=weights.device)
    # one extra slot swallows the padding sentinel (id == n_links)
    out.index_add_(-1, ids.reshape(-1).long(),
                   w_entry.reshape(w.shape[:-1] + (-1,)))
    return out[..., :n_links]
