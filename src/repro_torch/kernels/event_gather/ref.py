"""Plain PyTorch version of the event-mode (active-source) NoC accounting.

One tick of event-driven NoC accounting: a bounded compacted index buffer
``idx`` lists the sources active this tick (sentinel ``P`` on unused
lanes), and only their multicast-tree rows of the incidence are touched:

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


def event_link_loads_ref(idx, weights, rows_padded, n_links: int):
    """idx: (cap,) int32 active-source ids, sentinel P on unused lanes;
    weights: (P,) or (B, P) per-source counts; rows_padded: (P, L) int32
    padded link ids.  Returns (n_links,) or (B, n_links) float32 loads."""
    P = weights.shape[-1]
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
