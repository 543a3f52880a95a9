"""Plain PyTorch version of the sparse per-link NoC load accumulation.

One tick of NoC accounting over a multicast-tree incidence: every entry
(source p uses link l) adds source p's weight to link l's load,

    loads[l] = sum_{e : link_ids[e] == l}  weights[src_of_entry[e]]

a gather followed by ``index_add_``.  On integer-valued weights (packet
or flit counts below 2**24 per link) float32 accumulation is exact in any
order, so this agrees bitwise with the dense product ``weights @ inc``.
"""
from __future__ import annotations

import torch


def link_loads_ref(weights, link_ids, src_of_entry, n_links: int):
    """weights: (..., P) per-source counts; link_ids/src_of_entry: (nnz,)
    entry arrays.  Returns (..., n_links) float32 per-link loads."""
    w = weights.to(torch.float32).index_select(-1, src_of_entry.long())
    out = torch.zeros(weights.shape[:-1] + (n_links,), dtype=torch.float32,
                      device=weights.device)
    return out.index_add_(-1, link_ids.long(), w)


def link_loads_csc_ref(weights, src_sorted, link_ptr, n_links: int):
    """The same over the link-major (CSC) layout: entries sorted by link,
    link l owning entries [link_ptr[l], link_ptr[l+1])."""
    link_ids = torch.repeat_interleave(
        torch.arange(n_links, device=weights.device), torch.diff(link_ptr))
    return link_loads_ref(weights, link_ids, src_sorted, n_links)


def noc_link_loads_ref(packets, flits, ids, link_ptr, n_links: int):
    """One tick's (2, n_links) link and flit loads: the rows ``pk`` and
    ``pk * flits`` summed over each link's sources, the arithmetic of the
    reference's ``MeshNoc.noc_loads``.  The plan is the padded link-major
    table ``ids`` (F, n_links) with sentinel P when ``link_ptr`` is None,
    else the CSC layout (``ids`` = src_sorted)."""
    pk = packets.to(torch.float32)
    w = torch.stack([pk, pk * flits])
    if link_ptr is not None:
        return link_loads_csc_ref(w, ids, link_ptr, n_links)
    valid = ids < pk.shape[-1]
    link_ids = torch.arange(n_links, device=ids.device).expand(ids.shape)
    return link_loads_ref(w, link_ids[valid], ids[valid], n_links)
