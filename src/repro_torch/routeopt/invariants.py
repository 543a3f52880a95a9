"""The invariants any legal routing must preserve, as checkable facts.

Re-routing is only allowed to move flits, never to create, drop or
duplicate deliveries.  ``check_delivery`` walks every source's stitched
multicast tree link-by-link over the NoC's endpoint view and proves:

* the row is a TREE rooted at the source QPE: link ids distinct, every
  node's in-degree <= 1, every link's tail reachable from the root;
* every routing-table destination of the source is covered by the tree
  (so each destination receives each packet exactly once — in-degree
  <= 1 makes "at least once" also "exactly once").

It returns a routing-independent delivery signature — per source, the
destination node set and the flits each delivery carries.  Two programs
with equal signatures conserve flits per (source, destination-set)
EXACTLY: total link traversals may legitimately differ between
orientations (tree shapes differ), delivered flits may not.
"""
from __future__ import annotations

import numpy as np
import torch


def _endpoints(noc, link_id: int):
    """((chip, (x, y)), (chip, (x, y))) of a link, for board and
    single-chip NoCs alike (a chip is chip 0 of itself)."""
    if hasattr(noc, "link_endpoints"):
        a, b = noc.link_endpoints(link_id)
        return (a[0], tuple(int(v) for v in a[1])), \
               (b[0], tuple(int(v) for v in b[1]))
    a, b = noc.links[link_id]
    return (0, (int(a[0]), int(a[1]))), (0, (int(b[0]), int(b[1])))


def _node_of(program, p: int):
    """(chip, within-chip coord) of logical PE ``p``."""
    if getattr(program, "chip_of_pe", None) is not None:
        return (int(program.chip_of_pe[p]),
                tuple(int(v) for v in program.coords_local[p]))
    return (0, tuple(int(v) for v in program.coords[p]))


def check_delivery(program) -> list:
    """Verify every source's tree (see module docstring) and return the
    delivery signature: ``[(src_pe, (sorted dst nodes), flits), ...]``.
    Raises ``AssertionError`` naming the source PE on any violation."""
    sinc = program.sinc
    noc = program.noc
    masks = np.asarray(program.table.masks)
    flits = noc.packet_flits(torch.as_tensor(program.payload_bits)).numpy()
    sig = []
    for p in range(program.n_pes):
        row = sinc.link_ids[sinc.source_ptr[p]:sinc.source_ptr[p + 1]]
        assert len(set(row.tolist())) == len(row), \
            f"source PE {p}: duplicate link ids in its tree row"
        root = _node_of(program, p)
        out: dict = {}
        indeg: dict = {}
        for lid in row.tolist():
            a, b = _endpoints(noc, lid)
            out.setdefault(a, []).append(b)
            indeg[b] = indeg.get(b, 0) + 1
            assert indeg[b] <= 1, \
                f"source PE {p}: node {b} entered twice — not a tree"
        assert root not in indeg, \
            f"source PE {p}: a link re-enters the source node"
        reach = {root}
        frontier = [root]
        while frontier:
            nxt = []
            for n in frontier:
                for m in out.get(n, ()):
                    if m not in reach:
                        reach.add(m)
                        nxt.append(m)
            frontier = nxt
        for a in out:
            assert a in reach, \
                f"source PE {p}: link tail {a} unreachable from {root}"
        dsts = tuple(sorted(_node_of(program, int(q))
                            for q in np.flatnonzero(masks[p])
                            if int(q) != p))
        for d in dsts:
            assert d in reach, \
                f"source PE {p}: destination {d} not covered by its tree"
        sig.append((p, dsts, int(flits[p])))
    return sig
