"""Partition one ``NetGraph`` across the chips of a board.

Populations are atomic (a population's tiles always share a chip — the
on-chip snake placement keeps them contiguous); the partitioner decides
which chip each population lives on, under each chip's PE-slot capacity
(the same ``assign_slots`` arithmetic the single-chip compiler uses, so
``align_qpe`` padding is accounted exactly, not estimated):

1. **greedy fill** — populations in graph order onto chips in snake
   order over the chip grid.  Graph builders order populations along the
   pipeline (ring order, layer order, nef-before-mlp), so consecutive
   populations land on the same or adjacent chips and most projections
   never cross a chip boundary.
2. **min-cut refinement** — a Kernighan-Lin-flavored greedy pass: move
   single populations toward their neighbors when that lowers the
   flit-weighted cut (flits per packet x src tiles x dst tiles x
   chip-grid hop distance) and the target chip has slack.  Deterministic;
   a 1x1 board is untouched (the single-chip golden anchor).

The result is a ``Partition``; ``board.route.compile_board`` turns it
into placement + hierarchical routing.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.board.spec import BoardSpec
from repro_torch.chip.graph import NetGraph
from repro_torch.chip.mapping import assign_slots, snake_order
from repro_torch.chip.mesh_noc import MeshSpec


@dataclass
class Partition:
    """Population -> chip assignment plus per-chip occupancy."""
    board: BoardSpec
    chip_of: dict                    # population name -> chip index
    chip_pops: list                  # per chip: populations, graph order
    slots_used: list                 # per chip: slots incl. align padding
    cut_flits: float                 # flit-weighted cut after refinement

    def chips_of_graph(self) -> np.ndarray:
        """(n_chips,) population counts — occupancy diagnostic."""
        return np.array([len(p) for p in self.chip_pops])


def _proj_weights(graph: NetGraph, payload_bits: int,
                  rates: dict | None = None) -> list:
    """(src, dst, flit-weighted traffic proxy) per projection: packets
    per source tile weigh their flit footprint (the engine's
    ``packet_flits`` formula over the board's flit payload size), every
    src tile multicasts to every dst tile.

    ``rates`` optionally replaces the static every-tile-fires-every-tick
    estimate with measured packets/tick summed over the source
    population's tiles; populations without a measurement keep the
    static ``s.n_tiles`` proxy."""
    out = []
    for pr in graph.projections:
        flits = max(1, -(-pr.bits_per_packet // payload_bits))
        s, d = graph.population(pr.src), graph.population(pr.dst)
        rate = (rates or {}).get(pr.src, float(s.n_tiles))
        out.append((pr.src, pr.dst, float(flits * rate * d.n_tiles)))
    return out


def _cut(weights, chip_of, board: BoardSpec) -> float:
    """Flit-weighted cut: traffic proxy x chip-grid hop distance."""
    total = 0.0
    for s, d, w in weights:
        (ax, ay), (bx, by) = (board.chip_coord(chip_of[s]),
                              board.chip_coord(chip_of[d]))
        total += w * (abs(ax - bx) + abs(ay - by))
    return total


def _fits(pops, extra, mesh: MeshSpec) -> bool:
    """Would ``pops + [extra]`` fit the chip?  Exact — runs the
    compiler's own slot assignment, so ``align_qpe`` padding is charged
    the same way placement will charge it.  NOTE: ``assign_slots``
    totals are ORDER-dependent when ``align_qpe`` populations mix with
    plain ones, so callers must pass ``pops + [extra]`` in the order
    placement will use (the greedy fill appends in graph order, so a
    plain append is exact there; refinement re-sorts first)."""
    return assign_slots(pops + [extra], mesh.pes_per_qpe)[1] <= mesh.n_pes


def partition(graph: NetGraph, board: BoardSpec, refine: bool = True,
              max_passes: int = 2, rates: dict | None = None) -> Partition:
    """Assign each population to a chip (see module docstring).

    ``rates`` re-weights the min-cut refinement with measured per-
    population packet rates instead of the static flit estimate (see
    ``_proj_weights``); the greedy fill is rate-independent, so
    ``rates=None`` and any measurement agree bit-for-bit when
    refinement is off.

    Raises ``ValueError`` with the offending population / capacity totals
    when the graph cannot fit the board.
    """
    mesh = board.chip
    for pop in graph.populations:
        if not _fits([], pop, mesh):
            raise ValueError(
                f"population {pop.name!r} needs {pop.n_tiles} PE slots "
                f"(align_qpe={pop.align_qpe}) but one "
                f"{mesh.width}x{mesh.height} QPE chip holds only "
                f"{mesh.n_pes} PEs; split it into more populations or "
                f"use a bigger chip mesh")

    # 1. greedy fill, chips in snake order over the chip grid
    fill_order = snake_order(MeshSpec(board.chips_x, board.chips_y,
                                      pes_per_qpe=1))
    chip_pops: list = [[] for _ in range(board.n_chips)]
    chip_of: dict = {}
    cursor = 0
    for pop in graph.populations:
        while cursor < len(fill_order) and \
                not _fits(chip_pops[fill_order[cursor]], pop, mesh):
            cursor += 1
        if cursor == len(fill_order):
            need = sum(p.n_tiles for p in graph.populations)
            raise ValueError(
                f"graph {graph.name!r} ({need} tiles over "
                f"{len(graph.populations)} populations) does not fit the "
                f"{board.chips_x}x{board.chips_y} board of "
                f"{mesh.width}x{mesh.height} chips "
                f"({board.n_pes} PEs); use a bigger board")
        c = fill_order[cursor]
        chip_pops[c].append(pop)
        chip_of[pop.name] = c

    # 2. min-cut refinement: move populations toward their neighbors.
    # Only a move's incident edges change the cut, so each candidate is
    # scored in O(degree), not O(n_projections).
    weights = _proj_weights(graph, board.noc.payload_bits, rates)
    if refine and board.n_chips > 1 and weights:
        order = {p.name: i for i, p in enumerate(graph.populations)}
        incident: dict = {p.name: [] for p in graph.populations}
        for s, d, w in weights:
            if s != d:                       # self-edges never cross chips
                incident[s].append((d, w))
                incident[d].append((s, w))

        def local_cost(name, chip):
            cx, cy = board.chip_coord(chip)
            cost = 0.0
            for other, w in incident[name]:
                ox, oy = board.chip_coord(chip_of[other])
                cost += w * (abs(cx - ox) + abs(cy - oy))
            return cost

        def fits_in_graph_order(c, pop):
            """Capacity check against the EXACT population order the
            placer will use on chip c (align_qpe padding is
            order-dependent, so appending would validate a different
            slot total than placement charges)."""
            pops = sorted(chip_pops[c] + [pop], key=lambda p: order[p.name])
            return assign_slots(pops, mesh.pes_per_qpe)[1] <= mesh.n_pes

        for _ in range(max_passes):
            moved = False
            for pop in graph.populations:
                cur = chip_of[pop.name]
                cands = sorted({chip_of[n] for n, _ in incident[pop.name]}
                               - {cur})
                if not cands:
                    continue
                base = local_cost(pop.name, cur)
                best, best_cost = None, base
                for c in cands:
                    if not fits_in_graph_order(c, pop):
                        continue
                    cost = local_cost(pop.name, c)
                    if cost < best_cost - 1e-9:
                        best, best_cost = c, cost
                if best is not None:
                    chip_pops[cur].remove(pop)
                    chip_pops[best].append(pop)
                    chip_pops[best].sort(key=lambda p: order[p.name])
                    chip_of[pop.name] = best
                    moved = True
            if not moved:
                break

    used = [assign_slots(pops, mesh.pes_per_qpe)[1] for pops in chip_pops]
    return Partition(board=board, chip_of=chip_of, chip_pops=chip_pops,
                     slots_used=used,
                     cut_flits=_cut(weights, chip_of, board))
