"""Hierarchical board routing: one ``NetGraph`` -> ``BoardProgram``.

``compile_board(graph, board)`` is the board-level twin of
``chip.compile.compile``: it partitions the graph across chips
(``board.partition``), snake-places each chip's populations with
the SAME slot arithmetic the single-chip compiler uses
(``place_partition``), and stitches each source's multicast route
hierarchically (``stitch_population``):

* **on the source chip** — the dimension-ordered multicast tree from the
  source tile to its local destinations PLUS the border port QPEs of
  every outgoing chip-to-chip direction the packet needs;
* **across chips** — a dimension-ordered multicast tree at CHIP
  granularity (the shared ``core.noc.build_tree``, one level up):
  each edge is one chip-to-chip link through an assigned border port;
* **on every other chip the tree touches** — a tree from the entry
  port QPE to that chip's local destinations and onward exit ports.

Every free routing choice — tree orientation (X/Y vs Y/X, on-chip and
at chip granularity) and which of the board's parallel border ports
each exit uses — rides in a ``routeopt.RouteConfig``; the default
(None) keeps the X-first / mid-edge-port routes.  Neuron-state records
are invariant under all of it because packets ride the routing-table
masks — incidence only prices links.

All stitched link ids land in ONE board-wide CSR ``SparseIncidence``
over ``BoardNoc``'s global link space, so the unchanged ``ChipSim`` tick
loop — the dense product, ``noc_link_loads`` or the event gather — runs
the whole board, with per-tier flit/energy accounting riding on the
``xlink_mask``/``tree_links_x`` split.

Golden anchor: a 1x1 board IS the single-chip path — same slot
assignment, same snake coords, same link enumeration, same CSR — so
``compile_board(g, BoardSpec(1, 1, chip=mesh))`` is bit-identical to
``compile(g, mesh)`` end to end, learn slots included: plastic
projections lower with the chip compiler's ``lower_plasticity``, so a
plastic graph trains the same on one chip and across a board.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.board.partition import Partition, partition
from repro_torch.board.spec import BoardNoc, BoardSpec, DIR_STEP, OPPOSITE
from repro_torch.chip.compile import (ChipProgram, check_compilable,
                                      source_packet_classes)
from repro_torch.chip.graph import NetGraph
from repro_torch.chip.mapping import assign_slots, snake_coords
from repro_torch.chip.mesh_noc import MeshSpec, SparseIncidence
from repro_torch.core.noc import build_tree, oriented_route
from repro_torch.core.pe import PESpec
from repro_torch.core.router import RoutingTable
from repro_torch.learn.lower import lower_plasticity
from repro_torch.routeopt.config import RouteConfig


def _dir_of(a: tuple, b: tuple) -> str:
    step = (b[0] - a[0], b[1] - a[1])
    for d, s in DIR_STEP.items():
        if s == step:
            return d
    raise ValueError(f"chips {a} and {b} are not adjacent")


def chip_tree(board: BoardSpec, src_chip: int, dst_chips,
              orientation: str = "xy") -> dict:
    """Dimension-ordered multicast tree over the chip grid (the shared
    ``build_tree``, run at chip granularity).

    Returns {chip index: (entry_dir | None, sorted exit dirs)} for every
    chip the tree touches (the union of the dimension-ordered chip-level
    routes is a tree: each non-source chip has exactly one entry side).
    """
    nodes: dict = {src_chip: [None, set()]}
    sc = board.chip_coord(src_chip)
    dst_xy = [board.chip_coord(c) for c in sorted(set(dst_chips))]
    for a, b in build_tree(sc, dst_xy, orientation):
        ca, cb = board.chip_index(*a), board.chip_index(*b)
        d = _dir_of(a, b)
        nodes[ca][1].add(d)
        if cb not in nodes:
            nodes[cb] = [OPPOSITE[d], set()]
    return {c: (entry, sorted(exits)) for c, (entry, exits)
            in nodes.items()}


def _manhattan(a, b) -> int:
    return abs(int(a[0]) - int(b[0])) + abs(int(a[1]) - int(b[1]))


def place_partition(graph: NetGraph, board: BoardSpec, part: Partition):
    """Snake-place a partitioned graph: populations land on their
    assigned chip in graph order, each chip placed with the single-chip
    compiler's own slot arithmetic.

    Returns ``(pe_slices, coords_local, chip_of_pe, coords)``: the
    population -> logical-PE slice map, per-PE within-chip QPE coords,
    per-PE chip index, and board-global QPE coords.  A pure function of
    (graph, board, part)."""
    chip_mesh = board.chip
    pe_slices: dict = {}
    cur = 0
    for pop in graph.populations:
        pe_slices[pop.name] = slice(cur, cur + pop.n_tiles)
        cur += pop.n_tiles
    n_pes = cur

    coords_local = np.zeros((n_pes, 2), np.int32)
    chip_of_pe = np.zeros(n_pes, np.int32)
    for c, pops in enumerate(part.chip_pops):
        if not pops:
            continue
        slots, _ = assign_slots(pops, chip_mesh.pes_per_qpe)
        pe_slot = []
        for pop in pops:
            a, b = slots[pop.name]
            pe_slot.extend(range(a, b))
        local = snake_coords(chip_mesh, pe_slot)
        off = 0
        for pop in pops:
            sl = pe_slices[pop.name]
            coords_local[sl] = local[off:off + pop.n_tiles]
            chip_of_pe[sl] = c
            off += pop.n_tiles
    chip_xy = np.array([board.chip_coord(c) for c in chip_of_pe])
    coords = coords_local + chip_xy * np.array(
        [chip_mesh.width, chip_mesh.height])
    return pe_slices, coords_local, chip_of_pe, coords


def population_dst_pes(graph: NetGraph, pe_slices: dict) -> dict:
    """Per source population, the concatenated destination PE ids in
    projection order (a 1x1 board concatenates exactly like the
    single-chip compiler)."""
    dst_slices: dict = {p.name: [] for p in graph.populations}
    for pr in graph.projections:
        dst_slices[pr.src].append(pe_slices[pr.dst])
    return {name: (np.concatenate([np.arange(s.start, s.stop)
                                   for s in sls])
                   if sls else np.empty(0, np.int64))
            for name, sls in dst_slices.items()}


def stitch_population(board: BoardSpec, noc: BoardNoc, name: str,
                      src_chip: int, by_chip: dict, tile_xy: np.ndarray,
                      route: RouteConfig):
    """Stitch one population's hierarchical multicast under a
    ``RouteConfig``.

    ``by_chip`` maps destination chip -> list of within-chip dst
    coords; ``tile_xy`` is the (n_tiles, 2) within-chip coords of the
    population's source tiles (all on ``src_chip``).  Returns
    ``(rows, hops, path_hops, n_x)``: per-tile global link-id rows, the
    per-tile worst hop depth, the per-tile latency-critical
    [on-chip, chip-to-chip] hop split, and the chip-to-chip link count
    (shared by every tile — they share one tree beyond the source PE).
    This is the one place routing choices turn into link ids."""
    o_tree = route.orient_tree(name)
    tree = chip_tree(board, src_chip, by_chip.keys(),
                     orientation=route.orient_chip(name))
    empty = np.empty((0, 2), np.int64)

    def eport(c, d):
        return route.port_index(name, c, d)

    # tile-independent part: entry trees + outgoing xlinks of every
    # non-source chip, plus the source chip's own outgoing xlinks
    ext_parts: list = []
    n_x = 0
    for c in sorted(tree):
        entry, exits = tree[c]
        xids = np.array([noc.xlink_id(c, d, eport(c, d)) for d in exits],
                        np.int32)
        n_x += len(exits)
        if c == src_chip:
            ext_parts.append(xids)
            continue
        # ``entry`` is the side the packet arrives on; the entry PORT is
        # picked by the upstream chip's exit assignment (port j bridges
        # to port j on the facing edge)
        cx, cy = board.chip_coord(c)
        sx, sy = DIR_STEP[entry]
        up = board.chip_index(cx + sx, cy + sy)
        j_in = eport(up, OPPOSITE[entry])
        targets = ([np.asarray(by_chip.get(c, empty), np.int64)
                    .reshape(-1, 2)]
                   + [np.asarray([board.port(d, eport(c, d))], np.int64)
                      for d in exits])
        t = np.concatenate(targets) if targets else empty
        ids = noc.chip_noc.tree_link_ids(board.port(entry, j_in), t,
                                         orientation=o_tree)
        ext_parts.append(ids + noc.chip_link_base(c))
        ext_parts.append(xids)
    ext = (np.concatenate(ext_parts).astype(np.int32) if ext_parts
           else np.empty(0, np.int32))

    # per-destination-chip path costs shared by every source tile:
    # (first exit direction + port, hops beyond the source chip)
    local_dst = np.asarray(by_chip.get(src_chip, empty),
                           np.int64).reshape(-1, 2)
    remote: list = []
    sc_xy = board.chip_coord(src_chip)
    for c in sorted(by_chip):
        if c == src_chip:
            continue
        path = oriented_route(sc_xy, board.chip_coord(c),
                              route.orient_chip(name))
        dirs = [_dir_of(a, b) for a, b in path]
        js = [eport(board.chip_index(*a), dirs[i])
              for i, (a, _) in enumerate(path)]
        h = len(path)                       # one hop per xlink
        for i in range(1, len(path)):       # intermediate chips
            h += _manhattan(board.port(OPPOSITE[dirs[i - 1]], js[i - 1]),
                            board.port(dirs[i], js[i]))
        entry = board.port(OPPOSITE[dirs[-1]], js[-1])
        h += max(_manhattan(entry, d) for d in by_chip[c])
        remote.append((dirs[0], js[0], h, len(path)))

    # per-tile rows: local tree to local dests + exit ports, then ext
    src_exits = tree[src_chip][1]
    src_targets = np.concatenate(
        [local_dst] + [np.asarray([board.port(d, eport(src_chip, d))],
                                  np.int64)
                       for d in src_exits]) if (
        len(local_dst) or src_exits) else empty
    base = noc.chip_link_base(src_chip)
    n = len(tile_xy)
    rows: list = []
    hops = np.zeros(n, np.int32)
    path_hops = np.zeros((n, 2), np.int32)
    for i in range(n):
        t_xy = tile_xy[i]
        local_ids = noc.chip_noc.tree_link_ids(t_xy, src_targets,
                                               orientation=o_tree)
        rows.append(np.concatenate([local_ids + base, ext])
                    if ext.size else local_ids + base)
        h_local = int(np.abs(local_dst - t_xy).sum(axis=1).max()) \
            if len(local_dst) else 0
        # candidate delivery paths as (on-chip, chip-to-chip) hop
        # pairs — ``h`` counts every hop beyond the source chip, x
        # of which are chip-to-chip, so on-chip = tile part + h - x
        cands = [(h_local, 0)] + [
            (_manhattan(t_xy, board.port(d0, j0)) + h - x, x)
            for d0, j0, h, x in remote]
        hops[i] = max(on + x for on, x in cands)    # worst hop DEPTH
        # latency-critical path: the pair maximizing tiered latency
        path_hops[i] = max(
            cands, key=lambda c: noc.path_latency_s(c[0], c[1]))
    return rows, hops, path_hops, n_x


@dataclass
class BoardProgram(ChipProgram):
    """A compiled board workload — a ``ChipProgram`` whose link space
    spans every chip plus the chip-to-chip tier.

    ``coords`` are board-global QPE coordinates (chip origin at
    (cx * W, cy * H)) for reporting; routing used ``coords_local`` +
    ``chip_of_pe``.  Runs on the unchanged ``ChipSim``.
    """
    board: Optional[BoardSpec] = None
    part: Optional[Partition] = None
    chip_of_pe: Optional[np.ndarray] = None      # (P,) chip index per PE
    coords_local: Optional[np.ndarray] = None    # (P, 2) within-chip QPE
    tree_links_x: Optional[np.ndarray] = None    # (P,) chip-to-chip links
    # (P, 2) [on-chip hops, chip-to-chip hops] of each source's
    # latency-critical delivery path — ONE real path's split, chosen with
    # each tier at its own hop cost (NOT independent maxima, which could
    # pair hops from two different destinations into a path that does
    # not exist)
    path_hops: Optional[np.ndarray] = None
    route: Optional[RouteConfig] = None          # routing choices used

    @property
    def energy_tree_links(self) -> np.ndarray:
        """(P, 2) [on-chip, chip-to-chip] per-source link split — what
        the tiered ``BoardNoc.traffic_energy_j`` prices."""
        return np.stack([self.sinc.tree_links - self.tree_links_x,
                         self.tree_links_x], axis=-1)

    @property
    def tree_hops_x(self) -> np.ndarray:
        """(P,) chip-to-chip hops of each source's latency-critical
        path."""
        return self.path_hops[:, 1]

    @functools.cached_property
    def worst_path_latency_s(self) -> float:
        """Worst multicast delivery latency with each tier at its own
        hop cost (the single-chip ``hop_latency_s`` generalized)."""
        if not len(self.path_hops):
            return 0.0
        lat = self.noc.path_latency_s(self.path_hops[:, 0].astype(float),
                                      self.path_hops[:, 1].astype(float))
        return float(np.max(lat))


def compile_board(graph: NetGraph, board: Optional[BoardSpec] = None,
                  pe: PESpec = PESpec(), part: Optional[Partition] = None,
                  refine: bool = True,
                  route: Optional[RouteConfig] = None) -> BoardProgram:
    """Compile ``graph`` onto a multi-chip ``board``.

    ``board=None`` auto-sizes a near-square grid of the default 2x2-QPE
    chips.  ``part`` lets callers reuse / inspect a partition; otherwise
    ``board.partition.partition`` runs (with ``refine``).  ``route``
    carries the free routing choices (tree orientations + border-port
    assignment, see ``routeopt.RouteConfig``); ``None`` keeps the fixed
    routes.  Raises ``ValueError`` up front for SRAM / capacity
    violations, naming the population at fault, and for a plasticity
    rule that does not fit its projection's payload, naming the edge
    (same contract as the single-chip compiler).
    """
    check_compilable(graph, pe)

    if board is None and part is not None:
        board = part.board
    if part is not None and part.board != board:
        raise ValueError(
            f"partition was built for a {part.board.chips_x}x"
            f"{part.board.chips_y} board of {part.board.chip.width}x"
            f"{part.board.chip.height} chips, not this board — "
            f"re-partition or pass the matching BoardSpec")
    if board is None:
        chip = MeshSpec(2, 2)
        for pop in graph.populations:       # unsatisfiable regardless of grid
            if assign_slots([pop], chip.pes_per_qpe)[1] > chip.n_pes:
                raise ValueError(
                    f"population {pop.name!r} needs more PE slots than one "
                    f"{chip.width}x{chip.height} QPE chip holds; pass an "
                    f"explicit BoardSpec with a bigger chip mesh")
        total = assign_slots(graph.populations, chip.pes_per_qpe)[1]
        side = max(1, int(np.ceil(np.sqrt(-(-total // chip.n_pes)))))
        while part is None:                 # grow until fragmentation fits
            board = BoardSpec(side, side, chip=chip)
            try:
                part = partition(graph, board, refine=refine)
            except ValueError:
                side += 1
    part = part or partition(graph, board, refine=refine)
    route = (route or RouteConfig()).validate(board)
    noc = BoardNoc(board)
    chip_mesh = board.chip

    # -- placement: snake within each chip, logical PEs in graph order ----
    pe_slices, coords_local, chip_of_pe, coords = \
        place_partition(graph, board, part)
    n_pes = len(coords)

    # -- routing table + packet classes (same contract as compile()) ------
    out_bits = source_packet_classes(graph)
    masks = np.zeros((n_pes, n_pes), bool)
    payload_bits = np.zeros(n_pes, np.int64)
    for pr in graph.projections:
        masks[pe_slices[pr.src], pe_slices[pr.dst]] = True
        payload_bits[pe_slices[pr.src]] = out_bits[pr.src]
    table = RoutingTable(masks)

    # -- hierarchical incidence: per population, shared by its tiles ------
    rows: list = [None] * n_pes
    hops = np.zeros(n_pes, np.int32)
    tl_x = np.zeros(n_pes, np.int64)
    path_hops = np.zeros((n_pes, 2), np.int32)
    dst_pes = population_dst_pes(graph, pe_slices)

    for pop in graph.populations:
        sl = pe_slices[pop.name]
        src_chip = int(chip_of_pe[sl.start])
        by_chip: dict = {}
        for p in dst_pes[pop.name]:
            by_chip.setdefault(int(chip_of_pe[p]), []).append(
                coords_local[p])
        p_rows, p_hops, p_ph, n_x = stitch_population(
            board, noc, pop.name, src_chip, by_chip, coords_local[sl],
            route)
        rows[sl.start:sl.stop] = p_rows
        hops[sl] = p_hops
        path_hops[sl] = p_ph
        tl_x[sl] = n_x

    sinc = SparseIncidence.from_rows(rows, noc.n_links, hops)

    sram = np.zeros(n_pes, np.int64)
    for pop in graph.populations:
        sram[pe_slices[pop.name]] = pop.sram_bytes

    return BoardProgram(graph=graph, mesh=chip_mesh, noc=noc,
                        coords=coords.astype(np.int32), table=table,
                        sinc=sinc, payload_bits=payload_bits,
                        sram_bytes=sram, pe_slices=pe_slices,
                        learn_slots=lower_plasticity(graph, pe_slices),
                        board=board, part=part, chip_of_pe=chip_of_pe,
                        coords_local=coords_local, tree_links_x=tl_x,
                        path_hops=path_hops, route=route)
