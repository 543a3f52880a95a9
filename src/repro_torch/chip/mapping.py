"""Snake-order placement of workloads onto the PE mesh.

Population tiles land on consecutive placement slots in boustrophedon
order over the QPE grid, so ring neighbours stay mesh neighbours.  Two
older placers sit beside the graph compiler's slot arithmetic:

* ``place_ring``   — neuron populations of a synfire ring onto PEs in
  snake order (only the wrap-around edge crosses the chip).
* ``place_layers`` — feedforward DNN layers split into 128 kB-SRAM tiles
  (``pe.partition_layer_to_sram``), tiles on consecutive PEs.

Both give a ``RoutingTable`` and the dense link incidence of each
source's X/Y multicast tree (numpy, as in the reference).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.chip.mesh_noc import MeshNoc, MeshSpec
from repro_torch.configs import paper
from repro_torch.core.pe import PESpec, partition_layer_to_sram
from repro_torch.core.router import RoutingTable


def snake_order(mesh: MeshSpec) -> list[int]:
    """QPE indices in boustrophedon order: adjacent in the order =>
    adjacent on the mesh."""
    order = []
    for y in range(mesh.height):
        xs = range(mesh.width) if y % 2 == 0 else range(mesh.width - 1, -1, -1)
        order.extend(y * mesh.width + x for x in xs)
    return order


def snake_coords(mesh: MeshSpec, slots) -> np.ndarray:
    """(len(slots), 2) QPE coords of placement slots in snake order."""
    qpe_order = snake_order(mesh)
    return np.array([mesh.qpe_coord(qpe_order[s // mesh.pes_per_qpe])
                     for s in slots], np.int32).reshape(-1, 2)


def assign_slots(populations, pes_per_qpe: int) -> tuple:
    """Map population tiles to consecutive placement slots.

    Returns (slots_per_pop: dict name -> (start, stop), total_slots).
    ``align_qpe`` populations start on a QPE boundary and reserve whole
    QPEs."""
    slots = {}
    cur = 0
    for pop in populations:
        if pop.align_qpe and cur % pes_per_qpe:
            cur += pes_per_qpe - cur % pes_per_qpe
        slots[pop.name] = (cur, cur + pop.n_tiles)
        cur += pop.n_tiles
        if pop.align_qpe and cur % pes_per_qpe:
            cur += pes_per_qpe - cur % pes_per_qpe
    return slots, cur


@dataclass
class Placement:
    """Where each logical PE of a workload lives, how its spikes route,
    and the precomputed link-incidence of each source's multicast tree."""
    mesh: MeshSpec
    noc: MeshNoc
    coords: np.ndarray                  # (P, 2) int: QPE coord of logical PE
    table: RoutingTable                 # (P, P) key -> destination masks
    inc: np.ndarray                     # (P, n_links) float32 incidence
    sram_bytes_per_pe: int = 0          # workload state per PE (fits check)

    @property
    def n_pes(self) -> int:
        return len(self.coords)

    @property
    def worst_tree_hops(self) -> int:
        c = np.asarray(self.coords, np.int64)
        dist = np.abs(c[:, None, :] - c[None, :, :]).sum(axis=-1)
        return int((dist * self.table.masks).max(initial=0))

    def fits(self, pe: PESpec = PESpec()) -> bool:
        return pe.fits_sram(self.sram_bytes_per_pe)


def _incidence_from_table(noc: MeshNoc, coords, table: RoutingTable):
    c = np.asarray(coords, np.int64)
    dst_lists = [c[np.flatnonzero(m)] for m in table.masks]
    return noc.sparse_incidence(c, dst_lists).dense()


def synfire_sram_bytes(sp: paper.SynfireParams = paper.SYNFIRE) -> int:
    """Per-PE synfire state: sparse synapse words (the hardware stores
    synapse lists, not the dense debug matrices), neuron state, FIFOs."""
    syn = sp.synapses_per_core * 4                      # word per synapse
    neuron = sp.neurons_per_core * 3 * 4                # v, ref, params
    fifo = (int(sp.delay_exc_ms) * sp.n_exc
            + int(sp.delay_inh_ms) * sp.n_inh) // 8 + 1024
    return syn + neuron + fifo


def place_ring(n_pes: int, mesh: MeshSpec | None = None,
               sp: paper.SynfireParams = paper.SYNFIRE,
               pe: PESpec = PESpec()) -> Placement:
    """Place an ``n_pes`` synfire ring on the mesh (auto-sized if None)."""
    mesh = mesh or MeshSpec.for_pes(n_pes)
    if n_pes > mesh.n_pes:
        raise ValueError(f"ring of {n_pes} PEs > mesh capacity {mesh.n_pes}")
    sram = synfire_sram_bytes(sp)
    if not pe.fits_sram(sram):
        raise ValueError(f"synfire core state {sram} B exceeds PE SRAM")

    coords = snake_coords(mesh, range(n_pes))
    table = RoutingTable.ring(n_pes)
    noc = MeshNoc(mesh)
    inc = _incidence_from_table(noc, coords, table)
    return Placement(mesh=mesh, noc=noc, coords=coords, table=table,
                     inc=inc, sram_bytes_per_pe=sram)


# -------------------------------------------------------------------------
# DNN layer placement
# -------------------------------------------------------------------------

@dataclass
class LayerPlacement:
    """One feedforward layer split into SRAM-sized tiles on a PE range."""
    name: str
    h: int; w: int; cin: int; cout: int; kh: int; kw: int
    rows_per_tile: int
    cout_per_tile: int
    n_tiles: int
    pes: list[int] = field(default_factory=list)     # logical PE ids
    cycles_per_tile: float = 0.0
    out_bytes: int = 0                          # activations to next layer


def place_layers(layers: list[dict], mesh: MeshSpec | None = None,
                 pe: PESpec = PESpec(), bytes_per: int = 1):
    """Split each layer into PE-sized tiles and assign tiles to consecutive
    PEs in snake order.  ``layers``: dicts with h,w,cin,cout,kh,kw[,name].

    Returns (placements, noc, inc, tile_coords):
      placements — per-layer ``LayerPlacement``
      inc        — (n_used_pes, n_links) incidence of each tile-PE's
                   multicast tree to ALL next-layer tile PEs (every output
                   tile feeds every next-layer input tile: full halo)
    """
    total_tiles = 0
    placements: list[LayerPlacement] = []
    for li, ly in enumerate(layers):
        rows, cout_t, n_tiles = partition_layer_to_sram(
            pe, ly["h"], ly["w"], ly["cin"], ly["cout"],
            ly["kh"], ly["kw"], bytes_per=bytes_per)
        lp = LayerPlacement(
            name=ly.get("name", f"layer{li}"),
            h=ly["h"], w=ly["w"], cin=ly["cin"], cout=ly["cout"],
            kh=ly["kh"], kw=ly["kw"],
            rows_per_tile=rows, cout_per_tile=cout_t, n_tiles=n_tiles,
            pes=list(range(total_tiles, total_tiles + n_tiles)),
            cycles_per_tile=pe.mac_conv_cycles(
                min(rows, ly["h"]), ly["w"], ly["cin"], cout_t,
                ly["kh"], ly["kw"]),
            out_bytes=ly["h"] * ly["w"] * ly["cout"] * bytes_per,
        )
        placements.append(lp)
        total_tiles += n_tiles

    mesh = mesh or MeshSpec.for_pes(total_tiles)
    if total_tiles > mesh.n_pes:
        raise ValueError(f"{total_tiles} tiles > mesh capacity {mesh.n_pes}")
    coords = snake_coords(mesh, range(total_tiles))

    # routing: every tile of layer i multicasts its activations to every
    # tile of layer i+1 (dense feedforward halo)
    masks = np.zeros((total_tiles, total_tiles), bool)
    for cur, nxt in zip(placements[:-1], placements[1:]):
        for p in cur.pes:
            masks[p, nxt.pes] = True
    table = RoutingTable(masks)
    noc = MeshNoc(mesh)
    inc = _incidence_from_table(noc, coords, table)
    return placements, noc, inc, coords
