"""Graph -> ChipProgram compiler (numpy, as in the reference).

``compile(graph, mesh)`` lowers a ``NetGraph`` to what the engine needs:
placement of population tiles on consecutive PEs in snake order
(validated against mesh capacity and the 128 kB PE SRAM first), a dense
``RoutingTable``, each source's X/Y multicast tree as a CSR
``SparseIncidence`` (X-first, or Y-first per population), and
per-source packet classes; projections with a ``plasticity=`` rule lower
into ``LearnSlot`` descriptors (``learn.lower``), which the engine turns
into per-tick weight updates.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from repro_torch.chip.graph import GRADED, NetGraph
from repro_torch.chip.mapping import assign_slots, snake_coords
from repro_torch.chip.mesh_noc import MeshNoc, MeshSpec, SparseIncidence
from repro_torch.core.pe import PESpec
from repro_torch.core.router import RoutingTable
from repro_torch.learn.lower import lower_plasticity


@dataclass
class ChipProgram:
    """A compiled workload: placement + routing + packet classes + step."""
    graph: NetGraph
    mesh: MeshSpec
    noc: MeshNoc
    coords: np.ndarray          # (P, 2) int: QPE coord of each logical PE
    table: RoutingTable         # (P, P) source PE -> destination mask
    sinc: SparseIncidence       # CSR multicast incidence + tree hop depths
    payload_bits: np.ndarray    # (P,) int: payload bits per packet (0=spike)
    sram_bytes: np.ndarray      # (P,) int: per-PE workload state
    pe_slices: dict             # population name -> slice of logical PEs
    learn_slots: tuple = ()     # lowered plastic projections (learn)

    @property
    def n_pes(self) -> int:
        return len(self.coords)

    @functools.cached_property
    def inc(self) -> np.ndarray:
        """Dense (P, n_links) 0/1 incidence, materialized on demand."""
        return self.sinc.dense()

    @property
    def tree_links(self) -> np.ndarray:
        """(P,) multicast-tree link count per source."""
        return self.sinc.tree_links

    @property
    def energy_tree_links(self) -> np.ndarray:
        """Per-source link counts the engine prices NoC energy with: one
        link tier on a chip, so ``tree_links``; a ``BoardProgram`` gives a
        (P, 2) [on-chip, chip-to-chip] split for its tiered pricing."""
        return self.tree_links

    @functools.cached_property
    def worst_tree_hops(self) -> int:
        return int(self.sinc.tree_hops.max(initial=0))

    def fits(self, pe: PESpec = PESpec()) -> bool:
        return bool((self.sram_bytes <= pe.sram_bytes).all())

    def init_state(self, device):
        return self.graph.semantics.init_state(self, device)

    def make_tick(self, *, dvfs, em, seed, noise, device):
        return self.graph.semantics.make_tick(self, dvfs=dvfs, em=em,
                                              seed=seed, noise=noise,
                                              device=device)

    def make_event_tick(self, *, dvfs, em, seed, noise, device):
        """The semantics' activity-compressed tick, or None when the
        workload has no compressed form (the engine then runs the dense
        tick under event-mode NoC accounting: the same records)."""
        make = getattr(self.graph.semantics, "make_event_tick", None)
        return make(self, dvfs=dvfs, em=em, seed=seed, noise=noise,
                    device=device) if make else None


def check_compilable(graph: NetGraph, pe: PESpec) -> None:
    """What the chip and the board compilers refuse up front: a graph
    without tick semantics and a tile over the PE SRAM, each naming its
    culprit."""
    if graph.semantics is None:
        raise ValueError(f"graph {graph.name!r} has no tick semantics; "
                         "attach one before compiling")
    for pop in graph.populations:
        if pop.sram_bytes > pe.sram_bytes:
            raise ValueError(
                f"population {pop.name!r}: per-tile state {pop.sram_bytes} B"
                f" exceeds the {pe.sram_bytes} B PE SRAM — split it into "
                f"more tiles")


def source_packet_classes(graph: NetGraph) -> dict:
    """Per-source-population payload bits (0 = spike packet); a population
    mixing packet classes on its out-edges is rejected."""
    out_bits: dict = {}
    for pr in graph.projections:
        bits = pr.bits_per_packet if pr.payload == GRADED else 0
        prev = out_bits.setdefault(pr.src, bits)
        if prev != bits:
            raise ValueError(
                f"population {pr.src!r} mixes packet classes on its "
                f"out-projections ({prev} vs {bits} payload bits); split "
                f"it into one population per packet class")
    return out_bits


def compile(graph: NetGraph, mesh: MeshSpec | None = None,
            pe: PESpec = PESpec(),
            orientations: dict | None = None) -> ChipProgram:  # noqa: A001
    """Compile ``graph`` onto ``mesh`` (auto-sized when None).

    ``orientations`` optionally maps population name -> tree orientation
    ("xy"/"yx", ``core.noc.ORIENTATIONS``); unlisted populations, and the
    default None, keep X-first trees.  Orientation changes only the NoC
    link accounting, never neuron-state records.  Raises ``ValueError``
    up front, naming the population at fault, when a tile exceeds the PE
    SRAM or the graph exceeds the mesh, and naming the edge when a
    plasticity rule does not fit its projection's payload.
    """
    check_compilable(graph, pe)

    pes_per_qpe = (mesh.pes_per_qpe if mesh is not None
                   else MeshSpec.for_pes(1).pes_per_qpe)
    slots, total_slots = assign_slots(graph.populations, pes_per_qpe)
    mesh = mesh or MeshSpec.for_pes(total_slots)

    if total_slots > mesh.n_pes:
        need = MeshSpec.for_pes(total_slots, mesh.pes_per_qpe)
        raise ValueError(
            f"graph {graph.name!r} needs {total_slots} PE slots "
            f"({graph.n_tiles_total} tiles over "
            f"{len(graph.populations)} populations) but the "
            f"{mesh.width}x{mesh.height} QPE mesh holds {mesh.n_pes} PEs; "
            f"use at least a {need.width}x{need.height} mesh")

    # logical PE id per tile: compact the slot ranges (alignment gaps are
    # left unoccupied on the mesh but carry no logical PE)
    pe_slices = {}
    pe_slot = []
    cur = 0
    for pop in graph.populations:
        a, b = slots[pop.name]
        pe_slices[pop.name] = slice(cur, cur + pop.n_tiles)
        pe_slot.extend(range(a, b))
        cur += pop.n_tiles
    n_pes = cur

    coords = snake_coords(mesh, pe_slot)
    out_bits = source_packet_classes(graph)

    # routing: every tile of src multicasts to every tile of dst
    masks = np.zeros((n_pes, n_pes), bool)
    payload_bits = np.zeros(n_pes, np.int64)
    for pr in graph.projections:
        masks[pe_slices[pr.src], pe_slices[pr.dst]] = True
        payload_bits[pe_slices[pr.src]] = out_bits[pr.src]
    table = RoutingTable(masks)

    # incidence: all tiles of a population share one destination set,
    # computed once per population; each tile's tree is arithmetic
    noc = MeshNoc(mesh)
    dst_slices: dict = {p.name: [] for p in graph.populations}
    for pr in graph.projections:
        dst_slices[pr.src].append(pe_slices[pr.dst])
    empty = np.empty((0, 2), np.int64)
    dst_lists = []
    orients = []
    for pop in graph.populations:
        sls = dst_slices[pop.name]
        dst_xy = np.concatenate([coords[sl] for sl in sls]) if sls else empty
        dst_lists.extend([dst_xy] * pop.n_tiles)
        orients.extend([(orientations or {}).get(pop.name, "xy")]
                       * pop.n_tiles)
    sinc = noc.sparse_incidence(coords, dst_lists, orientations=orients)

    sram = np.zeros(n_pes, np.int64)
    for pop in graph.populations:
        sram[pe_slices[pop.name]] = pop.sram_bytes

    return ChipProgram(graph=graph, mesh=mesh, noc=noc, coords=coords,
                       table=table, sinc=sinc, payload_bits=payload_bits,
                       sram_bytes=sram, pe_slices=pe_slices,
                       learn_slots=lower_plasticity(graph, pe_slices))
