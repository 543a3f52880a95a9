"""Board-level topology: a grid of SpiNNaker2 chips joined by
chip-to-chip links (Mayr et al., arXiv:1911.02385 Sec. 2).

A board is ``chips_x x chips_y`` identical chips; each chip is the W x H
QPE mesh of ``repro_torch.chip.mesh_noc.MeshSpec``, and adjacent chips are
joined by dedicated chip-to-chip links attached at fixed border "port"
QPEs.  The two link tiers carry the same 192-bit DNoC flits but price
differently: the chip-to-chip SerDes bridge is slower per hop and costs
an order of magnitude more energy per bit than an on-chip NoC hop, so
the partitioner's job (``board.partition``) is to keep traffic on the
cheap tier.

``BoardNoc`` owns the board-global link id space — every chip's on-chip
links (one shared ``MeshNoc`` enumeration, offset per chip) followed by
the chip-to-chip links — and inherits the per-tick accounting from
``NocAccounting``, so the board-wide CSR ``SparseIncidence`` built by
``board.route`` runs on the unchanged ``ChipSim`` engine.  Only
``traffic_energy_j`` is overridden: it prices the two tiers separately
from a (P, 2) per-source [on-chip, chip-to-chip] tree-link split, and
is the literal single-chip formula when a board has no chip-to-chip
links (the 1x1 golden anchor).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.chip.mesh_noc import MeshNoc, MeshSpec, NocAccounting
from repro_torch.configs import paper
from repro_torch.core.noc import NocSpec

# directions over the chip grid (and out of a chip's border ports)
EAST, WEST, NORTH, SOUTH = "E", "W", "N", "S"
DIRS = (EAST, WEST, NORTH, SOUTH)
OPPOSITE = {EAST: WEST, WEST: EAST, NORTH: SOUTH, SOUTH: NORTH}
DIR_STEP = {EAST: (1, 0), WEST: (-1, 0), NORTH: (0, 1), SOUTH: (0, -1)}


def xlink_spec() -> NocSpec:
    """Chip-to-chip link tier: same 192 b flit format crossing the
    bridge, but a serialized inter-chip hop costs ~8x the cycles of an
    on-chip router hop and ~1 pJ/bit against 0.08 pJ/bit on-chip
    (22FDSOI-class planning constants; Mayr et al. report 6 full-duplex
    chip-to-chip links per chip at a fraction of the NoC bandwidth)."""
    return NocSpec(hop_cycles=paper.NOC_HOP_CYCLES * 8,
                   pj_per_bit_hop=1.0)


@dataclass(frozen=True)
class BoardSpec:
    """``chips_x x chips_y`` grid of identical chips.

    ``chip`` is the per-chip QPE mesh; ``noc``/``xlink`` are the on-chip
    and chip-to-chip link tiers.  Chips index row-major: chip c sits at
    grid coordinate (c % chips_x, c // chips_x).
    """
    chips_x: int
    chips_y: int
    chip: MeshSpec = field(default_factory=lambda: MeshSpec(2, 2))
    noc: NocSpec = field(default_factory=NocSpec)
    xlink: NocSpec = field(default_factory=xlink_spec)
    # parallel SerDes bridges per chip edge: 1 is the mid-edge port;
    # >= 2 spreads chip-to-chip traffic across border ports
    ports_per_edge: int = 1

    def __post_init__(self):
        k = self.ports_per_edge
        lim = min(self.chip.width, self.chip.height)
        if not 1 <= k <= lim:
            raise ValueError(
                f"ports_per_edge={k} out of range for a "
                f"{self.chip.width}x{self.chip.height} chip mesh; each "
                f"edge can host 1..{lim} distinct border port QPEs")

    @property
    def n_chips(self) -> int:
        return self.chips_x * self.chips_y

    @property
    def n_pes(self) -> int:
        return self.n_chips * self.chip.n_pes

    def chip_coord(self, c: int) -> tuple[int, int]:
        return (c % self.chips_x, c // self.chips_x)

    def chip_index(self, cx: int, cy: int) -> int:
        return cy * self.chips_x + cx

    def port(self, d: str, j: int = 0) -> tuple[int, int]:
        """Within-chip QPE coordinate of border port ``j`` serving the
        chip-to-chip links in direction ``d`` (j=0 is the mid-edge port
        when there is one port an edge)."""
        return self.ports(d)[j]

    def ports(self, d: str) -> list:
        """All ``ports_per_edge`` border port QPE coordinates on edge
        ``d``, evenly spread along it.  Port j on edge ``d`` bridges to
        port j on the neighbor's ``OPPOSITE[d]`` edge (the spread
        formula depends only on the perpendicular extent, so paired
        ports face each other)."""
        W, H = self.chip.width, self.chip.height
        k = self.ports_per_edge
        if d in (EAST, WEST):
            x = W - 1 if d == EAST else 0
            return [(x, (j + 1) * H // (k + 1)) for j in range(k)]
        y = H - 1 if d == NORTH else 0
        return [((j + 1) * W // (k + 1), y) for j in range(k)]

    @staticmethod
    def parse(board: str, chip: str = "2x2") -> "BoardSpec":
        """'4x12' board of '4x2' chips -> BoardSpec (CLI convenience)."""
        bx, by = (int(v) for v in board.lower().split("x"))
        cw, ch = (int(v) for v in chip.lower().split("x"))
        return BoardSpec(bx, by, chip=MeshSpec(cw, ch))


@dataclass
class BoardNoc(NocAccounting):
    """Board-global link space + tiered per-tick accounting.

    Link ids: chip c's on-chip links occupy
    ``[c * links_per_chip, (c+1) * links_per_chip)`` — the SAME
    enumeration ``MeshNoc`` uses for a single chip, so a 1x1 board's ids
    are bit-identical to the single-chip compiler's — followed by the
    directed chip-to-chip links.  ``xlink_mask`` (1.0 on chip-to-chip
    links) is what the engine uses for the per-tier record split.
    """
    board: BoardSpec

    def __post_init__(self):
        self.spec = self.board.noc
        self.xspec = self.board.xlink
        self.chip_noc = MeshNoc(self.board.chip, spec=self.board.noc)
        self.links_per_chip = self.chip_noc.n_links
        self.n_onchip_links = self.board.n_chips * self.links_per_chip
        # directed chip-to-chip links, enumerated like MeshNoc's mesh
        # links: (chip index, outgoing direction, port j) -> global xlink
        # ordinal
        self.xlink_index: dict = {}
        self.xlinks: list = []
        bx, by = self.board.chips_x, self.board.chips_y
        k = self.board.ports_per_edge
        for cy in range(by):
            for cx in range(bx):
                if cx + 1 < bx:
                    for j in range(k):
                        self._add_xlink((cx, cy), EAST, j)
                        self._add_xlink((cx + 1, cy), WEST, j)
                if cy + 1 < by:
                    for j in range(k):
                        self._add_xlink((cx, cy), NORTH, j)
                        self._add_xlink((cx, cy + 1), SOUTH, j)
        self.n_xchip_links = len(self.xlinks)
        mask = np.zeros(self.n_links, np.float32)
        mask[self.n_onchip_links:] = 1.0
        self.xlink_mask = mask

    def _add_xlink(self, chip_xy, d, j):
        c = self.board.chip_index(*chip_xy)
        self.xlink_index[(c, d, j)] = len(self.xlinks)
        self.xlinks.append((c, d, j))

    @property
    def n_links(self) -> int:
        return self.n_onchip_links + self.n_xchip_links

    def chip_link_base(self, c: int) -> int:
        """Global id of chip c's first on-chip link."""
        return c * self.links_per_chip

    def xlink_id(self, c: int, d: str, j: int = 0) -> int:
        """Global link id of chip c's outgoing chip-to-chip link in
        direction d through border port j."""
        return self.n_onchip_links + self.xlink_index[(c, d, j)]

    def link_endpoints(self, link_id: int):
        """((chip, (x, y)), (chip, (x, y))) endpoints of any global
        link."""
        if link_id < self.n_onchip_links:
            c, local = divmod(link_id, self.links_per_chip)
            a, b = self.chip_noc.links[local]
            return (c, a), (c, b)
        c, d, j = self.xlinks[link_id - self.n_onchip_links]
        cx, cy = self.board.chip_coord(c)
        dx, dy = DIR_STEP[d]
        nbr = self.board.chip_index(cx + dx, cy + dy)
        return ((c, self.board.port(d, j)),
                (nbr, self.board.port(OPPOSITE[d], j)))

    def tier_masks(self) -> dict:
        """Two-tier twin of ``NocAccounting.tier_masks``: the cheap
        on-chip tier and the SerDes chip-to-chip tier, as 0/1 masks over
        the board-global link-id space."""
        return {"onchip": 1.0 - self.xlink_mask, "xchip": self.xlink_mask}

    # -- tiered pricing ---------------------------------------------------

    def traffic_energy_j(self, packets, tree_links, bits):
        """Two-tier twin of ``NocAccounting.traffic_energy_j``:
        ``tree_links`` (P, 2) float32 is the per-source [on-chip,
        chip-to-chip] link-count split (``BoardProgram.
        energy_tree_links``), each tier priced at its own pJ/bit-hop;
        ``bits`` (P,) from ``packet_costs``.  A board with no chip-to-chip
        links (1x1) takes the literal single-chip expression, not the
        two-term sum with a zero cross term, so that the 1x1 anchor stays
        bitwise, as in the reference."""
        pk = packets.to(torch.float32)
        bits_on = pk * tree_links[..., 0] * bits
        if self.n_xchip_links == 0:
            return bits_on.sum(-1) * self.spec.pj_per_bit_hop * 1e-12
        on = bits_on.sum(-1) * self.spec.pj_per_bit_hop
        xc = (pk * tree_links[..., 1] * bits).sum(-1) \
            * self.xspec.pj_per_bit_hop
        return (on + xc) * 1e-12

    def xchip_energy_j(self, packets, tree_links_x, bits):
        """Chip-to-chip share of ``traffic_energy_j`` (the engine's
        ``e_noc_xchip`` record): ``tree_links_x`` (P,) float32."""
        traffic = packets.to(torch.float32) * tree_links_x * bits
        return traffic.sum(-1) * self.xspec.pj_per_bit_hop * 1e-12

    def path_latency_s(self, on_hops, x_hops) -> float:
        """Latency of a path with ``on_hops`` on-chip and ``x_hops``
        chip-to-chip hops, each tier at its own clock."""
        return (on_hops * self.spec.hop_cycles / self.spec.freq_hz
                + x_hops * self.xspec.hop_cycles / self.xspec.freq_hz)
