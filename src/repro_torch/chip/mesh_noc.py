"""Mesh NoC traffic model (paper Sec. III-A/B at chip scale).

The chip is a W x H mesh of QPEs (4 PEs each) joined by directed links.
Spike delivery is multicast: the router duplicates a packet at branch
points of its X/Y tree, so a tree's cost is its set of distinct links.

* **setup** (numpy, as in the reference) — each source's X-first (or
  Y-first) multicast tree is derived arithmetically from its destination
  coordinates and stored as a CSR ``SparseIncidence`` of (link_ids,
  source_ptr).
* **per tick** (torch, on the sim's device) — per-link loads are either
  the dense product ``packets @ inc`` over the densified incidence
  (small meshes), the segmented sum over each link's sources of
  ``kernels/link_load`` (board-scale meshes, dense execution; one launch
  for both the packet and the flit rows), or, in event execution mode,
  the gather of the active sources' padded rows with an atomic
  accumulation (``kernels/event_gather``).  All are exact on
  integer-valued packet counts, so they agree bitwise.  The flits and
  bits of each source's packet (``packet_costs``) are computed once per
  run where the payload bits are static.  ``NocAccounting`` holds this
  per-tick part, shared by ``MeshNoc`` and the board's ``BoardNoc``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.noc import ORIENTATIONS, NocSpec
from repro_torch.kernels.event_gather.ops import event_link_loads
from repro_torch.kernels.link_load.ops import noc_link_loads

SPIKE_PACKET_BITS = 64        # header-only DNoC spike packet

# ChipSim's auto-select of the accounting path (the reference's values):
# dense above this incidence density, above MAX_SPARSE_COLS sources on one
# link, or below MIN_SPARSE_LINKS links; sparse otherwise
DENSE_DENSITY = 0.25
MAX_SPARSE_COLS = 128
MIN_SPARSE_LINKS = 128
# the sparse accounting's plan: the padded link-major table up to this
# fan-in, the CSC layout above it.  The padded walk learns only from a
# slot's load whether the next slot is used; CSC reads a link's extent
# first, and its entries' loads then need not wait on each other.
# Measured on an H100 (PERF.md section 6): padded is faster at the
# 4096-PE ring's fan-in of 1, CSC at the 4096-PE farm's fan-in of 64
PADDED_MAX_FAN_IN = 1


@dataclass(frozen=True)
class MeshSpec:
    """W x H QPE mesh; PEs number QPE-major (PE p lives in QPE p // 4)."""
    width: int
    height: int
    pes_per_qpe: int = 4

    @property
    def n_qpes(self) -> int:
        return self.width * self.height

    @property
    def n_pes(self) -> int:
        return self.n_qpes * self.pes_per_qpe

    def qpe_coord(self, q: int) -> tuple[int, int]:
        return (q % self.width, q // self.width)

    @staticmethod
    def for_pes(n_pes: int, pes_per_qpe: int = 4) -> "MeshSpec":
        """Smallest near-square mesh holding ``n_pes`` PEs."""
        q = -(-n_pes // pes_per_qpe)
        w = int(np.ceil(np.sqrt(q)))
        h = -(-q // w)
        return MeshSpec(w, h, pes_per_qpe)


def _concat_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenation of the integer ranges [starts[i], starts[i]+lens[i]),
    without a Python loop."""
    ends = np.cumsum(lens)
    total = int(ends[-1]) if lens.size else 0
    if total == 0:
        return np.empty(0, np.int64)
    return np.repeat(starts, lens) + np.arange(total) - np.repeat(
        ends - lens, lens)


@dataclass
class SparseIncidence:
    """CSR multicast-tree incidence: source p's tree is the distinct link
    ids ``link_ids[source_ptr[p]:source_ptr[p+1]]``; ``tree_hops[p]`` is
    the worst hop depth of that tree.  Equivalent to the dense 0/1
    ``(P, n_links)`` tensor (``dense()``)."""
    link_ids: np.ndarray        # (nnz,) int32 — distinct within a source
    source_ptr: np.ndarray      # (P + 1,) int64 CSR row pointer
    n_links: int
    tree_hops: np.ndarray       # (P,) int32 worst-case hops per source

    @property
    def n_sources(self) -> int:
        return len(self.source_ptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.link_ids)

    @property
    def density(self) -> float:
        cells = self.n_sources * self.n_links
        return self.nnz / cells if cells else 1.0

    @functools.cached_property
    def tree_links(self) -> np.ndarray:
        """(P,) link count of each source's multicast tree."""
        return np.diff(self.source_ptr).astype(np.int64)

    @functools.cached_property
    def src_of_entry(self) -> np.ndarray:
        """(nnz,) source id of each CSR entry."""
        return np.repeat(np.arange(self.n_sources, dtype=np.int32),
                         self.tree_links)

    @staticmethod
    def from_rows(rows, n_links: int, tree_hops) -> "SparseIncidence":
        """Assemble the CSR form from per-source link-id arrays."""
        lens = np.array([r.size for r in rows], np.int64)
        ptr = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=ptr[1:])
        ids = (np.concatenate(rows).astype(np.int32) if rows
               else np.empty(0, np.int32))
        return SparseIncidence(link_ids=ids, source_ptr=ptr,
                               n_links=n_links,
                               tree_hops=np.asarray(tree_hops, np.int32))

    @functools.cached_property
    def max_fan_in(self) -> int:
        """Max sources sharing one link."""
        return int(np.bincount(self.link_ids, minlength=1).max())

    @functools.cached_property
    def csc(self) -> tuple[np.ndarray, np.ndarray]:
        """Link-major (CSC) view: (src_sorted, link_ptr) with entries
        sorted by link id — the layout of ``kernels/link_load``."""
        order = np.argsort(self.link_ids, kind="stable")
        counts = np.bincount(self.link_ids, minlength=self.n_links)
        link_ptr = np.zeros(self.n_links + 1, np.int64)
        np.cumsum(counts, out=link_ptr[1:])
        return self.src_of_entry[order], link_ptr

    @functools.cached_property
    def link_major(self) -> np.ndarray:
        """(max_fan_in, n_links) int32: column l lists link l's sources in
        CSC order, padded with the sentinel ``n_sources`` — the padded
        plan of ``kernels/link_load``, slot-major so that a warp's links
        read each slot in one coalesced load."""
        src_sorted, link_ptr = self.csc
        out = np.full((self.max_fan_in, self.n_links), self.n_sources,
                      np.int32)
        if self.nnz:
            counts = np.diff(link_ptr)
            link = np.repeat(np.arange(self.n_links), counts)
            slot = np.arange(self.nnz) - np.repeat(link_ptr[:-1], counts)
            out[slot, link] = src_sorted
        return out

    @functools.cached_property
    def padded_rows(self) -> np.ndarray:
        """(P, max tree size) rectangular row layout: source p's link ids
        right-padded with the sentinel ``n_links`` — the gatherable form
        the event-mode accounting indexes by active source
        (``kernels/event_gather``)."""
        L = max(1, int(self.tree_links.max(initial=0)))
        out = np.full((self.n_sources, L), self.n_links, np.int32)
        if self.nnz:
            col = (np.arange(self.nnz)
                   - np.repeat(self.source_ptr[:-1], self.tree_links))
            out[self.src_of_entry, col] = self.link_ids
        return out

    def dense(self) -> np.ndarray:
        """Materialize the (P, n_links) 0/1 incidence tensor."""
        m = np.zeros((self.n_sources, self.n_links), np.float32)
        m[self.src_of_entry, self.link_ids] = 1.0
        return m


class NocAccounting:
    """Per-tick NoC accounting over a multicast incidence, shared by the
    on-chip ``MeshNoc`` and the board-level ``repro_torch.board.BoardNoc``:
    anything with a ``spec`` (``NocSpec``) and an ``n_links`` link count
    prices traffic the same way, so single-chip and board programs run on
    one engine.  The methods take and return tensors on the caller's
    device and hold no state; the sparse accounting dispatches on the
    tensors' device (plain versions on the CPU, kernels on the card).
    """

    def device_plan(self, sinc: SparseIncidence, device) -> tuple:
        """The sparse accounting's plan on ``device``, by the incidence's
        shape: (link_major, None) for a max fan-in up to
        ``PADDED_MAX_FAN_IN``, else the CSC layout (src_sorted, link_ptr),
        both int32.  Build once per run, outside the tick loop."""
        if sinc.max_fan_in <= PADDED_MAX_FAN_IN:
            return torch.as_tensor(sinc.link_major, device=device), None
        src_sorted, link_ptr = sinc.csc
        return (torch.as_tensor(src_sorted.astype(np.int32), device=device),
                torch.as_tensor(link_ptr.astype(np.int32), device=device))

    def noc_loads(self, packets, plan, flits):
        """One tick's (link_loads, flit_loads) through ``device_plan``'s
        plan, both rows in one kernel launch; ``flits`` (P,) float32 from
        ``packet_costs``.  A fleet's (w, P) packets (and flits (P,) or
        (w, P)) give (w, n_links) loads, in one launch as well."""
        both = noc_link_loads(packets.to(torch.float32).contiguous(),
                              flits.contiguous(), *plan,
                              n_links=self.n_links)
        return both[0], both[1]

    def event_plan(self, sinc: SparseIncidence, device) -> torch.Tensor:
        """The padded-row layout on ``device`` for ``event_noc_loads``.
        Build once per run, outside the tick loop."""
        return torch.as_tensor(sinc.padded_rows, device=device)

    def event_noc_loads(self, packets, rows_padded, flits, idx=None):
        """Event-mode twin of ``noc_loads``: one tick's (link_loads,
        flit_loads) from the active sources' rows, both in one kernel
        launch.  ``idx`` is an optional pre-compacted active-source buffer
        (sentinel P on unused lanes) that must cover every source with
        nonzero packets; None walks every source and skips the quiet
        ones, which is always exact.  ``flits`` (P,) float32 from
        ``packet_costs``.  A fleet's (w, P) packets give (w, n_links)
        loads, its 2w rows in one launch."""
        pk = packets.to(torch.float32)
        w = torch.stack([pk, pk * flits])
        both = event_link_loads(idx, w, rows_padded, n_links=self.n_links)
        return both[0], both[1]

    def link_loads(self, packets, inc) -> torch.Tensor:
        """packets: (..., n_sources) per-source counts; inc: (n_sources,
        n_links) float32.  Returns (..., n_links) loads."""
        return packets.to(torch.float32) @ inc

    def flit_loads(self, packets, inc, flits) -> torch.Tensor:
        """Per-link flit traffic: each source's packets weighted by its
        packet's flit count (``packet_costs``) before hitting the
        incidence tensor."""
        return (packets.to(torch.float32) * flits) @ inc

    def packet_flits(self, payload_bits) -> torch.Tensor:
        """Flits per packet given per-source payload bits (0 = header-only
        spike packet = 1 flit; graded = ceil(bits / 128) flits)."""
        pb = payload_bits
        return torch.where(pb > 0, -(-pb // self.spec.payload_bits), 1)

    def packet_costs(self, payload_bits) -> tuple:
        """(flits, bits) of each source's packet given its payload bits:
        flits per packet (``packet_flits``) as float32, and bits on the
        wire per link traversal, 64 b for a spike packet, ceil(bits/128)
        flits of 192 b for graded payloads — the per-source weights of the
        flit loads and of ``traffic_energy_j``."""
        flits = self.packet_flits(payload_bits)
        bits = torch.where(payload_bits > 0, flits * self.spec.flit_bits,
                           SPIKE_PACKET_BITS)
        return flits.to(torch.float32), bits

    def traffic_energy_j(self, packets, tree_links, bits):
        """Energy of one tick's multicast traffic, packet-class aware:
        packets (..., P), tree_links (P,) float32, bits (P,) per link
        traversal of each source's packet (``packet_costs``)."""
        traffic = packets.to(torch.float32) * tree_links * bits
        return traffic.sum(-1) * self.spec.pj_per_bit_hop * 1e-12

    def tier_masks(self) -> dict:
        """Named 0/1 masks over the link-id space, one per link tier; a
        single-chip NoC has one tier."""
        return {"onchip": np.ones(self.n_links, np.float32)}

    def link_capacity_packets(self, t_window_s: float,
                              packet_bits: int = SPIKE_PACKET_BITS) -> float:
        """Packets one link can carry in ``t_window_s`` at the NoC clock."""
        flits = -(-packet_bits // self.spec.payload_bits)
        cycles_per_packet = self.spec.hop_cycles * flits
        return t_window_s * self.spec.freq_hz / cycles_per_packet

    def hop_latency_s(self, n_hops) -> float:
        return n_hops * self.spec.hop_cycles / self.spec.freq_hz


@dataclass
class MeshNoc(NocAccounting):
    """Link enumeration + incidence construction of a W x H QPE mesh; the
    per-tick accounting is ``NocAccounting``'s."""
    mesh: MeshSpec
    spec: NocSpec = field(default_factory=NocSpec)

    def __post_init__(self):
        links = []
        for y in range(self.mesh.height):
            for x in range(self.mesh.width):
                if x + 1 < self.mesh.width:
                    links.append(((x, y), (x + 1, y)))
                    links.append(((x + 1, y), (x, y)))
                if y + 1 < self.mesh.height:
                    links.append(((x, y), (x, y + 1)))
                    links.append(((x, y + 1), (x, y)))
        self.links = links
        # arithmetic link-id tables, keyed by the link's lower endpoint
        W, H = self.mesh.width, self.mesh.height
        self._id_e = np.full((W, H), -1, np.int32)   # (x,y) -> (x+1,y)
        self._id_w = np.full((W, H), -1, np.int32)   # (x+1,y) -> (x,y)
        self._id_n = np.full((W, H), -1, np.int32)   # (x,y) -> (x,y+1)
        self._id_s = np.full((W, H), -1, np.int32)   # (x,y+1) -> (x,y)
        for i, ((x0, y0), (x1, y1)) in enumerate(links):
            if x1 == x0 + 1:
                self._id_e[x0, y0] = i
            elif x1 == x0 - 1:
                self._id_w[x1, y1] = i
            elif y1 == y0 + 1:
                self._id_n[x0, y0] = i
            else:
                self._id_s[x0, y1] = i

    @property
    def n_links(self) -> int:
        return len(self.links)

    def tree_link_ids(self, src, dst_xy: np.ndarray,
                      orientation: str = "xy") -> np.ndarray:
        """Distinct link ids of the dimension-ordered multicast tree
        src -> dst coords: one trunk through the source along the
        first-routed dimension plus one perpendicular run per destination
        lane.  ``orientation`` "xy" routes X first, "yx" Y first: the
        same arithmetic over the transposed link-id tables."""
        d = np.asarray(dst_xy, np.int64).reshape(-1, 2)
        if not d.size:
            return np.empty(0, np.int32)
        if orientation == "yx":
            # transposed space: u = y, v = x; +u links are north, +v east
            return self._oriented_tree_ids(
                (int(src[1]), int(src[0])), d[:, ::-1],
                self._id_n.T, self._id_s.T, self._id_e.T, self._id_w.T,
                self.mesh.height)
        if orientation != "xy":
            raise ValueError(f"unknown orientation {orientation!r}; "
                             f"expected one of {ORIENTATIONS}")
        return self._oriented_tree_ids(
            (int(src[0]), int(src[1])), d,
            self._id_e, self._id_w, self._id_n, self._id_s,
            self.mesh.width)

    @staticmethod
    def _oriented_tree_ids(src, d, id_pos, id_neg, id_up, id_dn,
                           width) -> np.ndarray:
        """Trunk + branch runs in (u, v) coordinates, u the trunk
        dimension: ``id_pos``/``id_neg`` the +u/-u link tables,
        ``id_up``/``id_dn`` the +v/-v tables, ``width`` the u-extent."""
        su, sv = src
        du, dv = d[:, 0], d[:, 1]
        parts = []
        umax, umin = int(du.max()), int(du.min())
        if umax > su:
            parts.append(id_pos[su:umax, sv])
        if umin < su:
            parts.append(id_neg[umin:su, sv])
        up = dv > sv
        if up.any():
            top = np.full(width, sv, np.int64)
            np.maximum.at(top, du[up], dv[up])
            cols = np.flatnonzero(top > sv)
            lens = top[cols] - sv
            vs = _concat_ranges(np.full(cols.size, sv, np.int64), lens)
            parts.append(id_up[np.repeat(cols, lens), vs])
        dn = dv < sv
        if dn.any():
            bot = np.full(width, sv, np.int64)
            np.minimum.at(bot, du[dn], dv[dn])
            cols = np.flatnonzero(bot < sv)
            lens = sv - bot[cols]
            vs = _concat_ranges(bot[cols], lens)
            parts.append(id_dn[np.repeat(cols, lens), vs])
        if not parts:
            return np.empty(0, np.int32)
        return np.concatenate(parts).astype(np.int32)

    def sparse_incidence(self, src_coords, dst_coord_lists,
                         orientations=None) -> SparseIncidence:
        """CSR incidence + per-source tree hop depths in one pass;
        ``orientations`` optionally gives each source's tree orientation
        ("xy"/"yx"), None keeps every tree X-first."""
        src = np.asarray(src_coords, np.int64).reshape(-1, 2)
        rows = []
        hops = np.zeros(len(src), np.int32)
        for i, (s, d) in enumerate(zip(src, dst_coord_lists)):
            d = np.asarray(d, np.int64).reshape(-1, 2)
            o = orientations[i] if orientations is not None else "xy"
            rows.append(self.tree_link_ids(s, d, orientation=o))
            if d.size:
                hops[i] = int(np.abs(d - s).sum(axis=1).max())
        return SparseIncidence.from_rows(rows, self.n_links, hops)
