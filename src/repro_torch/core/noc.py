"""NoC model (paper Sec. III-A): DNoC flit and payload widths, hop
latency and clock, and the per-bit-hop energy that prices spike traffic
in ``chip/mesh_noc.py``; dimension-ordered (X/Y-first) routes and
multicast trees over a 2D mesh of QPEs or chips, and per-packet costs.
Compile-time numpy and Python, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs import paper


@dataclass(frozen=True)
class NocSpec:
    flit_bits: int = paper.DNOC_FLIT_BITS
    hop_cycles: int = paper.NOC_HOP_CYCLES
    freq_hz: float = paper.NOC_FREQ_HZ
    payload_bits: int = paper.NOC_PAYLOAD_BITS_MAX
    pj_per_bit_hop: float = 0.08          # planning constant, 22FDSOI-class


def xy_route(src: tuple, dst: tuple):
    """X-first then Y. Returns list of hops ((x,y) -> (x,y))."""
    (x0, y0), (x1, y1) = src, dst
    path = []
    x, y = x0, y0
    while x != x1:
        nx = x + (1 if x1 > x else -1)
        path.append(((x, y), (nx, y)))
        x = nx
    while y != y1:
        ny = y + (1 if y1 > y else -1)
        path.append(((x, y), (x, ny)))
        y = ny
    return path


def hops(src: tuple, dst: tuple) -> int:
    return abs(src[0] - dst[0]) + abs(src[1] - dst[1])


# Dimension-ordered routing comes in two legal orientations: X-then-Y
# (the classic default) and its Y-then-X mirror.  Which one a source uses
# is a free routing parameter — both deliver every destination — and the
# profile-guided optimizer (repro.routeopt) picks per source whichever
# spreads measured congestion better.
ORIENTATIONS = ("xy", "yx")


def oriented_route(src: tuple, dst: tuple, orientation: str = "xy"):
    """``xy_route`` with the trunk dimension as a parameter: "xy" routes
    X first (the historical fixed choice), "yx" routes Y first.  Returns
    the same hop-pair list format."""
    if orientation == "xy":
        return xy_route(src, dst)
    if orientation != "yx":
        raise ValueError(f"unknown orientation {orientation!r}; "
                         f"expected one of {ORIENTATIONS}")
    swapped = xy_route((src[1], src[0]), (dst[1], dst[0]))
    return [((a[1], a[0]), (b[1], b[0])) for a, b in swapped]


def build_tree(src: tuple, dsts, orientation: str = "xy"):
    """Directed edge list of the dimension-ordered multicast tree
    ``src -> dsts`` — the ONE shared tree builder both the on-chip NoC
    (``MeshNoc.tree_link_ids`` validates its arithmetic form against it)
    and the board stitcher (``repro.board.route.chip_tree`` runs it at
    chip granularity) parameterize by orientation, instead of each
    hard-coding X-first.

    The union of dimension-ordered routes is a tree (the router
    duplicates at branch points, never rejoins): shared prefixes are
    deduplicated, edges keep first-seen order so every edge's tail is
    already reachable when it appears.
    """
    seen: set = set()
    edges = []
    s = (int(src[0]), int(src[1]))
    for d in dsts:
        d = (int(d[0]), int(d[1]))
        if d == s:
            continue
        for e in oriented_route(s, d, orientation):
            if e not in seen:
                seen.add(e)
                edges.append(e)
    return edges


def multicast_links(src: tuple, dsts) -> int:
    """Number of distinct links traversed by an X/Y multicast tree — the
    router duplicates packets at branch points (Sec. III-B), so shared
    prefixes are paid once."""
    links = set()
    for d in dsts:
        links.update(xy_route(src, d))
    return len(links)


@dataclass(frozen=True)
class NocModel:
    spec: NocSpec = NocSpec()

    def packet_latency_s(self, src, dst) -> float:
        return hops(src, dst) * self.spec.hop_cycles / self.spec.freq_hz

    def spike_energy_j(self, src, dsts) -> float:
        """One multicast spike packet (header-only, 64b effective)."""
        nlinks = multicast_links(src, dsts)
        return nlinks * 64 * self.spec.pj_per_bit_hop * 1e-12

    def payload_energy_j(self, src, dsts, payload_bits) -> float:
        nflits = -(-payload_bits // self.spec.payload_bits)
        nlinks = multicast_links(src, dsts)
        return nlinks * nflits * self.spec.flit_bits \
            * self.spec.pj_per_bit_hop * 1e-12

    def collective_link_bytes(self, kind: str, nbytes: int, n: int) -> float:
        """Per-device link bytes of a ring collective over n devices, a
        first-principles NoC count."""
        if n <= 1:
            return 0.0
        if kind == "all-gather":
            return nbytes * (n - 1) / n
        if kind == "reduce-scatter":
            return nbytes * (n - 1) / n
        if kind == "all-reduce":
            return 2.0 * nbytes * (n - 1) / n
        if kind == "all-to-all":
            return nbytes * (n - 1) / n
        if kind == "collective-permute":
            return float(nbytes)
        raise ValueError(kind)
