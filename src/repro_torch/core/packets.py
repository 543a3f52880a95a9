"""SpiNNaker2 packet formats + TCAM multicast routing (paper Fig. 4-6,
Sec. III-A/B).

DNoC packet (Fig. 4, 192-bit flit): 15-bit NoC header | 17-bit packet
header | 32-bit address | 0..128-bit payload.  SpiNNaker packets (Fig. 6)
ride inside: multicast (routed by a 32-bit source key against TCAM
key/mask entries), core-to-core (routed by destination address), and
nearest-neighbour (routed by port) — the three traffic classes the router
arbitrates round-robin.

The TCAM table mirrors the hardware: each entry is (key, mask, dest-port
bit-set); a packet matches entry i iff (pkt.key & mask_i) == key_i; the
FIRST match wins (priority order), unmatched multicast packets take the
default route (drop or monitor, per config).  ``route_batch`` evaluates a
whole spike batch vectorized — the dense-matmul delivery used by the SNN
engine (core/router.py) is provably equivalent for 1-hot tables (tests).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np


class PacketType(IntEnum):
    MULTICAST = 0
    CORE_TO_CORE = 1
    NEAREST_NEIGHBOUR = 2


_NOC_HDR_BITS = 15
_PKT_HDR_BITS = 17
_ADDR_BITS = 32
MAX_PAYLOAD_BITS = 128
FLIT_BITS = 192


@dataclass(frozen=True)
class Packet:
    ptype: PacketType
    key: int                   # 32-bit routing key / destination address
    payload: int = 0           # up to 128 bits
    payload_bits: int = 0      # 0 (header-only spike), 32 or 128
    emergency: bool = False    # header flag (Fig. 6 control byte)
    timestamp: int = 0         # 2-bit phase tag in hardware

    def __post_init__(self):
        assert 0 <= self.key < (1 << 32)
        assert self.payload_bits in (0, 32, 128)
        assert 0 <= self.payload < (1 << max(self.payload_bits, 1))


def pack(pkt: Packet) -> int:
    """Encode to a 192-bit flit integer (Fig. 4 layout)."""
    noc_hdr = (int(pkt.ptype) & 0x3) | ((pkt.payload_bits // 32) & 0x7) << 2
    pkt_hdr = (int(pkt.emergency) | (pkt.timestamp & 0x3) << 1)
    word = noc_hdr
    word |= pkt_hdr << _NOC_HDR_BITS
    word |= pkt.key << (_NOC_HDR_BITS + _PKT_HDR_BITS)
    word |= pkt.payload << (_NOC_HDR_BITS + _PKT_HDR_BITS + _ADDR_BITS)
    assert word < (1 << FLIT_BITS)
    return word


def unpack(word: int) -> Packet:
    noc_hdr = word & ((1 << _NOC_HDR_BITS) - 1)
    pkt_hdr = (word >> _NOC_HDR_BITS) & ((1 << _PKT_HDR_BITS) - 1)
    key = (word >> (_NOC_HDR_BITS + _PKT_HDR_BITS)) & 0xFFFFFFFF
    payload = word >> (_NOC_HDR_BITS + _PKT_HDR_BITS + _ADDR_BITS)
    pbits = ((noc_hdr >> 2) & 0x7) * 32
    return Packet(
        ptype=PacketType(noc_hdr & 0x3),
        key=key,
        payload=payload,
        payload_bits=pbits,
        emergency=bool(pkt_hdr & 1),
        timestamp=(pkt_hdr >> 1) & 0x3,
    )


@dataclass
class TcamTable:
    """Ternary CAM multicast table: first-match-wins key/mask entries."""
    keys: np.ndarray           # (E,) uint32
    masks: np.ndarray          # (E,) uint32
    dests: np.ndarray          # (E, n_ports) bool

    @staticmethod
    def empty(n_ports: int) -> "TcamTable":
        return TcamTable(np.zeros(0, np.uint32), np.zeros(0, np.uint32),
                         np.zeros((0, n_ports), bool))

    def add(self, key: int, mask: int, ports) -> "TcamTable":
        dests = np.zeros((1, self.dests.shape[1] or len(ports)), bool)
        if self.dests.shape[0] == 0 and self.dests.shape[1] == 0:
            dests = np.zeros((1, len(ports)), bool)
        dests[0, list(np.nonzero(ports)[0]) if isinstance(ports, np.ndarray)
              else list(ports)] = True
        return TcamTable(
            np.concatenate([self.keys, [np.uint32(key)]]),
            np.concatenate([self.masks, [np.uint32(mask)]]),
            np.concatenate([self.dests, dests]) if self.dests.size
            else dests)

    def route(self, key: int):
        """First matching entry's port set, or None (default route)."""
        m = (np.uint32(key) & self.masks) == self.keys
        idx = np.nonzero(m)[0]
        if len(idx) == 0:
            return None
        return self.dests[idx[0]]

    def route_batch(self, keys: np.ndarray) -> np.ndarray:
        """keys: (N,) -> (N, n_ports) bool; unmatched rows all-False."""
        m = (keys[:, None].astype(np.uint32) & self.masks[None, :]) \
            == self.keys[None, :]                     # (N, E)
        first = np.argmax(m, axis=1)
        any_hit = m.any(axis=1)
        out = self.dests[first]
        out[~any_hit] = False
        return out

    def self_test(self) -> bool:
        """TCAM BIST analogue (Sec. III-B): every entry reachable, masks
        well-formed (key bits outside the mask must be zero)."""
        if not np.all((self.keys & ~self.masks) == 0):
            return False
        for i in range(len(self.keys)):
            if self.route(int(self.keys[i])) is None:
                return False
        return True


def population_key(chip_x: int, chip_y: int, core: int, pop: int) -> int:
    """Conventional SpiNNaker key layout: x|y|core|population."""
    return (chip_x & 0xFF) << 24 | (chip_y & 0xFF) << 16 \
        | (core & 0xFF) << 8 | (pop & 0xFF)
