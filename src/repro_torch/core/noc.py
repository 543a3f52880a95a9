"""NoC constants (paper Sec. III-A): DNoC flit and payload widths, hop
latency and clock, and the per-bit-hop energy that prices spike traffic
in ``chip/mesh_noc.py``.
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
