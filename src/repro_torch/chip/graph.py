"""Declarative workload graphs for the chip-level simulator.

A workload is a ``NetGraph`` of ``Population`` nodes (neuron populations
and anything else with an SRAM footprint and per-tick step semantics)
joined by typed ``Projection`` edges that carry binary spike events
(header-only DNoC packets) or graded payloads (multi-flit packets).

``repro_torch.chip.compile.compile(graph, mesh)`` lowers a graph to a
``ChipProgram``; ``repro_torch.chip.chip.ChipSim`` runs it tick by tick.
The per-tick behaviour is the graph's ``TickSemantics``:

    init_state(program, device)                      -> state dict
    make_tick(program, dvfs, em, seed, noise, device) -> tick(state, t)

where ``tick`` returns ``(state, rec)`` and ``rec`` holds, per logical PE,
``packets`` (P,), ``pl`` (P,) and the Eq. (1) energy split under DVFS and
only-PL3 (``e_dvfs_*``, ``e_pl3_*``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.configs import paper
from repro_torch.core.energy import _pl_tables

SPIKE = "spike"      # binary events: header-only 64 b DNoC packet
GRADED = "graded"    # graded payload: header + ceil(bits/128) 192 b flits


@dataclass(frozen=True)
class Population:
    """One logical node of a workload graph: ``n`` units on ``n_tiles``
    PEs of ``sram_bytes`` state each; ``align_qpe`` starts it on a fresh
    QPE so traffic into it crosses real mesh links."""
    name: str
    n: int
    sram_bytes: int
    n_tiles: int = 1
    align_qpe: bool = False
    meta: dict = field(default_factory=dict)


@dataclass(frozen=True)
class Projection:
    """Typed edge: every PE of ``src`` multicasts to every PE of ``dst``.

    SPIKE packets are header-only (64 b); GRADED packets carry
    ``bits_per_packet`` payload bits, priced as ceil(bits / 128) flits of
    192 bits per link traversal (paper Sec. III-A).  ``plasticity``
    attaches a learning rule (``learn.STDP`` on a SPIKE projection,
    ``learn.PES`` on a GRADED one); ``compile`` lowers it to a learn slot.
    """
    src: str
    dst: str
    payload: str = SPIKE
    bits_per_packet: int = 0
    delay_ticks: int = 1
    plasticity: object = None

    def __post_init__(self):
        if self.payload not in (SPIKE, GRADED):
            raise ValueError(f"unknown payload class {self.payload!r}")
        if self.payload == GRADED and self.bits_per_packet <= 0:
            raise ValueError(
                f"graded projection {self.src}->{self.dst} needs "
                f"bits_per_packet > 0")
        if self.payload == SPIKE and self.bits_per_packet:
            raise ValueError(
                f"spike projection {self.src}->{self.dst} must not carry "
                f"payload bits (got {self.bits_per_packet})")


@runtime_checkable
class TickSemantics(Protocol):
    """Per-tick behaviour of a compiled graph (see module docstring)."""

    def init_state(self, program, device): ...

    def make_tick(self, program, *, dvfs, em, seed, noise, device): ...


@dataclass
class NetGraph:
    """Ordered populations + typed projections + tick semantics."""
    populations: list
    projections: list
    semantics: Optional[TickSemantics] = None
    name: str = "net"

    def __post_init__(self):
        known, dup = set(), set()
        for p in self.populations:
            (dup if p.name in known else known).add(p.name)
        if dup:
            raise ValueError(f"duplicate population names: {sorted(dup)}")
        for pr in self.projections:
            for end in (pr.src, pr.dst):
                if end not in known:
                    raise ValueError(
                        f"projection {pr.src}->{pr.dst} references unknown "
                        f"population {end!r}; have {sorted(known)}")

    @property
    def n_tiles_total(self) -> int:
        return sum(p.n_tiles for p in self.populations)

    def population(self, name: str) -> Population:
        for p in self.populations:
            if p.name == name:
                return p
        raise KeyError(name)


# ---------------------------------------------------------------------------
# Shared accounting helpers for semantics implementations
# ---------------------------------------------------------------------------

def busy_window_energy(pl, busy_cycles, *, pls=paper.PERF_LEVELS,
                       t_sys_s: float = 1e-3, dvfs: bool = True):
    """Eq. (1) baseline term for a datapath busy ``busy_cycles`` this tick.

    The generalization of ``PEEnergyModel.tick_energy``'s baseline to
    non-SNN workloads: busy time is the cycle count at the selected PL's
    clock, the idle remainder runs at PL1 (dvfs=True) or stays at the
    selected PL (dvfs=False, the "only PL3" comparison mode).
    """
    tab = _pl_tables(tuple(pls), pl.device)
    p_bl = tab["p_bl"]
    if not dvfs:
        return p_bl[pl] * t_sys_s
    t_sp = torch.clamp(busy_cycles / tab["freq"][pl], max=t_sys_s)
    return p_bl[pl] * t_sp + p_bl[0] * (t_sys_s - t_sp)


def mac_dynamic_energy_j(macs, *, tops_per_w: float | None = None):
    """Dynamic energy of ``macs`` MAC-array ops (2 ops each) this tick.
    The division is a multiply by the float32 reciprocal, as the
    reference's jitted tick computes it (XLA rewrites division by a
    constant)."""
    tops_per_w = tops_per_w or paper.MAC_TOPS_PER_W[(paper.MEP_VDD,
                                                     paper.MEP_FREQ)]
    return 2.0 * macs * float(np.float32(1) / np.float32(tops_per_w * 1e12))
