"""Eq. (1) of the paper with the measured Table I parameters.

``PEEnergyModel`` prices one tick of a PE: baseline power at the active
PL during the busy window t_sp, baseline power at PL1 for the idle
remainder, plus per-neuron-update and per-synaptic-event energies.

The arithmetic follows the reference's float32 promotion exactly: int32
cycle counts divided by float32 clock tables, Python constants rounded to
float32 where they meet a float32 tensor.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.configs import paper


@functools.lru_cache(maxsize=None)
def _pl_tables(pls: tuple, device: torch.device) -> dict:
    """Per-PL float32 tables on ``device``, built once per device."""
    def f32(vals):
        return torch.tensor(vals, dtype=torch.float32, device=device)
    return {"freq": f32([p.freq_hz for p in pls]),
            "p_bl": f32([p.p_baseline_w for p in pls]),
            "e_neur": f32([p.e_neuron_j for p in pls]),
            "e_syn": f32([p.e_synapse_j for p in pls])}


@dataclass(frozen=True)
class PEEnergyModel:
    pls: tuple = paper.PERF_LEVELS
    t_sys_s: float = 1e-3
    cycles_per_neuron: int = paper.CYCLES_PER_NEURON_UPDATE
    cycles_per_syn: int = paper.CYCLES_PER_SYN_EVENT
    cycles_overhead: int = paper.CYCLES_TICK_OVERHEAD

    def tables(self, device) -> dict:
        return _pl_tables(self.pls, torch.device(device))

    def t_sp(self, pl_idx, n_neur, n_syn_events):
        """Busy time within a tick at PL ``pl_idx`` (float32 seconds)."""
        tab = self.tables(pl_idx.device)
        cycles = (self.cycles_overhead
                  + self.cycles_per_neuron * n_neur
                  + self.cycles_per_syn * n_syn_events)
        return torch.clamp(cycles / tab["freq"][pl_idx], max=self.t_sys_s)

    def tick_energy(self, pl_idx, n_neur, n_syn_events, *, dvfs=True):
        """Eq. (1): dict of energy components [J] per PE.

        dvfs=False models "only PL3": the PE never returns to PL1 while
        idle, so baseline power is P_BL,3 for the whole tick.
        """
        tab = self.tables(pl_idx.device)
        p_bl = tab["p_bl"]
        tsp = self.t_sp(pl_idx, n_neur, n_syn_events)
        if dvfs:
            base = p_bl[pl_idx] * tsp + p_bl[0] * (self.t_sys_s - tsp)
        else:
            base = p_bl[pl_idx] * self.t_sys_s
        return {
            "baseline": base,
            "neuron": tab["e_neur"][pl_idx] * n_neur,
            "synapse": tab["e_syn"][pl_idx] * n_syn_events,
            "t_sp": tsp,
        }
