"""Activity-driven DVFS controller (paper Sec. VI-B, Table II).

Each 1 ms tick, the PE inspects the number of spikes waiting in its inbound
FIFO and selects a performance level BEFORE processing:

    n < l_th1          -> PL1 (0.5 V, 100 MHz)
    l_th1 <= n < l_th2 -> PL2 (0.5 V, 200 MHz)
    n >= l_th2         -> PL3 (0.6 V, 400 MHz)

After the busy window the PE drops back to PL1 and sleeps until the next
timer tick (modeled in ``PEEnergyModel.tick_energy``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs import paper


@dataclass(frozen=True)
class DVFSController:
    l_th1: int = paper.SYNFIRE.l_th1
    l_th2: int = paper.SYNFIRE.l_th2

    def select_pl(self, n_spikes: torch.Tensor) -> torch.Tensor:
        """int tensor -> int32 PL index (0-based: 0=PL1, 1=PL2, 2=PL3)."""
        return ((n_spikes >= self.l_th1).to(torch.int32)
                + (n_spikes >= self.l_th2).to(torch.int32))


@dataclass(frozen=True)
class QueueDVFS:
    """The serving tier's analogue: request-queue depth selects the
    execution level (the fleet's batch width), as spike-FIFO occupancy
    selects the PL.  ``thresholds`` are queue depths, as l_th1/l_th2;
    ``batch_levels`` the width at each level."""
    thresholds: tuple = (4, 16)
    batch_levels: tuple = (8, 32, 128)

    def select_level(self, queue_depth: int) -> int:
        lvl = 0
        for t in self.thresholds:
            if queue_depth >= t:
                lvl += 1
        return lvl

    def batch_size(self, queue_depth: int) -> int:
        return self.batch_levels[self.select_level(queue_depth)]
