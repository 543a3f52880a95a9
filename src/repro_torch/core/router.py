"""SpiNNaker2 multicast packet router (paper Sec. III-B) on one device.

Routing is key-based: each spike carries a key (its source population
id); a ``RoutingTable`` maps keys to destination PEs.

* ``delivery_matrix`` — the dense (n_sources, n_pes) 0/1 matrix, on a
  device; delivery is a product with it.
* ``ring_exchange`` — the synfire topology (PE i -> PE i+1) as a roll
  over the PE axis.
* ``multicast_exchange`` — general key -> multi-PE delivery: every
  source's spikes broadcast to the PEs of its table mask.

The reference's multi-device forms of the two exchanges (a collective
over a mesh axis) have no single-GPU counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class RoutingTable:
    """keys[i] -> boolean destination mask over PEs."""
    masks: np.ndarray          # (n_keys, n_pes) bool

    @staticmethod
    def ring(n_pes: int) -> "RoutingTable":
        m = np.zeros((n_pes, n_pes), bool)
        m[np.arange(n_pes), (np.arange(n_pes) + 1) % n_pes] = True
        return RoutingTable(m)

    @staticmethod
    def self_loop(n_pes: int) -> "RoutingTable":
        return RoutingTable(np.eye(n_pes, dtype=bool))

    def delivery_matrix(self, device=None) -> torch.Tensor:
        """The masks as an int32 tensor on ``device`` (None: the CPU)."""
        return torch.as_tensor(self.masks.astype(np.int32), device=device)

    def fan_out(self) -> np.ndarray:
        return self.masks.sum(axis=1)


def ring_exchange(spikes: torch.Tensor) -> torch.Tensor:
    """spikes: (n_pes, ...) -> delivered to PE i+1 (synfire ring)."""
    return torch.roll(spikes, 1, 0)


def multicast_exchange(spikes: torch.Tensor,
                       table: RoutingTable) -> torch.Tensor:
    """spikes: (n_pes, n_keys_per_pe) counts emitted by each PE.

    Returns (n_pes, n_pes, n_keys_per_pe) arrival counts: arrivals[p, i,
    k] = spikes[i, k] * mask[i -> p], the reference's
    ``einsum("ik,ip->pik")`` as a broadcast product."""
    dm = table.delivery_matrix(spikes.device).to(spikes.dtype)
    return dm.t()[:, :, None] * spikes[None, :, :]
