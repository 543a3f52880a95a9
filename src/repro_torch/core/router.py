"""SpiNNaker2 multicast packet router (paper Sec. III-B) on one device.

Routing is key-based: each spike carries a key (its source population
id); a ``RoutingTable`` maps keys to destination PEs.  ``ring_exchange``
is the synfire topology (PE i -> PE i+1) as a roll over the PE axis; the
reference's multi-device form of it has no single-GPU counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class RoutingTable:
    """keys[i] -> boolean destination mask over PEs."""
    masks: np.ndarray          # (n_keys, n_pes) bool


def ring_exchange(spikes: torch.Tensor) -> torch.Tensor:
    """spikes: (n_pes, ...) -> delivered to PE i+1 (synfire ring)."""
    return torch.roll(spikes, 1, 0)
