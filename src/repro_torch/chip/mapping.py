"""Snake-order placement of workloads onto the PE mesh.

Population tiles land on consecutive placement slots in boustrophedon
order over the QPE grid, so ring neighbours stay mesh neighbours.
"""
from __future__ import annotations

import numpy as np

from repro_torch.chip.mesh_noc import MeshSpec
from repro_torch.configs import paper


def snake_order(mesh: MeshSpec) -> list[int]:
    """QPE indices in boustrophedon order: adjacent in the order =>
    adjacent on the mesh."""
    order = []
    for y in range(mesh.height):
        xs = range(mesh.width) if y % 2 == 0 else range(mesh.width - 1, -1, -1)
        order.extend(y * mesh.width + x for x in xs)
    return order


def snake_coords(mesh: MeshSpec, slots) -> np.ndarray:
    """(len(slots), 2) QPE coords of placement slots in snake order."""
    qpe_order = snake_order(mesh)
    return np.array([mesh.qpe_coord(qpe_order[s // mesh.pes_per_qpe])
                     for s in slots], np.int32).reshape(-1, 2)


def assign_slots(populations, pes_per_qpe: int) -> tuple:
    """Map population tiles to consecutive placement slots.

    Returns (slots_per_pop: dict name -> (start, stop), total_slots).
    ``align_qpe`` populations start on a QPE boundary and reserve whole
    QPEs."""
    slots = {}
    cur = 0
    for pop in populations:
        if pop.align_qpe and cur % pes_per_qpe:
            cur += pes_per_qpe - cur % pes_per_qpe
        slots[pop.name] = (cur, cur + pop.n_tiles)
        cur += pop.n_tiles
        if pop.align_qpe and cur % pes_per_qpe:
            cur += pes_per_qpe - cur % pes_per_qpe
    return slots, cur


def synfire_sram_bytes(sp: paper.SynfireParams = paper.SYNFIRE) -> int:
    """Per-PE synfire state: sparse synapse words (the hardware stores
    synapse lists, not the dense debug matrices), neuron state, FIFOs."""
    syn = sp.synapses_per_core * 4                      # word per synapse
    neuron = sp.neurons_per_core * 3 * 4                # v, ref, params
    fifo = (int(sp.delay_exc_ms) * sp.n_exc
            + int(sp.delay_inh_ms) * sp.n_inh) // 8 + 1024
    return syn + neuron + fifo
