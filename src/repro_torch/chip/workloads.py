"""The synfire ring as a graph on the chip API (paper Sec. VI-B).

``synfire_graph`` builds one population per PE with spike projections
around the ring; its semantics is the single-PE synfire tick
(``core.snn.make_synfire_tick``) batched over all PEs.  The DNN and
hybrid workloads of ``repro.chip.workloads`` are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.chip.chip import ChipSim, chip_power_table
from repro_torch.chip.compile import ChipProgram, compile as compile_graph
from repro_torch.chip.graph import NetGraph, Population, Projection
from repro_torch.chip.mapping import synfire_sram_bytes
from repro_torch.chip.mesh_noc import MeshSpec
from repro_torch.configs import paper
from repro_torch.core.dvfs import DVFSController
from repro_torch.core.snn import (build_synfire, make_synfire_tick,
                                  synfire_init_state)


@dataclass
class SynfireSemantics:
    """Per-tick step of the synfire ring: the single-chip tick function,
    run on the sim's device."""
    net: object                        # core.snn.SynfireNet

    def init_state(self, program: ChipProgram, device):
        return synfire_init_state(self.net, device)

    def make_tick(self, program: ChipProgram, *, dvfs, em, seed, noise,
                  device):
        return make_synfire_tick(self.net.to(device), dvfs=dvfs, em=em,
                                 seed=seed, noise=noise)

    def dvfs_controller(self):
        """The net's own FIFO thresholds (Table II l_th1/l_th2)."""
        sp = self.net.params
        return DVFSController(sp.l_th1, sp.l_th2)


def synfire_graph(n_pes: int = 8, seed: int = 0,
                  sp: paper.SynfireParams = paper.SYNFIRE, device=None,
                  **build_kw) -> NetGraph:
    """Synfire ring of any length as a graph, its net built on ``device``
    (the CUDA device by default): one population per PE, spike
    projections around the ring."""
    net = build_synfire(seed, n_pes=n_pes, sp=sp, device=device, **build_kw)
    sram = synfire_sram_bytes(net.params)
    pops = [Population(name=f"pe{i}", n=net.params.neurons_per_core,
                       sram_bytes=sram) for i in range(n_pes)]
    projs = [Projection(src=f"pe{i}", dst=f"pe{(i + 1) % n_pes}",
                        delay_ticks=int(net.params.delay_exc_ms))
             for i in range(n_pes)]
    return NetGraph(populations=pops, projections=projs,
                    semantics=SynfireSemantics(net), name=f"synfire{n_pes}")


def synfire_workload(n_pes: int = 8, mesh: MeshSpec | None = None,
                     n_ticks: int = 1200, seed: int = 0,
                     device=None) -> dict:
    """Build, compile, run and account a synfire ring on the mesh."""
    graph = synfire_graph(n_pes, seed=seed, device=device)
    sim = ChipSim(compile_graph(graph, mesh), device=device)
    recs = sim.run(n_ticks)
    return {"sim": sim, "recs": recs, "table": chip_power_table(sim, recs)}
