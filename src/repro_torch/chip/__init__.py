"""Chip-level mesh simulator on PyTorch: graph -> compile -> ChipSim.

    graph = workloads.synfire_graph(8)          # net built on the GPU
    prog  = compile(graph)                      # placement + routing + NoC
    sim   = ChipSim(prog)                       # device="cuda" by default
    recs  = sim.run(n_ticks=1200)               # (T, ...) records on device
    table = chip_power_table(sim, recs)         # Table III at chip scale
"""
from repro_torch.chip.mesh_noc import MeshNoc, MeshSpec, SparseIncidence
from repro_torch.chip.graph import NetGraph, Population, Projection
from repro_torch.chip.compile import ChipProgram, compile
from repro_torch.chip.chip import ChipSim, chip_power_table

__all__ = ["MeshNoc", "MeshSpec", "SparseIncidence", "NetGraph",
           "Population", "Projection", "ChipProgram", "compile", "ChipSim",
           "chip_power_table"]
