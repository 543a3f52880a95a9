"""Board-level multi-chip simulator (Mayr et al., arXiv:1911.02385), on
one CUDA device.

The second tier of the system: a ``BoardSpec`` grid of SpiNNaker2 chips
joined by chip-to-chip links, a partitioner that splits one ``NetGraph``
across chip boundaries under per-chip capacity, and hierarchical routing
that stitches on-chip X/Y multicast trees to chip-to-chip hops into ONE
board-wide CSR ``SparseIncidence`` — so the unchanged ``ChipSim`` engine
runs a whole board:

    from repro_torch.board import BoardSpec, compile_board
    from repro_torch.chip import ChipSim, chip_power_table
    from repro_torch.chip.workloads import hybrid_farm_board_graph

    board = BoardSpec.parse("4x12", chip="4x2")      # 48 chips, 1536 PEs
    graph = hybrid_farm_board_graph(board)
    sim   = ChipSim(compile_board(graph, board))
    recs  = sim.run(64)          # + load_xchip / flits_xchip / e_noc_xchip
    table = chip_power_table(sim, recs)              # incl. noc["xchip"]

A 1x1 board is bit-identical to the single-chip ``compile`` + ``ChipSim``
path: the board layer adds tiers, not drift.
"""
from repro_torch.board.partition import Partition, partition
from repro_torch.board.route import BoardProgram, chip_tree, compile_board
from repro_torch.board.spec import BoardNoc, BoardSpec, xlink_spec

__all__ = ["BoardSpec", "BoardNoc", "xlink_spec", "Partition", "partition",
           "BoardProgram", "chip_tree", "compile_board"]
