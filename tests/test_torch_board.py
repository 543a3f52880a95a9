"""The port's multi-chip boards (``repro_torch.board``) against the
reference's ``repro.board``, on the CPU.

A 2x2 board of 2x2-QPE chips (64 PEs), and once with two border ports an
edge: the board's link space (``BoardNoc``: link ids, ``xlink_mask``,
endpoints), the partition (chip assignment, slots, ``cut_flits``), the
stitched board CSR and per-source tier splits, and the records of the
synfire, hybrid-farm and DNN board graphs through ``compile_board`` +
``ChipSim.run``, dense and event mode: integer records bitwise, float
records of integer counts bitwise, energies at rtol 1e-6 and the farm's
``hidden_out`` at rtol 1e-5 (float32 sums in another order), and the
``noc["xchip"]`` section of ``chip_power_table``.  A 1x1 board is
bitwise the single chip; plastic graphs and mismatched partitions are
refused as the reference refuses them.
"""
import numpy as np
import pytest
import torch

from repro.board import BoardNoc as JBoardNoc
from repro.board import BoardSpec as JBoardSpec
from repro.board import compile_board as j_compile_board
from repro.board import partition as j_partition
from repro.board.route import chip_tree as j_chip_tree
from repro.chip.chip import ChipSim as JChipSim
from repro.chip.chip import chip_power_table as j_chip_power_table
from repro.chip.mesh_noc import MeshSpec as JMeshSpec
from repro.chip.workloads import dnn_board_graph as j_dnn_board_graph
from repro.chip.workloads import \
    hybrid_farm_board_graph as j_hybrid_farm_board_graph
from repro.chip.workloads import synfire_board_graph as j_synfire_board_graph
from repro.routeopt import RouteConfig as JRouteConfig

from repro_torch.board import (BoardNoc, BoardSpec, chip_tree, compile_board,
                               partition)
from repro_torch.chip import ChipSim, chip_power_table, compile
from repro_torch.chip.graph import NetGraph, Population, Projection
from repro_torch.chip.mesh_noc import MeshSpec
from repro_torch.chip.workloads import (board_workload, dnn_board_graph,
                                        hybrid_farm_board_graph,
                                        hybrid_graph, synfire_board_graph,
                                        synfire_graph)
from repro_torch.routeopt import RouteConfig

ENERGY_RTOL, FLOAT_RTOL, FLOAT_ATOL = 1e-6, 1e-5, 1e-6
CLOSE = ("hidden_out",)


def boards(ports=1, chips=(2, 2), chip=(2, 2)):
    return (BoardSpec(*chips, chip=MeshSpec(*chip), ports_per_edge=ports),
            JBoardSpec(*chips, chip=JMeshSpec(*chip), ports_per_edge=ports))


def graphs(kind, board, jboard):
    """The same board graph in both packages (the port's on the CPU)."""
    if kind == "synfire":
        return (synfire_board_graph(board, noise_model="shot", device="cpu"),
                j_synfire_board_graph(jboard, noise_model="shot"))
    if kind == "farm":
        kw = dict(n_neurons=16, hidden=8, n_ticks=64)
        return (hybrid_farm_board_graph(board, device="cpu", **kw),
                j_hybrid_farm_board_graph(jboard, **kw))
    return dnn_board_graph(board), j_dnn_board_graph(jboard)


def assert_records(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].cpu().numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.startswith("e_"):
            np.testing.assert_allclose(g, w, rtol=ENERGY_RTOL, atol=0,
                                       err_msg=k)
        elif k in CLOSE:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL,
                                       atol=FLOAT_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("ports", [1, 2])
def test_board_noc_link_space_matches_the_reference(ports):
    board, jboard = boards(ports, chips=(3, 2), chip=(3, 2))
    noc, jnoc = BoardNoc(board), JBoardNoc(jboard)
    assert (noc.n_links, noc.n_onchip_links, noc.n_xchip_links) == \
        (jnoc.n_links, jnoc.n_onchip_links, jnoc.n_xchip_links)
    assert noc.xlinks == jnoc.xlinks and noc.xlink_index == jnoc.xlink_index
    np.testing.assert_array_equal(noc.xlink_mask, jnoc.xlink_mask)
    for tier, m in jnoc.tier_masks().items():
        np.testing.assert_array_equal(noc.tier_masks()[tier], m)
    for lid in range(noc.n_links):
        assert noc.link_endpoints(lid) == jnoc.link_endpoints(lid)
    for d in ("E", "W", "N", "S"):
        assert board.ports(d) == jboard.ports(d)
    assert noc.path_latency_s(3, 2) == jnoc.path_latency_s(3, 2)
    with pytest.raises(ValueError, match="ports_per_edge"):
        BoardSpec(2, 2, chip=MeshSpec(2, 2), ports_per_edge=3)
    assert BoardSpec.parse("4x12", chip="4x2") == BoardSpec(
        4, 12, chip=MeshSpec(4, 2))


def test_chip_tree_matches_the_reference():
    board, jboard = BoardSpec(4, 3), JBoardSpec(4, 3)
    for o in ("xy", "yx"):
        assert chip_tree(board, 5, [0, 3, 7, 11], o) == \
            j_chip_tree(jboard, 5, [0, 3, 7, 11], o)


@pytest.mark.parametrize("kind", ["synfire", "farm", "dnn"])
@pytest.mark.parametrize("refine", [True, False])
def test_partition_matches_the_reference(kind, refine):
    board, jboard = boards()
    g, jg = graphs(kind, board, jboard)
    part, jpart = partition(g, board, refine), j_partition(jg, jboard, refine)
    assert part.chip_of == jpart.chip_of
    assert part.slots_used == jpart.slots_used
    assert [[p.name for p in c] for c in part.chip_pops] == \
        [[p.name for p in c] for c in jpart.chip_pops]
    assert part.cut_flits == jpart.cut_flits
    np.testing.assert_array_equal(part.chips_of_graph(),
                                  jpart.chips_of_graph())


@pytest.mark.parametrize("kind,ports", [("synfire", 1), ("farm", 1),
                                        ("dnn", 1), ("farm", 2)])
def test_board_program_matches_the_reference(kind, ports):
    board, jboard = boards(ports)
    g, jg = graphs(kind, board, jboard)
    route = jroute = None
    if ports == 2:
        orient = {f"nef{k}": "yx" for k in range(0, 32, 3)}
        ports_of = {("nef1", 0, "E"): 1, ("nef2", 0, "N"): 1}
        route = RouteConfig(orient, dict(orient), ports_of)
        jroute = JRouteConfig(orient, dict(orient), ports_of)
    prog = compile_board(g, board, route=route)
    jprog = j_compile_board(jg, jboard, route=jroute)
    for k in ("coords", "coords_local", "chip_of_pe", "payload_bits",
              "sram_bytes", "tree_links_x", "path_hops", "energy_tree_links",
              "tree_hops_x"):
        np.testing.assert_array_equal(getattr(prog, k), getattr(jprog, k),
                                      err_msg=k)
    np.testing.assert_array_equal(prog.table.masks, jprog.table.masks)
    for k in ("link_ids", "source_ptr", "tree_hops"):
        np.testing.assert_array_equal(getattr(prog.sinc, k),
                                      getattr(jprog.sinc, k), err_msg=k)
    assert prog.pe_slices == jprog.pe_slices
    assert prog.worst_path_latency_s == jprog.worst_path_latency_s
    assert prog.worst_tree_hops == jprog.worst_tree_hops
    assert prog.tree_links_x.sum() > 0


@pytest.fixture(scope="module")
def board_runs():
    """Each board graph through both packages, dense and event mode."""
    board, jboard = boards()
    runs = {}
    for kind, T in (("synfire", 200), ("farm", 40), ("dnn", 60)):
        g, jg = graphs(kind, board, jboard)
        prog, jprog = compile_board(g, board), j_compile_board(jg, jboard)
        sim = ChipSim(prog, device="cpu")
        jsim = JChipSim(jprog, event_impl="gather")
        for mode, kw in (("dense", dict(noc_mode="dense", exec_mode="dense")),
                         ("event", dict(noc_mode="sparse",
                                        exec_mode="event"))):
            runs[kind, mode] = (sim, sim.run(T, **kw), jsim, jsim.run(T, **kw))
        runs[kind, "sparse"] = sim.run(T, noc_mode="sparse",
                                       exec_mode="dense")
    return runs


@pytest.mark.parametrize("kind", ["synfire", "farm", "dnn"])
@pytest.mark.parametrize("mode", ["dense", "event"])
def test_board_records_match_the_reference(board_runs, kind, mode):
    sim, got, jsim, want = board_runs[kind, mode]
    assert "flits_xchip" in got and float(got["flits_xchip"].sum()) > 0
    assert_records(got, want)
    # the tier split: xchip records are the masked per-link sums
    xmask = torch.as_tensor(sim.noc.xlink_mask) > 0
    assert torch.equal(got["flits_xchip"], got["link_flits"][:, xmask].sum(1))
    assert torch.equal(got["load_xchip"], got["link_load"][:, xmask].sum(1))
    # event mode, and dense mode on the sparse plan (noc_link_loads),
    # give the dense records
    dense = board_runs[kind, "dense"][1]
    other = got if mode == "event" else board_runs[kind, "sparse"]
    assert set(other) == set(dense)
    for k in dense:
        assert torch.equal(other[k], dense[k]), k


@pytest.mark.parametrize("kind", ["synfire", "farm"])
def test_power_table_xchip_section_matches_the_reference(board_runs, kind):
    sim, got, jsim, want = board_runs[kind, "dense"]
    tab, jtab = chip_power_table(sim, got), j_chip_power_table(jsim, want)
    assert tab["board"] == jtab["board"] == (2, 2)
    x, jx = tab["noc"]["xchip"], jtab["noc"]["xchip"]
    assert set(x) == set(jx)
    for k in jx:
        assert x[k] == pytest.approx(jx[k], rel=ENERGY_RTOL, abs=0), k
    for k in ("peak_utilization", "worst_hop_latency_s", "peak_link_flits",
              "n_links"):
        assert tab["noc"][k] == pytest.approx(jtab["noc"][k],
                                              rel=ENERGY_RTOL), k
    assert x["energy_frac"] > x["flits_frac"] > 0


def test_board_workload_reports_the_tier_split():
    board, _ = boards()
    rep = board_workload(hybrid_farm_board_graph(
        board, n_neurons=16, hidden=8, n_ticks=64, device="cpu"), board,
        n_ticks=30, device="cpu")
    assert rep["n_chips_used"] == 4 and 0 < rep["xchip_frac"] < 1
    assert rep["energy_xchip_j"] > 0 and rep["cut_flits"] > 0
    assert rep["worst_path_latency_s"] == \
        rep["program"].worst_path_latency_s


@pytest.mark.parametrize("make", [
    lambda: synfire_graph(8, noise_model="shot", device="cpu"),
    lambda: hybrid_graph(64, 16, n_ticks=60, device="cpu"),
])
def test_board_1x1_bitwise_identical_to_single_chip(make):
    pa = compile(make())
    pb = compile_board(make(), BoardSpec(1, 1, chip=pa.mesh))
    np.testing.assert_array_equal(pa.coords, pb.coords)
    np.testing.assert_array_equal(pa.table.masks, pb.table.masks)
    for k in ("link_ids", "source_ptr", "tree_hops"):
        np.testing.assert_array_equal(getattr(pa.sinc, k),
                                      getattr(pb.sinc, k))
    assert pb.noc.n_xchip_links == 0 and (pb.tree_links_x == 0).all()
    for kw in (dict(), dict(noc_mode="sparse", exec_mode="event")):
        ra = ChipSim(pa, device="cpu").run(60, **kw)
        rb = ChipSim(pb, device="cpu").run(60, **kw)
        assert set(ra) == set(rb)
        for k in ra:
            assert torch.equal(ra[k], rb[k]), k


def test_board_compile_refuses_plastic_graphs_and_foreign_partitions():
    graph = synfire_graph(8, device="cpu")
    part = partition(graph, BoardSpec(2, 1, chip=MeshSpec(1, 1)))
    assert sorted(part.chip_of.values()) == [0] * 4 + [1] * 4
    with pytest.raises(ValueError, match="partition was built for"):
        compile_board(graph, BoardSpec(2, 2, chip=MeshSpec(2, 2)),
                      part=part)
    with pytest.raises(ValueError, match="does not fit the"):
        partition(synfire_graph(9, device="cpu"),
                  BoardSpec(2, 1, chip=MeshSpec(1, 1)))
    fat = NetGraph([Population("fat", 1, 64, n_tiles=5)], [],
                   semantics=object())
    with pytest.raises(ValueError, match="one 1x1 QPE chip holds"):
        partition(fat, BoardSpec(2, 1, chip=MeshSpec(1, 1)))
    plastic = NetGraph([Population("a", 8, 64), Population("b", 8, 64)],
                       [Projection("a", "b", plasticity=object())],
                       semantics=object())
    with pytest.raises(ValueError, match="a->b: unknown plasticity rule"):
        compile_board(plastic, BoardSpec(1, 1))
    with pytest.raises(ValueError, match="orientation"):
        RouteConfig(tree_orient={"a": "zz"}).validate(BoardSpec(1, 1))
    with pytest.raises(ValueError, match="port"):
        RouteConfig(ports={("a", 0, "E"): 1}).validate(BoardSpec(1, 1))
