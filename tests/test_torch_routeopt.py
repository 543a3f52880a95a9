"""The port's profile-guided routing (``repro_torch.routeopt``) and
``obs.report`` against the reference's, on the CPU.

Mirrors ``tests/test_routeopt.py`` (the zero-iteration golden, routing
invariance under both graph builders, the optimizer never worse and its
program legal, a zero budget, ``diff_benches`` in both directions) and
the two hypothesis properties of ``tests/test_routeopt_property.py`` as
parametrised seeds.  Every case also holds the port against the
reference: on the 2x2 farm board (``n_ticks=24``, ``max_iters=3``) the
port's ``optimize_routes`` runs the same number of iterations, converges
alike, picks the same routes and measures the same trajectory (integer
fields and ``cut_flits`` exactly; ``mean_*`` and ``touched_*`` at rtol
1e-6; ``compile_s`` and ``measure_s`` are wall clock and not compared),
and ``check_delivery`` gives the reference's signature.  Records of
routed programs are held bitwise against the fixed-route run (the
reference's ``assert_neuron_identical``).
"""
import numpy as np
import pytest
import torch

from repro.board import BoardSpec as JBoardSpec
from repro.board import compile_board as j_compile_board
from repro.chip.graph import GRADED as J_GRADED
from repro.chip.graph import SPIKE as J_SPIKE
from repro.chip.graph import NetGraph as JNetGraph
from repro.chip.graph import Population as JPopulation
from repro.chip.graph import Projection as JProjection
from repro.chip.mesh_noc import MeshSpec as JMeshSpec
from repro.chip.workloads import \
    hybrid_farm_board_graph as j_hybrid_farm_board_graph
from repro.chip.workloads import synfire_graph as j_synfire_graph
from repro.obs.report import diff_benches as j_diff_benches
from repro.routeopt import RouteConfig as JRouteConfig
from repro.routeopt import check_delivery as j_check_delivery
from repro.routeopt import optimize_routes as j_optimize_routes

from repro_torch.board import BoardSpec, compile_board
from repro_torch.board.spec import DIRS
from repro_torch.chip import ChipSim
from repro_torch.chip.graph import GRADED, SPIKE, NetGraph, Population, \
    Projection
from repro_torch.chip.mesh_noc import MeshSpec
from repro_torch.chip.workloads import hybrid_farm_board_graph, synfire_graph
from repro_torch.core.noc import ORIENTATIONS
from repro_torch.obs import diff_benches
from repro_torch.obs.report import main as report_main
from repro_torch.routeopt import (RouteConfig, TrafficProfile,
                                  check_delivery, measure_profile,
                                  optimize_routes)

MEAN_RTOL = 1e-6          # float32 means over the run's ticks
NOC_KEYS = {"link_load", "link_flits", "e_noc", "e_noc_xchip",
            "load_xchip", "flits_xchip"}


def _is_noc_key(k: str) -> bool:
    return k in NOC_KEYS or k.startswith("touched_links")


def assert_neuron_identical(ra: dict, rb: dict):
    """Every record but the NoC's, bitwise (routing prices links only)."""
    ka = {k for k in ra if not _is_noc_key(k) and k != "probes"}
    kb = {k for k in rb if not _is_noc_key(k) and k != "probes"}
    assert ka == kb
    for k in ka:
        assert torch.equal(ra[k], rb[k]), k


def boards(chips=(2, 2), chip=(4, 2), ports=1):
    return (BoardSpec(*chips, chip=MeshSpec(*chip), ports_per_edge=ports),
            JBoardSpec(*chips, chip=JMeshSpec(*chip), ports_per_edge=ports))


GRAPHS = {
    "synfire": (lambda b: synfire_graph(n_pes=b.n_pes, device="cpu"),
                lambda b: j_synfire_graph(n_pes=b.n_pes)),
    "farm": (lambda b: hybrid_farm_board_graph(b, device="cpu"),
             j_hybrid_farm_board_graph),
}


def routes(route):
    """The same routing choices in both packages."""
    kw = dict(tree_orient=dict(route.tree_orient),
              chip_orient=dict(route.chip_orient), ports=dict(route.ports))
    return RouteConfig(**kw), JRouteConfig(**kw)


def route_fields(route) -> tuple:
    return (dict(route.tree_orient), dict(route.chip_orient),
            dict(route.ports))


# -------------------------------------------------------------------------
# obs.report
# -------------------------------------------------------------------------

def _payload(**vals):
    return {"rows": [{"name": "r", "us_per_call": 1.0,
                      "values": dict(vals)}]}


@pytest.mark.parametrize("metric,direction,base,worse,better", [
    ("peak_xlink_flits", "lower", 100.0, 150.0, 60.0),
    ("improvement", "higher", 0.4, 0.1, 0.5),
])
def test_diff_benches_direction(metric, direction, base, worse, better):
    b = _payload(**{metric: base})
    for new, n_reg in ((worse, 1), (better, 0)):
        n = _payload(**{metric: new})
        d = diff_benches(b, n, metric=metric, threshold=0.2,
                         direction=direction)
        assert len(d["regressions"]) == n_reg
        assert d == j_diff_benches(b, n, metric=metric, threshold=0.2,
                                   direction=direction)
    with pytest.raises(ValueError):
        diff_benches(b, b, metric=metric, direction="up")


def test_report_cli_gates_on_a_regression(tmp_path, capsys):
    import json
    from repro_torch.obs.manifest import bench_payload
    rows = [{"name": "r", "us_per_call": 1.0, "values": {"tick_us": 2.0}}]
    base = tmp_path / "a.json"
    fresh = tmp_path / "b.json"
    base.write_text(json.dumps(bench_payload(rows, seed=1, device="cpu")))
    slower = [dict(rows[0], us_per_call=2.0)]
    fresh.write_text(json.dumps(bench_payload(slower, device="cpu")))
    assert report_main([str(base), str(base)]) == 0
    assert report_main([str(base), str(fresh)]) == 1
    assert report_main([str(base), str(fresh), "--warn-only"]) == 0
    assert report_main([str(base), str(fresh), "--metric",
                        "tick_us:lower:0.5"]) == 0
    out = capsys.readouterr().out
    assert "torch=" in out and "device=cpu" in out
    man = json.loads(base.read_text())["manifest"]
    assert man["torch_version"] == torch.__version__
    assert man["device"] == man["power_limit"] == "cpu"
    assert "jax_version" not in man and man["seed"] == 1


# -------------------------------------------------------------------------
# 0-iteration golden: optimize_routes(max_iters=0) is the compiler
# -------------------------------------------------------------------------

def test_zero_iter_golden_bitwise():
    board, jboard = boards()
    res = optimize_routes(hybrid_farm_board_graph(board, device="cpu"),
                          board, max_iters=0, device="cpu")
    base = compile_board(hybrid_farm_board_graph(board, device="cpu"), board)
    jbase = j_compile_board(j_hybrid_farm_board_graph(jboard), jboard)
    for want in (base, jbase):
        for a, b in ((res.program.coords, want.coords),
                     (res.program.table.masks, want.table.masks),
                     (res.program.sinc.link_ids, want.sinc.link_ids),
                     (res.program.sinc.source_ptr, want.sinc.source_ptr),
                     (res.program.sinc.tree_hops, want.sinc.tree_hops),
                     (res.program.tree_links_x, want.tree_links_x),
                     (res.program.path_hops, want.path_hops)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert res.trajectory == [] and res.iterations == 0
    assert res.baseline is None and res.improvement == 0.0
    ra = ChipSim(res.program, device="cpu").run(16)
    rb = ChipSim(base, device="cpu").run(16)
    assert set(ra) == set(rb)
    for k in ra:
        assert torch.equal(ra[k], rb[k]), k


# -------------------------------------------------------------------------
# Routing invariance under both graph builders
# -------------------------------------------------------------------------

def _variants(pops, k2_board):
    yield RouteConfig()                         # grown board, default route
    yield RouteConfig(tree_orient={p: "yx" for p in pops},
                      chip_orient={p: "yx" for p in pops})
    yield RouteConfig(
        tree_orient={p: ("yx" if i % 2 else "xy")
                     for i, p in enumerate(pops)},
        ports={(p, c, d): (i + c) % k2_board.ports_per_edge
               for i, p in enumerate(pops)
               for c in range(k2_board.n_chips) for d in DIRS})


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_routing_invariance_deterministic(kind):
    make, j_make = GRAPHS[kind]
    board, _ = boards()
    k2, jk2 = boards(ports=2)
    base = compile_board(make(board), board)
    sig0 = check_delivery(base)
    r0 = ChipSim(base, device="cpu").run(12, seed=5)
    pops = [p.name for p in make(board).populations]
    for route in _variants(pops, k2):
        prog = compile_board(make(k2), k2, route=route)
        sig = check_delivery(prog)
        assert sig == sig0
        jprog = j_compile_board(j_make(jk2), jk2, route=routes(route)[1])
        assert sig == j_check_delivery(jprog)
        np.testing.assert_array_equal(prog.sinc.link_ids,
                                      jprog.sinc.link_ids)
        assert_neuron_identical(ChipSim(prog, device="cpu").run(12, seed=5),
                                r0)


# -------------------------------------------------------------------------
# The optimizer against the reference's
# -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def opt_pair():
    board, jboard = boards()
    res = optimize_routes(hybrid_farm_board_graph(board, device="cpu"),
                          board, n_ticks=24, max_iters=3, device="cpu")
    jres = j_optimize_routes(j_hybrid_farm_board_graph(jboard), jboard,
                             n_ticks=24, max_iters=3)
    return res, jres


def test_optimizer_matches_the_reference(opt_pair):
    res, jres = opt_pair
    assert (res.iterations, res.converged) == (jres.iterations,
                                               jres.converged)
    assert route_fields(res.route) == route_fields(jres.route)
    assert res.part.chip_of == jres.part.chip_of
    assert len(res.trajectory) == len(jres.trajectory) >= 2
    for got, want in zip(res.trajectory, jres.trajectory):
        assert set(got) == set(want)
        for k, v in want.items():
            if k in ("compile_s", "measure_s"):
                continue
            if k.startswith(("mean_", "touched_")):
                np.testing.assert_allclose(got[k], v, rtol=MEAN_RTOL,
                                           err_msg=k)
            else:
                assert got[k] == v, k
    for prof, jprof in ((res.baseline, jres.baseline),
                        (res.profile, jres.profile)):
        np.testing.assert_array_equal(prof.peak, np.asarray(jprof.peak))
        np.testing.assert_array_equal(prof.src_peak,
                                      np.asarray(jprof.src_peak))
        np.testing.assert_allclose(prof.mean, np.asarray(jprof.mean),
                                   rtol=MEAN_RTOL)
        np.testing.assert_allclose(prof.src_mean,
                                   np.asarray(jprof.src_mean),
                                   rtol=MEAN_RTOL)
    assert res.improvement == pytest.approx(jres.improvement, rel=1e-6)


def test_optimizer_never_worse_and_trajectory_schema(opt_pair):
    res, _ = opt_pair
    assert res.profile.objective() <= res.baseline.objective()
    assert res.improvement >= 0.0
    assert res.iterations >= 1
    assert res.trajectory[0]["iter"] == 0
    for row in res.trajectory:
        for key in ("peak_xlink_flits", "mean_xlink_flits",
                    "peak_onchip_flits", "compile_s", "measure_s",
                    "cut_flits"):
            assert key in row, key


def test_optimizer_program_is_legal(opt_pair):
    res, jres = opt_pair
    board, _ = boards()
    base = compile_board(hybrid_farm_board_graph(board, device="cpu"), board)
    sig = check_delivery(res.program)
    assert sig == check_delivery(base) == j_check_delivery(jres.program)
    assert_neuron_identical(
        ChipSim(res.program, device="cpu").run(12, seed=9),
        ChipSim(base, device="cpu").run(12, seed=9))


def test_measure_profile_reads_the_probes_once():
    board, _ = boards()
    prog = compile_board(hybrid_farm_board_graph(board, device="cpu"), board)
    prof = measure_profile(ChipSim(prog, device="cpu"), 16, seed=3)
    assert isinstance(prof, TrafficProfile)
    recs = ChipSim(prog, device="cpu").run(16, seed=3)
    flits = recs["link_flits"].numpy()
    np.testing.assert_array_equal(prof.peak, flits.max(0))
    np.testing.assert_allclose(prof.mean, flits.mean(0), rtol=MEAN_RTOL)
    np.testing.assert_array_equal(prof.src_peak,
                                  recs["packets"].numpy().max(0))
    assert prof.n_onchip_links == prog.noc.n_onchip_links
    assert set(prof.touched) == {"onchip", "xchip"}


def test_optimizer_budget_zero_skips_iterations():
    board, _ = boards(chip=(2, 2))
    g = synfire_graph(n_pes=board.n_pes, device="cpu")
    res = optimize_routes(g, board, n_ticks=8, max_iters=3, budget_s=0.0,
                          device="cpu")
    assert res.iterations == 0 and not res.converged
    assert len(res.trajectory) == 1             # baseline row only


# -------------------------------------------------------------------------
# The two routing properties, at fixed seeds
# -------------------------------------------------------------------------

def random_graphs(rng):
    """The reference property suite's random placeable graph
    (``tests/test_sparse_noc.py::random_graph``), built in both packages
    from one draw."""
    n_pops = int(rng.integers(1, 6))
    pops = [(f"p{i}", int(rng.integers(1, 5)), bool(rng.integers(2)))
            for i in range(n_pops)]
    projs = []
    for i in range(n_pops):
        dsts = [j for j in range(n_pops) if rng.integers(2)]
        if not dsts:
            continue
        graded = bool(rng.integers(2))
        bits = int(rng.integers(1, 4097)) if graded else 0
        projs.extend((f"p{i}", f"p{j}", graded, bits) for j in dsts)

    def build(net, pop, proj, graded_kind, spike_kind):
        return net([pop(name=n, n=8, sram_bytes=64, n_tiles=t, align_qpe=a)
                    for n, t, a in pops],
                   [proj(src=s, dst=d,
                         payload=graded_kind if g else spike_kind,
                         bits_per_packet=b) for s, d, g, b in projs],
                   semantics=object(), name="rand")
    return (build(NetGraph, Population, Projection, GRADED, SPIKE),
            build(JNetGraph, JPopulation, JProjection, J_GRADED, J_SPIKE))


def random_board(rng):
    chip = (int(rng.integers(2, 5)), int(rng.integers(2, 4)))
    chips = (int(rng.integers(1, 4)), int(rng.integers(1, 3)))
    ports = int(rng.integers(1, min(chip) + 1))
    return boards(chips=chips, chip=chip, ports=ports)


def random_route(rng, pops, board) -> RouteConfig:
    k = board.ports_per_edge
    return RouteConfig(
        tree_orient={p: ORIENTATIONS[rng.integers(2)] for p in pops},
        chip_orient={p: ORIENTATIONS[rng.integers(2)] for p in pops},
        ports={(p, c, d): int(rng.integers(k))
               for p in pops for c in range(board.n_chips) for d in DIRS})


# seeds whose random graph fits its random board (the property suite
# discards the others with ``assume``)
@pytest.mark.parametrize("graph_seed,cfg_seed",
                         [(0, 11), (0, 4), (2, 7), (2, 22), (7, 0)])
def test_delivery_signature_invariant_under_routing(graph_seed, cfg_seed):
    graph, jgraph = random_graphs(np.random.default_rng(graph_seed))
    board, jboard = random_board(np.random.default_rng(cfg_seed))
    base = compile_board(graph, board)
    route = random_route(np.random.default_rng(cfg_seed),
                         [p.name for p in graph.populations], board)
    prog = compile_board(graph, board, route=route)
    sig = check_delivery(prog)
    assert sig == check_delivery(base)
    np.testing.assert_array_equal(prog.table.masks, base.table.masks)
    np.testing.assert_array_equal(prog.payload_bits, base.payload_bits)
    jprog = j_compile_board(jgraph, jboard, route=routes(route)[1])
    assert sig == j_check_delivery(jprog)
    np.testing.assert_array_equal(prog.sinc.link_ids, jprog.sinc.link_ids)


@pytest.mark.parametrize("cfg_seed", [0, 1, 2, 3])
def test_neuron_records_bitwise_invariant(cfg_seed):
    board, jboard = boards(chip=(2, 2), ports=2)
    base = compile_board(synfire_graph(n_pes=board.n_pes, device="cpu"),
                         board)
    graph = synfire_graph(n_pes=board.n_pes, device="cpu")
    route = random_route(np.random.default_rng(cfg_seed),
                         [p.name for p in graph.populations], board)
    prog = compile_board(graph, board, route=route)
    sig = check_delivery(prog)
    assert sig == check_delivery(base)
    jprog = j_compile_board(j_synfire_graph(n_pes=jboard.n_pes), jboard,
                            route=routes(route)[1])
    assert sig == j_check_delivery(jprog)
    assert_neuron_identical(ChipSim(prog, device="cpu").run(10, seed=2),
                            ChipSim(base, device="cpu").run(10, seed=2))
