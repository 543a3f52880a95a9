"""The port's NoC routes, router and placers against the reference's, on
the CPU: dimension-ordered routes and multicast trees in both
orientations (``core.noc``), the cost model ``NocModel``, the
``RoutingTable`` and its exchanges (``core.router``), the older placers
``place_ring`` and ``place_layers`` (``chip.mapping``), and Y-first trees
through ``MeshNoc.tree_link_ids`` and ``compile(orientations=)``, each on
the same seeded inputs.  The reference's forced-mesh exchange has no
single-device counterpart and is not compared."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chip.compile import compile as j_compile
from repro.chip.mapping import place_layers as j_place_layers
from repro.chip.mapping import place_ring as j_place_ring
from repro.chip.mesh_noc import MeshNoc as JMeshNoc
from repro.chip.mesh_noc import MeshSpec as JMeshSpec
from repro.chip.workloads import hybrid_farm_graph as j_hybrid_farm_graph
from repro.core import noc as jnoc
from repro.core.router import RoutingTable as JRoutingTable
from repro.core.router import multicast_exchange as j_multicast_exchange

from repro_torch.chip import ChipSim, compile
from repro_torch.chip.mapping import place_layers, place_ring
from repro_torch.chip.mesh_noc import MeshNoc, MeshSpec
from repro_torch.chip.workloads import hybrid_farm_graph, synfire_graph
from repro_torch.core import noc
from repro_torch.core.router import (RoutingTable, multicast_exchange,
                                     ring_exchange)


def _coords(rng, n, w=9, h=7):
    return [tuple(int(v) for v in c)
            for c in zip(rng.integers(0, w, n), rng.integers(0, h, n))]


@pytest.mark.parametrize("orientation", noc.ORIENTATIONS)
def test_routes_and_trees_match_the_reference(orientation):
    rng = np.random.default_rng(0)
    assert noc.ORIENTATIONS == jnoc.ORIENTATIONS
    for _ in range(200):
        src, *dsts = _coords(rng, int(rng.integers(2, 9)))
        for d in dsts:
            assert noc.xy_route(src, d) == jnoc.xy_route(src, d)
            assert noc.hops(src, d) == jnoc.hops(src, d)
            assert noc.oriented_route(src, d, orientation) == \
                jnoc.oriented_route(src, d, orientation)
        assert noc.build_tree(src, dsts, orientation) == \
            jnoc.build_tree(src, dsts, orientation)
        assert noc.multicast_links(src, dsts) == \
            jnoc.multicast_links(src, dsts)
    with pytest.raises(ValueError, match="orientation"):
        noc.oriented_route((0, 0), (1, 1), "zz")


def test_noc_model_matches_the_reference():
    rng = np.random.default_rng(1)
    m, jm = noc.NocModel(), jnoc.NocModel()
    for _ in range(50):
        src, *dsts = _coords(rng, 5)
        assert m.packet_latency_s(src, dsts[0]) == \
            jm.packet_latency_s(src, dsts[0])
        assert m.spike_energy_j(src, dsts) == jm.spike_energy_j(src, dsts)
        bits = int(rng.integers(1, 600))
        assert m.payload_energy_j(src, dsts, bits) == \
            jm.payload_energy_j(src, dsts, bits)
    for kind in ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
                 "collective-permute"):
        for n in (1, 4, 7):
            assert m.collective_link_bytes(kind, 4096, n) == \
                jm.collective_link_bytes(kind, 4096, n)
    with pytest.raises(ValueError):
        m.collective_link_bytes("scatter", 1, 2)


def test_routing_table_and_exchanges_match_the_reference():
    rng = np.random.default_rng(2)
    masks = rng.random((6, 6)) < 0.4
    spk = rng.integers(0, 3, (6, 5)).astype(np.int32)
    for t, jt in ((RoutingTable.ring(6), JRoutingTable.ring(6)),
                  (RoutingTable.self_loop(6), JRoutingTable.self_loop(6)),
                  (RoutingTable(masks), JRoutingTable(masks))):
        np.testing.assert_array_equal(t.masks, jt.masks)
        np.testing.assert_array_equal(t.fan_out(), jt.fan_out())
        dm = t.delivery_matrix("cpu")
        assert dm.dtype == torch.int32
        np.testing.assert_array_equal(dm.numpy(),
                                      np.asarray(jt.delivery_matrix()))
        got = multicast_exchange(torch.from_numpy(spk), t)
        want = np.asarray(j_multicast_exchange(jnp.asarray(spk), jt))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) == int((spk * t.fan_out()[:, None]).sum())
    np.testing.assert_array_equal(ring_exchange(torch.from_numpy(spk)).numpy(),
                                  np.roll(spk, 1, 0))


@pytest.mark.parametrize("n_pes", [8, 24])
def test_place_ring_matches_compile_and_the_reference(n_pes):
    prog = compile(synfire_graph(n_pes, device="cpu"))
    pl, jpl = place_ring(n_pes), j_place_ring(n_pes)
    assert (prog.mesh.width, prog.mesh.height) == \
        (pl.mesh.width, pl.mesh.height) == (jpl.mesh.width, jpl.mesh.height)
    for a in (prog.coords, jpl.coords):
        np.testing.assert_array_equal(pl.coords, a)
    np.testing.assert_array_equal(pl.table.masks, prog.table.masks)
    np.testing.assert_array_equal(pl.inc, prog.inc)
    np.testing.assert_array_equal(pl.inc, jpl.inc)
    assert pl.worst_tree_hops == jpl.worst_tree_hops
    assert pl.fits() and pl.sram_bytes_per_pe == jpl.sram_bytes_per_pe
    with pytest.raises(ValueError, match="mesh capacity"):
        place_ring(40, MeshSpec(2, 2))


def test_place_layers_matches_the_reference():
    layers = [dict(h=32, w=32, cin=16, cout=32, kh=3, kw=3, name="c1"),
              dict(h=30, w=30, cin=32, cout=64, kh=3, kw=3, name="c2"),
              dict(h=28, w=28, cin=64, cout=64, kh=3, kw=3)]
    for mesh, jmesh in ((None, None), (MeshSpec(3, 3), JMeshSpec(3, 3))):
        got = place_layers(layers, mesh)
        want = j_place_layers(layers, jmesh)
        for g, w in zip(got[0], want[0]):
            assert g.__dict__ == w.__dict__
        assert got[1].n_links == want[1].n_links
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("orientation", noc.ORIENTATIONS)
def test_tree_link_ids_match_the_reference(orientation):
    rng = np.random.default_rng(3)
    m, jm = MeshNoc(MeshSpec(6, 5)), JMeshNoc(JMeshSpec(6, 5))
    for _ in range(200):
        src, *dsts = _coords(rng, int(rng.integers(2, 10)), 6, 5)
        d = np.asarray(dsts, np.int64)
        got = m.tree_link_ids(src, d, orientation=orientation)
        np.testing.assert_array_equal(
            got, jm.tree_link_ids(src, d, orientation=orientation))
        tree = {m.links.index(e) for e in noc.build_tree(src, dsts,
                                                         orientation)}
        assert set(got.tolist()) == tree and len(got) == len(tree)
    with pytest.raises(ValueError, match="orientation"):
        m.tree_link_ids((0, 0), np.array([[1, 1]]), orientation="zz")


def test_compile_orientations_match_the_reference():
    """Y-first trees for half the farm's channels, whose projections
    cross the snake: the same CSR incidence as the reference's, other
    links than X-first, the same packets."""
    n = 16
    orient = {f"nef{k}": "yx" for k in range(0, n, 2)}
    prog = compile(hybrid_farm_graph(n, device="cpu"), orientations=orient)
    jprog = j_compile(j_hybrid_farm_graph(n), orientations=orient)
    for k in ("link_ids", "source_ptr", "tree_hops"):
        np.testing.assert_array_equal(getattr(prog.sinc, k),
                                      getattr(jprog.sinc, k))
    xy = compile(hybrid_farm_graph(n, device="cpu"))
    assert not np.array_equal(prog.sinc.link_ids, xy.sinc.link_ids)
    a = ChipSim(prog, device="cpu").run(12)
    b = ChipSim(xy, device="cpu").run(12)
    assert torch.equal(a["packets"], b["packets"])
    assert not torch.equal(a["link_load"], b["link_load"])
