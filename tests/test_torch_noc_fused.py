"""The engine's fused NoC accounting against the reference, on the CPU.

``MeshNoc.noc_loads`` now takes each source's flits per packet, computed
once per run where the payload bits are static (``packet_costs``), and
sums both rows in one call of ``kernels/link_load``'s ``noc_link_loads``
over a padded link-major table or the CSC layout, by the fan-in.  Its
plain version (the CPU path here) is held bitwise against the
reference's ``MeshNoc.noc_loads`` under both of the reference's plans,
the Pallas CSC kernel in interpret mode and the column plan, on graded
payloads whose flit row differs from the packet row; the synfire ring's
records with the costs hoisted against the reference's run; and the
count of pricing calls, once a run for static payloads and once a tick
for the hybrid's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chip.chip import ChipSim as JChipSim
from repro.chip.compile import compile as j_compile
from repro.chip.mesh_noc import MeshNoc as JMeshNoc
from repro.chip.mesh_noc import MeshSpec as JMeshSpec
from repro.chip.workloads import synfire_graph as j_synfire_graph

from repro_torch.chip import ChipSim, compile, mesh_noc
from repro_torch.chip.mesh_noc import MeshNoc, MeshSpec, SparseIncidence
from repro_torch.chip.workloads import hybrid_workload, synfire_graph
from repro_torch.kernels import noc_link_loads
from repro_torch.kernels.link_load.ref import link_loads_ref

# PADDED_MAX_FAN_IN that sends every incidence of these tests to a route
ROUTES = {"padded": 2**31, "csc": -1}


def _random_noc(seed, width=6, height=5, n_src=70):
    """Both packages' NoC on a W x H mesh with random X-first multicast
    trees; the port's incidence is built from the reference's arrays."""
    rng = np.random.default_rng(seed)
    jnoc = JMeshNoc(JMeshSpec(width, height))
    srcs = np.stack([rng.integers(0, width, n_src),
                     rng.integers(0, height, n_src)], 1)
    dsts = [np.stack([rng.integers(0, width, n), rng.integers(0, height, n)],
                     1) for n in rng.integers(0, 5, n_src)]
    jsinc = jnoc.sparse_incidence(srcs, dsts)
    sinc = SparseIncidence(link_ids=jsinc.link_ids.copy(),
                           source_ptr=jsinc.source_ptr.copy(),
                           n_links=jsinc.n_links,
                           tree_hops=jsinc.tree_hops.copy())
    return MeshNoc(MeshSpec(width, height)), sinc, jnoc, jsinc, rng


def _graded(rng, n_src):
    """Packets 0-20 and payload bits: a third spike packets (0 bits), the
    rest 1-600 bits, 1-5 flits."""
    packets = rng.integers(0, 21, n_src).astype(np.int32)
    bits = rng.integers(1, 601, n_src)
    bits[rng.random(n_src) < 1 / 3] = 0
    return packets, bits


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("impl", ["pallas", "column_plan"])
def test_fused_noc_loads_match_reference(impl, route, monkeypatch):
    monkeypatch.setattr(mesh_noc, "PADDED_MAX_FAN_IN", ROUTES[route])
    noc, sinc, jnoc, jsinc, rng = _random_noc(3)
    assert sinc.max_fan_in > 1 and (sinc.tree_links == 0).any()
    packets, bits = _graded(rng, sinc.n_sources)
    plan = noc.device_plan(sinc, "cpu")
    assert (plan[1] is None) == (route == "padded")
    flits, _ = noc.packet_costs(torch.from_numpy(bits))
    got = noc.noc_loads(torch.from_numpy(packets), plan, flits)
    want = jnoc.noc_loads(jnp.asarray(packets),
                          jnoc.device_plan(jsinc, impl), jnp.asarray(bits))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[1].sum()) > float(got[0].sum()) > 0


def test_packet_costs_and_energy_match_reference():
    noc, sinc, jnoc, _, rng = _random_noc(4)
    packets, bits = _graded(rng, sinc.n_sources)
    flits, per_hop = noc.packet_costs(torch.from_numpy(bits))
    np.testing.assert_array_equal(flits.numpy(),
                                  np.asarray(jnoc.packet_flits(bits)))
    np.testing.assert_array_equal(per_hop.numpy(),
                                  np.asarray(jnoc.packet_bits(bits)))
    tl = sinc.tree_links.astype(np.float32)
    got = noc.traffic_energy_j(torch.from_numpy(packets),
                               torch.from_numpy(tl), per_hop)
    want = jnoc.traffic_energy_j(jnp.asarray(packets), tl, jnp.asarray(bits))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("n_src,n_links", [(1, 3), (37, 50), (4099, 700)])
def test_noc_link_loads_routes_agree(n_src, n_links):
    """Both plans of one incidence (links with no source, the heaviest
    link, P not a multiple of 4) give the entry-wise sum."""
    rng = np.random.default_rng(n_src)
    nnz = 3 * n_src
    link_ids = rng.integers(0, n_links, nnz).astype(np.int32)
    link_ids[: nnz // 10] = n_links - 1            # one heavy link
    src = rng.integers(0, n_src, nnz).astype(np.int32)
    sinc = SparseIncidence.from_rows(
        [link_ids[src == p] for p in range(n_src)], n_links,
        np.zeros(n_src, np.int32))
    pk = torch.from_numpy(rng.integers(0, 200, n_src).astype(np.float32))
    fl = torch.from_numpy(rng.integers(1, 5, n_src).astype(np.float32))
    want = link_loads_ref(torch.stack([pk, pk * fl]),
                          torch.from_numpy(sinc.link_ids),
                          torch.from_numpy(sinc.src_of_entry), n_links)
    table = torch.from_numpy(sinc.link_major)
    assert table.shape == (sinc.max_fan_in, n_links)
    got = noc_link_loads(pk, fl, table, n_links=n_links)
    src_sorted, link_ptr = sinc.csc
    csc = noc_link_loads(pk, fl, torch.from_numpy(src_sorted),
                         torch.from_numpy(link_ptr.astype(np.int32)),
                         n_links=n_links)
    assert torch.equal(got, want) and torch.equal(csc, want)
    with pytest.raises(ValueError, match="bad shapes"):
        noc_link_loads(pk, fl[:-1] if n_src > 1 else fl[:0], table,
                       n_links=n_links)


@pytest.fixture(scope="module")
def ring_reference():
    """The reference's 64-PE shot-noise ring: sparse NoC, dense exec."""
    T = 150
    jsim = JChipSim(j_compile(j_synfire_graph(64, noise_model="shot")),
                    noc_mode="sparse", exec_mode="dense")
    return T, jsim.run(T)


@pytest.mark.parametrize("route", ROUTES)
def test_ring_records_with_hoisted_costs_match_reference(
        route, ring_reference, monkeypatch):
    T, want = ring_reference
    monkeypatch.setattr(mesh_noc, "PADDED_MAX_FAN_IN", ROUTES[route])
    calls = []
    costs = MeshNoc.packet_costs
    monkeypatch.setattr(MeshNoc, "packet_costs",
                        lambda self, pb: calls.append(1) or costs(self, pb))
    sim = ChipSim(compile(synfire_graph(64, noise_model="shot",
                                        device="cpu")),
                  noc_mode="sparse", exec_mode="dense", device="cpu")
    got = sim.run(T)
    assert len(calls) == 1                  # static payloads: once a run
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        if k.startswith("e_"):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    assert got["link_load"].sum() > 0


def test_per_tick_payloads_are_priced_every_tick(monkeypatch):
    calls = []
    costs = MeshNoc.packet_costs
    monkeypatch.setattr(MeshNoc, "packet_costs",
                        lambda self, pb: calls.append(1) or costs(self, pb))
    out = hybrid_workload(64, 16, n_ticks=20, device="cpu")
    assert len(calls) == 1 + 20             # the stepper's, then each tick
    assert out["recs"]["link_flits"].sum() > 0
