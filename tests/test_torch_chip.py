"""The port's main path against the JAX reference, on the CPU.

synfire_graph -> compile -> ChipSim.run -> chip_power_table, run through
``repro`` and through ``repro_torch`` (device="cpu", so every kernel
wrapper takes its plain version).  Integer records are compared bitwise;
float energy records at rtol=1e-6, against the reference's unprobed run,
because the reference itself is only 1-ulp stable on them.
"""
import jax
import numpy as np
import pytest
import torch

from repro.chip.chip import ChipSim as JChipSim
from repro.chip.chip import chip_power_table as j_chip_power_table
from repro.chip.compile import compile as j_compile
from repro.chip.graph import NetGraph as JNetGraph
from repro.chip.graph import Population as JPopulation
from repro.chip.graph import Projection as JProjection
from repro.chip.mesh_noc import MeshNoc as JMeshNoc
from repro.chip.mesh_noc import MeshSpec as JMeshSpec
from repro.chip.workloads import synfire_graph as j_synfire_graph
from repro.core import snn as jsnn

import repro_torch
from repro_torch.chip import ChipSim, chip_power_table, compile
from repro_torch.chip.graph import GRADED, NetGraph, Population, Projection
from repro_torch.chip.mesh_noc import MeshNoc, MeshSpec
from repro_torch.chip.workloads import synfire_graph, synfire_workload
from repro_torch.core import snn
from repro_torch.kernels.lif.ops import lif_params_fx
from repro_torch.learn import PES, STDP

INT_RECORDS = ("spikes_exc", "spikes_inh", "pl", "n_fifo", "syn_events",
               "packets", "active_sources")
EXACT_FLOAT_RECORDS = ("link_load", "link_flits", "t_sp", "active_frac",
                       "touched_links", "touched_links_onchip")
ENERGY_RECORDS = ("e_dvfs_baseline", "e_dvfs_neuron", "e_dvfs_synapse",
                  "e_pl3_baseline", "e_pl3_neuron", "e_pl3_synapse", "e_noc")
RTOL = 1e-6
# the power table averages 2400 float32 records; PyTorch and XLA sum them
# in different orders, which moves the mean by a few float32 ulps
TABLE_RTOL = 1e-5


def _reference_draws(seed, n_ticks, shape):
    """The reference tick's Gaussian background, as a noise source."""
    key = jax.random.PRNGKey(seed)
    draws = [np.array(jax.random.normal(jax.random.fold_in(key, t), shape))
             for t in range(n_ticks)]
    return lambda t: torch.from_numpy(draws[t])


def assert_records_match(got, want):
    assert set(got) == set(want)
    for k in INT_RECORDS + EXACT_FLOAT_RECORDS:
        g, w = got[k].cpu().numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    for k in ENERGY_RECORDS:
        g = got[k].cpu().numpy()
        assert g.dtype == np.float32, k
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=RTOL,
                                   atol=0, err_msg=k)


# ------------------------------------------------------------------ compile

def _ring_graphs(n_pes):
    """The synfire ring's populations and projections in both packages
    (compile only reads placement data, so no net is built)."""
    def ring(G, Pop, Proj):
        return G([Pop(f"pe{i}", 250, 90_000) for i in range(n_pes)],
                 [Proj(f"pe{i}", f"pe{(i + 1) % n_pes}", delay_ticks=10)
                  for i in range(n_pes)], semantics=object())
    return (ring(NetGraph, Population, Projection),
            ring(JNetGraph, JPopulation, JProjection))


@pytest.mark.parametrize("n_pes", [8, 64, 256])
def test_compile_matches_reference(n_pes):
    prog, jprog = (compile(g) if i == 0 else j_compile(g)
                   for i, g in enumerate(_ring_graphs(n_pes)))
    assert (prog.mesh.width, prog.mesh.height) == (jprog.mesh.width,
                                                   jprog.mesh.height)
    assert prog.noc.n_links == jprog.noc.n_links
    for name in ("coords", "payload_bits", "sram_bytes"):
        np.testing.assert_array_equal(getattr(prog, name),
                                      getattr(jprog, name))
    np.testing.assert_array_equal(prog.table.masks, jprog.table.masks)
    s, js = prog.sinc, jprog.sinc
    for name in ("link_ids", "source_ptr", "tree_hops", "tree_links",
                 "src_of_entry"):
        np.testing.assert_array_equal(getattr(s, name), getattr(js, name))
    for a, b in zip(s.csc, js.csc):
        np.testing.assert_array_equal(a, b)
    assert (s.density, s.max_fan_in) == (js.density, js.max_fan_in)
    np.testing.assert_array_equal(prog.inc, jprog.inc)
    assert prog.pe_slices == jprog.pe_slices
    assert prog.worst_tree_hops == jprog.worst_tree_hops
    assert prog.fits() and jprog.fits()
    sim, jsim = ChipSim(prog, device="cpu"), JChipSim(jprog)
    assert sim.use_sparse_noc() == jsim.use_sparse_noc()


@pytest.mark.parametrize("width,height,seed", [(5, 4, 0), (3, 7, 1),
                                               (8, 8, 2)])
def test_tree_link_ids_match_reference(width, height, seed):
    """X-first multicast trees from random sources to random destination
    sets, off the ring's regular pattern, give the reference's link ids."""
    noc = MeshNoc(MeshSpec(width, height))
    jnoc = JMeshNoc(JMeshSpec(width, height))
    assert noc.links == jnoc.links
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for _ in range(20):
        srcs.append((rng.integers(width), rng.integers(height)))
        n = int(rng.integers(0, 6))
        dsts.append(np.stack([rng.integers(0, width, n),
                              rng.integers(0, height, n)], 1))
    for s, d in zip(srcs, dsts):
        np.testing.assert_array_equal(noc.tree_link_ids(s, d),
                                      jnoc.tree_link_ids(s, d))
    got = noc.sparse_incidence(np.array(srcs), dsts)
    want = jnoc.sparse_incidence(np.array(srcs), dsts)
    for name in ("link_ids", "source_ptr", "tree_hops"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_compile_rejects_plastic_projections():
    """What the reference's lowering refuses, naming the edge: a rule that
    is neither STDP nor PES, STDP on a GRADED projection and PES on a
    SPIKE one."""
    g, _ = _ring_graphs(8)
    g.projections[0] = Projection("pe0", "pe1", plasticity=object())
    with pytest.raises(ValueError,
                       match="pe0->pe1: unknown plasticity rule"):
        compile(g)
    g.projections[0] = Projection("pe0", "pe1", payload=GRADED,
                                  bits_per_packet=32, plasticity=STDP())
    with pytest.raises(ValueError, match="pe0->pe1: STDP needs a SPIKE"):
        compile(g)
    g.projections[0] = Projection("pe0", "pe1", plasticity=PES())
    with pytest.raises(ValueError, match="pe0->pe1: PES needs a GRADED"):
        compile(g)


# ------------------------------------------------------------------ network

@pytest.mark.parametrize("n_pes,noise_model", [(8, "gauss"), (16, "shot")])
def test_build_synfire_reproduces_reference_arrays(n_pes, noise_model):
    net = snn.build_synfire(3, n_pes=n_pes, noise_model=noise_model,
                            device="cpu")
    jnet = jsnn.build_synfire(3, n_pes=n_pes, noise_model=noise_model)
    for k in ("w_ff", "w_inh", "deg_ff", "deg_inh"):
        g = getattr(net, k)
        assert g.dtype == torch.int32, k
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(jnet, k)))
    assert net.lif == jnet.lif
    for k in ("noise_sigma_fx", "stim_ticks", "stim_current_fx",
              "noise_model", "kicks_per_tick", "kick_fx"):
        assert getattr(net, k) == getattr(jnet, k), k
    assert net.params.n_pes == jnet.params.n_pes


def test_carried_weights_tick_like_the_reference():
    """A reference net carried across with ``net_from_numpy`` runs the
    same ticks as the reference's own ``simulate_synfire``."""
    jnet = jsnn.build_synfire(5, n_pes=8)
    arrays = {k: np.asarray(getattr(jnet, k))
              for k in ("w_ff", "w_inh", "deg_ff", "deg_inh")}
    scalars = {k: getattr(jnet, k) for k in (
        "noise_sigma_fx", "stim_ticks", "stim_current_fx", "noise_model",
        "kicks_per_tick", "kick_fx")}
    net = snn.net_from_numpy(arrays, jnet.params, jnet.lif, device="cpu",
                             **scalars)
    want = jsnn.simulate_synfire(jnet, 120, seed=2)
    got = snn.simulate_synfire(net, 120, seed=2,
                               noise=_reference_draws(2, 120, (8, 250)))
    for k in ("spikes_exc", "spikes_inh", "pl", "n_fifo", "syn_events",
              "packets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["spikes_exc"].sum() > 0


# ------------------------------------------------------------ end to end

@pytest.fixture(scope="module")
def paper_chip():
    """The 8-PE test chip (dense NoC), 300 ticks, both packages, the
    reference's Gaussian draws injected into the port."""
    T = 300
    jsim = JChipSim(j_compile(j_synfire_graph(8)))
    want = jsim.run(T)
    sim = ChipSim(compile(synfire_graph(8, device="cpu")), device="cpu")
    got = sim.run(T, noise=_reference_draws(1, T, (8, 250)))
    return sim, got, jsim, want


def test_paper_chip_records_match_reference(paper_chip):
    sim, got, _, want = paper_chip
    assert not sim.use_sparse_noc()
    assert_records_match(got, want)
    assert got["spikes_exc"].sum() > 0


def test_paper_chip_power_table_matches_reference(paper_chip):
    sim, got, jsim, want = paper_chip
    tab, jtab = chip_power_table(sim, got), j_chip_power_table(jsim, want)
    assert tab["n_pes"] == jtab["n_pes"] and tab["mesh"] == jtab["mesh"]
    for mode in ("dvfs", "pl3"):
        for k, v in jtab["per_pe"][mode].items():
            assert tab["per_pe"][mode][k] == pytest.approx(v, rel=TABLE_RTOL)
    for k, v in jtab["noc"].items():
        assert tab["noc"][k] == pytest.approx(v, rel=TABLE_RTOL), k


def test_shot_noise_sparse_noc_matches_reference():
    """64 PEs, shot noise from the port's own hash, sparse (CSC) NoC."""
    T = 300
    want = JChipSim(j_compile(j_synfire_graph(64, noise_model="shot")),
                    noc_mode="sparse").run(T)
    sim = ChipSim(compile(synfire_graph(64, noise_model="shot",
                                        device="cpu")),
                  noc_mode="sparse", device="cpu")
    got = sim.run(T)
    assert_records_match(got, want)
    dense = sim.run(T, noc_mode="dense")
    for k in ("link_load", "link_flits"):
        np.testing.assert_array_equal(dense[k].numpy(), got[k].numpy())
    assert got["link_load"].sum() > 0


def test_generator_noise_carries_the_wave():
    """A standalone run (generator noise, not the reference's draws) still
    carries the 80-tick wave around the 8-PE ring."""
    out = synfire_workload(8, n_ticks=400, device="cpu")
    spk = out["recs"]["spikes_exc"].sum(2).numpy()
    for p in range(8):
        strong = np.flatnonzero(spk[:, p] > 100)
        assert np.all(np.abs(np.diff(strong[:4]) - 80) <= 2), (p, strong)
    tab = out["table"]["per_pe"]
    assert tab["pl3"]["baseline"] == pytest.approx(66.44, abs=0.1)
    assert 0.55 <= tab["reduction"]["baseline"] <= 0.72


# ------------------------------------------------------------------ contract

def test_default_device_is_the_gpu_or_raises():
    if torch.cuda.is_available():
        assert repro_torch.default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.default_device()
        g, _ = _ring_graphs(8)
        with pytest.raises(RuntimeError, match="CUDA"):
            ChipSim(compile(g))


@pytest.mark.parametrize("n_pes", [8, 64, 256])
def test_exec_mode_auto_resolves_like_the_reference(n_pes):
    """Both engines default to "auto", which picks event mode exactly when
    the NoC goes sparse; forcing either mode resolves alike too."""
    g, jg = _ring_graphs(n_pes)
    sim, jsim = ChipSim(compile(g), device="cpu"), JChipSim(j_compile(jg))
    assert sim.exec_mode == jsim.exec_mode == "auto"
    assert sim.use_event_mode() == jsim.use_event_mode() \
        == jsim.use_sparse_noc()
    for mode in ("event", "dense"):
        assert sim.use_event_mode(mode) == jsim.use_event_mode(mode)


def test_unknown_modes_raise():
    g, _ = _ring_graphs(8)
    prog = compile(g)
    with pytest.raises(ValueError, match="exec_mode"):
        ChipSim(prog, exec_mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="event_gather impl"):
        ChipSim(prog, event_impl="bogus", device="cpu")
    for impl in ("auto", "gather", "pallas"):
        ChipSim(prog, event_impl=impl, device="cpu")
    with pytest.raises(ValueError, match="exec_mode"):
        ChipSim(prog, device="cpu").use_event_mode("bogus")


def test_entry_points_ask_for_the_card_by_default():
    """``lif_params_fx`` and ``shot_noise_lanes`` run on the CUDA device
    unless given one; without a card they raise ``resolve_device``'s
    error instead of running on the CPU."""
    kw = dict(tau_ms=10.0, v_th=1.0, v_reset=0.0, ref_ticks=2)
    if torch.cuda.is_available():
        assert lif_params_fx(**kw) == lif_params_fx(**kw, device="cpu")
        assert snn.shot_noise_lanes(3, 5, 4, 1000).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lif_params_fx(**kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        snn.shot_noise_lanes(3, 5, 4, 1000)
    assert lif_params_fx(**kw, device="cpu")["alpha"] > 0
