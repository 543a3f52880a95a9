"""The port's event execution mode against the JAX reference, on the CPU.

Event-mode NoC accounting (``kernels/event_gather``: the active-source
compaction and the gather of padded incidence rows) and the
activity-compressed synfire tick, through ``repro`` and through
``repro_torch`` (device="cpu": every kernel wrapper takes its plain
version).  Event mode must equal the reference's event mode and the
port's own dense mode bit for bit on integer records and link loads,
overflow ticks included; float energies are held at rtol=1e-6 against
the reference (its own 1-ulp stability) and bitwise against dense.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chip.chip import ChipSim as JChipSim
from repro.chip.compile import compile as j_compile
from repro.chip.mesh_noc import SparseIncidence as JSparseIncidence
from repro.chip.workloads import synfire_graph as j_synfire_graph
from repro.configs import paper as jpaper
from repro.core import snn as jsnn
from repro.core.dvfs import DVFSController as JDVFS
from repro.core.energy import PEEnergyModel as JEnergy
from repro.kernels.event_gather import active_source_set as j_active_set
from repro.kernels.event_gather import event_link_loads as j_event_loads
from repro.kernels.event_gather import event_link_loads_ref as j_event_ref
from repro.kernels.event_gather.event_gather import onehot_link_accum_pallas
from repro.kernels.event_gather.ops import gather_entries as j_gather

from repro_torch.chip import ChipSim, compile
from repro_torch.chip.mesh_noc import SparseIncidence
from repro_torch.chip.workloads import synfire_graph
from repro_torch.configs import paper
from repro_torch.core import snn
from repro_torch.core.dvfs import DVFSController
from repro_torch.core.energy import PEEnergyModel
from repro_torch.kernels import event_link_loads, syn_accum
from repro_torch.kernels.event_gather import (active_source_set,
                                              event_link_loads_ref,
                                              gather_entries)

from test_torch_chip import _reference_draws, assert_records_match

SCALED = dict(neurons_per_core=20, synapses_per_core=400, l_th1=2, l_th2=7)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_bitwise(got, want):
    """Every record of two port runs: same keys, dtypes and bits."""
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------------- kernel level

def _random_incidence(rng, n_src, n_links, max_tree):
    rows = [rng.choice(n_links, rng.integers(0, max_tree + 1),
                       replace=False) for _ in range(n_src)]
    hops = rng.integers(0, 9, n_src)
    return (SparseIncidence.from_rows(rows, n_links, hops),
            JSparseIncidence.from_rows(rows, n_links, hops))


@pytest.mark.parametrize("n_src,n_links,max_tree,cap", [
    (64, 48, 12, 64), (300, 1000, 40, 300), (300, 1000, 40, 37)])
def test_event_link_loads_match_reference(n_src, n_links, max_tree, cap):
    """The plain version against the reference's jnp oracle, its gather
    impl and its Pallas kernel (interpret mode), bitwise, on integer
    packet and flit counts with about half the sources quiet."""
    rng = np.random.default_rng(n_src + cap)
    sinc, jsinc = _random_incidence(rng, n_src, n_links, max_tree)
    np.testing.assert_array_equal(sinc.padded_rows, jsinc.padded_rows)
    rows = sinc.padded_rows
    pk = rng.integers(0, 60, n_src) * (rng.random(n_src) < 0.5)
    w = np.stack([pk, pk * rng.integers(1, 5, n_src)]).astype(np.float32)
    # the bound that makes float32 accumulation order-free: every link's
    # sum, and so every partial sum, is an integer below 2**24
    dense = np.zeros((n_src, n_links))
    dense[sinc.src_of_entry, sinc.link_ids] = 1.0
    assert (w.astype(np.float64) @ dense).max() < 2**24
    jidx, jn = j_active_set(jnp.asarray(w[1]), cap)
    idx, n = active_source_set(_t(w[1]), cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(n) == int(jn)
    if int(n) > cap:             # overflow: callers compact at full width
        idx, _ = active_source_set(_t(w[1]), n_src)
        jidx, _ = j_active_set(jnp.asarray(w[1]), n_src)
    got = event_link_loads(idx, _t(w), _t(rows), n_links=n_links).numpy()
    np.testing.assert_array_equal(got, w @ dense.astype(np.float32))
    for b in range(2):
        jw = jnp.asarray(w[b])
        want = np.asarray(j_event_ref(jidx, jw, jnp.asarray(rows), n_links))
        np.testing.assert_array_equal(got[b], want)
        for impl in ("gather", "pallas"):
            np.testing.assert_array_equal(
                got[b], np.asarray(j_event_loads(jidx, jw, jnp.asarray(rows),
                                                 n_links=n_links,
                                                 impl=impl)))
        ids, we = gather_entries(idx, _t(w[b]), _t(rows))
        jids, jwe = j_gather(jidx, jw, jnp.asarray(rows))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(we.numpy(), np.asarray(jwe))
        np.testing.assert_array_equal(
            got[b], np.asarray(onehot_link_accum_pallas(jids, jwe,
                                                        n_links=n_links)))
        one = event_link_loads_ref(idx, _t(w[b]), _t(rows), n_links)
        np.testing.assert_array_equal(one.numpy(), got[b])


@pytest.mark.parametrize("P,cap,density", [(1, 1, 1.0), (100, 7, 0.05),
                                           (4096, 4096, 0.3),
                                           (70000, 64, 0.0005)])
def test_active_source_set_matches_reference(P, cap, density):
    rng = np.random.default_rng(P)
    w = (rng.random(P) < density) * rng.integers(1, 5, P)
    w = w.astype(np.float32)
    idx, n = active_source_set(_t(w), cap)
    jidx, jn = j_active_set(jnp.asarray(w), cap)
    assert idx.dtype == torch.int32 and idx.shape == (cap,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(n) == int(jn)


def test_event_link_loads_reject_what_the_kernel_does_not_take():
    idx = torch.zeros(4, dtype=torch.int32)
    rows = torch.zeros(8, 3, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        event_link_loads(idx, torch.zeros(8, dtype=torch.int32), rows,
                         n_links=5)
    with pytest.raises(ValueError, match="bad shapes"):
        event_link_loads(idx, torch.zeros(7), rows, n_links=5)


# ------------------------------------------------------------- compaction

@pytest.mark.parametrize("P,cap,active", [
    (48, 64, [3, 4, 47]), (48, 64, []), (300, 64, list(range(0, 300, 7))),
    (300, 4, [1, 2, 3, 4]), (300, 4, [1, 2, 3, 4, 5]),
    (2000, 64, [64 * k for k in range(17)]),
    (2000, 64, [64 * k for k in range(16)])])
def test_compact_lists_the_set_or_flags_overflow(P, cap, active):
    """``compact`` is the reference's two-level sort: the set's ids in
    ascending order then sentinel P, ``cap_eff`` lanes; it fits when no
    more than ``cap_eff`` PEs in no more than 16 chunks of 64 are set."""
    src = torch.zeros(P, dtype=torch.bool)
    src[active] = True
    idx, fits = snn.compact(src, cap)
    nc = -(-P // snn.EVENT_CHUNK)
    kc = min(snn.EVENT_MAX_CHUNKS, nc)
    cap_eff = min(cap, P, kc * snn.EVENT_CHUNK)
    chunks = {a // snn.EVENT_CHUNK for a in active}
    assert idx.dtype == torch.int32 and idx.shape == (cap_eff,)
    assert bool(fits) == (len(active) <= cap_eff and len(chunks) <= kc)
    if fits:
        want = sorted(active) + [P] * (cap_eff - len(active))
        assert idx.tolist() == want


def test_padded_rows_match_reference():
    prog = compile(synfire_graph(64, noise_model="shot", device="cpu"))
    jprog = j_compile(j_synfire_graph(64, noise_model="shot"))
    np.testing.assert_array_equal(prog.sinc.padded_rows,
                                  jprog.sinc.padded_rows)


# ------------------------------------------------------------- engine level

def _sp(**kw):
    fields = dict(n_exc=16, n_inh=4, fan_in_exc=8, fan_in_inh=4, **SCALED,
                  **kw)
    return (dataclasses.replace(paper.SYNFIRE, **fields),
            dataclasses.replace(jpaper.SYNFIRE, **fields))


def test_golden_8pe_event_matches_reference_and_dense():
    """The paper's 8-PE chip (Gaussian background, dense NoC) in event
    mode: the reference's event records, and the port's dense ones."""
    T = 200
    want = JChipSim(j_compile(j_synfire_graph(8)), exec_mode="event").run(T)
    prog = compile(synfire_graph(8, device="cpu"))
    noise = _reference_draws(1, T, (8, 250))
    got = ChipSim(prog, exec_mode="event", device="cpu").run(T, noise=noise)
    assert_records_match(got, want)
    dense = ChipSim(prog, exec_mode="dense", device="cpu").run(T,
                                                              noise=noise)
    assert_bitwise(got, dense)
    assert got["spikes_exc"].sum() > 0
    alone = snn.simulate_synfire(prog.graph.semantics.net, T, noise=noise,
                                 event=True)
    for k in alone:
        assert torch.equal(alone[k], got[k]), k


def test_empty_activity_ticks_are_bitwise():
    """48-PE shot-noise net, quiet between wave fronts, on the sparse NoC
    (event-mode accounting): ticks with no active source are covered."""
    T = 64
    sp, jsp = _sp()
    kw = dict(w_exc=0.25, noise_sigma=0.0, noise_model="shot")
    want = JChipSim(j_compile(j_synfire_graph(48, sp=jsp, **kw)),
                    noc_mode="sparse", exec_mode="event",
                    event_impl="gather").run(T)
    prog = compile(synfire_graph(48, sp=sp, device="cpu", **kw))
    sim = ChipSim(prog, noc_mode="sparse", exec_mode="event", device="cpu")
    got = sim.run(T)
    assert (got["active_sources"] == 0).any()
    assert got["link_load"].sum() > 0
    assert_records_match(got, want)
    assert_bitwise(got, sim.run(T, exec_mode="dense"))


def test_all_active_overflow_ticks_are_bitwise():
    """Dense Gaussian background drives every PE every tick: with more
    PEs than the event buffer holds, every tick overflows and the kernel
    covers all PEs, and the event NoC gathers every source."""
    T, n = 8, snn.EVENT_SRC_CAP + 8
    sp, jsp = _sp()
    kw = dict(w_exc=0.25, noise_sigma=2.0)
    want = JChipSim(j_compile(j_synfire_graph(n, sp=jsp, **kw)),
                    noc_mode="sparse", exec_mode="event",
                    event_impl="gather").run(T)
    prog = compile(synfire_graph(n, sp=sp, device="cpu", **kw))
    sim = ChipSim(prog, noc_mode="sparse", exec_mode="event", device="cpu")
    noise = _reference_draws(1, T, (n, 20))
    got = sim.run(T, noise=noise)
    assert (got["active_sources"] > snn.EVENT_SRC_CAP).any()
    assert_records_match(got, want)
    assert_bitwise(got, sim.run(T, noise=noise, exec_mode="dense"))


@pytest.mark.parametrize("src_cap,overflows", [(4, False), (2, True)])
def test_shot_overflow_falls_back_bitwise(src_cap, overflows):
    """The reference's 32-PE shot net with a tiny ``src_cap``: both sides
    of the device-side choice give the dense bits and the reference's
    event bits.  Its own cap of 4 never overflows (the largest input set
    of the run is 4 PEs); a cap of 2 overflows on some ticks and fits on
    others."""
    T = 48
    sp, jsp = _sp(n_pes=32)
    kw = dict(w_exc=0.25, noise_sigma=0.0, noise_model="shot",
              kicks_per_tick=3)
    jnet = jsnn.build_synfire(sp=jsp, **kw)
    net = snn.build_synfire(sp=sp, device="cpu", **kw)
    jtick = jsnn.make_synfire_tick(
        jnet, dvfs=JDVFS(jsp.l_th1, jsp.l_th2), em=JEnergy(),
        key=jax.random.PRNGKey(1), event=True, src_cap=src_cap)
    _, want = jax.lax.scan(jtick, jsnn.synfire_init_state(jnet),
                           jnp.arange(T))

    def run(**ev):
        tick = snn.make_synfire_tick(
            net, dvfs=DVFSController(sp.l_th1, sp.l_th2),
            em=PEEnergyModel(), seed=1, **ev)
        return snn.run_ticks(tick, snn.synfire_init_state(net), T)
    got = run(event=True, src_cap=src_cap)
    # the input set of each tick: arrivals, kicked PEs, the stimulated PE
    seed32, N = snn.shot_seed32(1), sp.neurons_per_core
    sizes = []
    for t in range(T):
        src = got["n_fifo"][t] > 0
        src[snn.shot_noise_lanes(seed32, t, 3, sp.n_pes * N, "cpu") // N] = 1
        src[0] |= t < net.stim_ticks
        sizes.append(int(src.sum()))
    assert min(sizes) <= src_cap and (max(sizes) > src_cap) == overflows
    assert_bitwise(got, run())
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        if k.startswith("e_"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("fits", [True, False])
def test_syn_accum_listed_pes(fits):
    """The event tick's ``syn_accum``: listed PEs get the reference
    einsum's rows and the rest zeros while the set fits; on overflow
    every PE's row is computed (the dense result)."""
    rng = np.random.default_rng(8)
    P, NE, NI, N = 90, 200, 50, 250
    exc = rng.integers(-2**31, 2**31, (P, 7), np.int64).astype(np.int32)
    inh = rng.integers(-2**31, 2**31, (P, 2), np.int64).astype(np.int32)
    w_ff = (rng.random((P, NE, N)) < 0.3).astype(np.int32) * 2458
    w_inh = (rng.random((P, NI, NE)) < 0.5).astype(np.int32) * -9830
    arr_e = jsnn.unpack_spikes(jnp.asarray(exc.view(np.uint32)), NE)
    arr_i = jsnn.unpack_spikes(jnp.asarray(inh.view(np.uint32)), NI)
    want = jnp.einsum("pe,pen->pn", arr_e, jnp.asarray(w_ff))
    want = np.asarray(want.at[:, :NE].add(
        jnp.einsum("pi,pie->pe", arr_i, jnp.asarray(w_inh))))
    listed = [0, 5, 17, 89]
    pes = _t(np.array(listed + [P] * 4, np.int32))
    got = syn_accum(_t(exc), _t(inh), _t(w_ff), _t(w_inh), pes,
                    torch.tensor(fits)).numpy()
    if not fits:
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(got[listed], want[listed])
    rest = np.setdiff1d(np.arange(P), listed)
    assert not got[rest].any() and want[rest].any()
