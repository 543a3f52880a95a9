"""The port's on-mesh learning (``repro_torch.learn``) against the JAX
reference's ``repro.learn``, on the CPU.

The rules on seeded inputs (s16.15 traces and STDP bitwise, PES at
rtol 1e-6), the lowering of plastic projections on a chip and a board
with the reference's errors, the engine's grouping of same-shape slots
(a 64-slot group equals its slots advanced one by one, and its step
dispatches as many torch ops as an 8-slot group's), and the two
workloads through ``compile`` / ``compile_board`` + ``ChipSim.run``: the
STDP pair with every record bitwise, and the adaptive-control loop at
the reference test's ``ADAPT_KW`` with its integer records bitwise
(spikes, traces, PLs, packets and link loads do not depend on the
decoders), decoders, u, y, track_err, dec_norm and dw at rtol 1e-5
(float32 sums in another order than XLA's) and energies at rtol 1e-6,
its convergence tick equal to the reference's on a chip and a 2x2 board.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.board import BoardSpec as JBoardSpec
from repro.board import compile_board as j_compile_board
from repro.chip.chip import ChipSim as JChipSim
from repro.chip.compile import compile as j_compile
from repro.learn import PES as JPES
from repro.learn import STDP as JSTDP
from repro.learn import rules as jrules
from repro.learn.adaptive import adaptive_control_graph as j_adaptive_graph
from repro.learn.adaptive import \
    adaptive_control_workload as j_adaptive_workload
from repro.learn.adaptive import stdp_pair_workload as j_stdp_pair_workload

from repro_torch.board import BoardSpec, compile_board
from repro_torch.chip import ChipSim, compile
from repro_torch.chip.graph import GRADED, NetGraph, Population, Projection
from repro_torch.chip.workloads import (adaptive_control_workload,
                                        stdp_pair_workload, synfire_graph)
from repro_torch.core.snn import build_synfire, simulate_synfire
from repro_torch.learn import (PES, STDP, LearnSlot, init_learn_state,
                               learn_state_from_numpy, lower_plasticity,
                               make_learn_step, pes_step, stdp_step_fx,
                               stdp_step_ref, trace_decay_fx,
                               trace_decays_fx, trace_step_fx, trace_to_hz)
from repro_torch.learn.adaptive import (adaptive_control_graph,
                                        convergence_tick)
from repro_torch.learn.engine import group_slots, learn_record_views
from repro_torch.obs.probes import ProbeSpec

FLOAT_RTOL, FLOAT_ATOL, ENERGY_RTOL = 1e-5, 1e-6, 1e-6
# the reference test's loop (tests/test_learn_rules.py)
ADAPT_KW = dict(n_channels=2, n_neurons=100, n_ticks=2048, period=2048)
# adaptive-control records that depend on the decoders: float32 sums
ADAPT_FLOAT = ("u", "y", "track_err", "dec_norm")


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_records(got, want, close=()):
    """Port records against the reference's: energies (``e_*``) at
    rtol 1e-6, ``close`` keys and every ``dw`` / ``err`` learn signal at
    rtol 1e-5, every other record bitwise (same dtype and shape)."""
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].cpu().numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.startswith("e_"):
            np.testing.assert_allclose(g, w, rtol=ENERGY_RTOL, atol=0,
                                       err_msg=k)
        elif k in close or k.endswith(("/dw", "/err")):
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL,
                                       atol=FLOAT_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


# ------------------------------------------------------------------ rules

@pytest.mark.parametrize("tau", [2.0, 20.0, 300.0])
def test_trace_step_fx_matches_reference_bitwise(tau):
    rng = np.random.default_rng(int(tau))
    tr = np.concatenate([rng.integers(-2**31, 2**31, 4096, np.int64),
                         rng.integers(0, 40 * 2**15, 4096)]).astype(np.int32)
    tr[:4] = [2**31 - 1, -2**31, 0, 2**31 - 2**15]
    spk = (rng.random(tr.size) < 0.3).astype(np.float32)
    d = trace_decay_fx(tau, device="cpu")
    assert d == int(jrules.trace_decay_fx(tau))
    got = trace_step_fx(_t(tr), _t(spk), d)
    want = jrules.trace_step_fx(jnp.asarray(tr), jnp.asarray(spk), tau)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        trace_to_hz(got, tau).numpy(),
        np.asarray(jrules.trace_to_hz(want, tau)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("rule_kw", [
    dict(), dict(w_min=0.1, w_max=0.9, tau_minus_ticks=35.0),
    # amplitudes past 1.0 take fx_mul's wrapping int64 path
    dict(a_plus=1.5, a_minus=1.2, w_min=-2.0, w_max=3.0)])
def test_stdp_step_fx_matches_reference_bitwise(rule_kw):
    """A (G, n_pre, n_post) batch through the port's step against the
    reference's per-slot step, for 40 ticks."""
    rng = np.random.default_rng(7)
    G, n_pre, n_post = 3, 12, 5
    rule, jrule = STDP(**rule_kw), JSTDP(**rule_kw)
    decays = trace_decays_fx([rule.tau_plus_ticks, rule.tau_minus_ticks],
                             device="cpu")
    w = rng.integers(int(rule.w_min * 2**15), int(rule.w_max * 2**15),
                     (G, n_pre, n_post)).astype(np.int32)
    pt = np.zeros((G, n_pre), np.int32)
    qt = np.zeros((G, n_post), np.int32)
    jstate = [(jnp.asarray(w[g]), jnp.asarray(pt[g]), jnp.asarray(qt[g]))
              for g in range(G)]
    state = (_t(w), _t(pt), _t(qt))
    for _ in range(40):
        pre = (rng.random((G, n_pre)) < 0.3).astype(np.float32)
        post = (rng.random((G, n_post)) < 0.3).astype(np.float32)
        state = stdp_step_fx(*state, _t(pre), _t(post), rule, decays)
        jstate = [jrules.stdp_step_fx(*jstate[g], jnp.asarray(pre[g]),
                                      jnp.asarray(post[g]), jrule)
                  for g in range(G)]
    for i, got in enumerate(state):
        np.testing.assert_array_equal(
            got.numpy(), np.stack([np.asarray(s[i]) for s in jstate]))


def test_stdp_step_ref_and_pes_step_match_reference():
    rng = np.random.default_rng(3)
    rule, jrule = STDP(), JSTDP()
    w = rng.random((12, 5)).astype(np.float32)
    pt, qt = rng.random(12).astype(np.float32), rng.random(5).astype(
        np.float32)
    pre = (rng.random(12) < 0.4).astype(np.float32)
    post = (rng.random(5) < 0.4).astype(np.float32)
    got = stdp_step_ref(_t(w), _t(pt), _t(qt), _t(pre), _t(post), rule)
    want = jrules.stdp_step_ref(*(jnp.asarray(a) for a in
                                  (w, pt, qt, pre, post)), jrule)
    for g, v in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=1e-6)
    dec = rng.standard_normal((64, 3)).astype(np.float32)
    act = (rng.random(64) * 300).astype(np.float32)
    err = rng.standard_normal(3).astype(np.float32)
    got = pes_step(_t(dec), _t(act), _t(err), PES(learning_rate=3e-4), 64)
    want = jrules.pes_step(jnp.asarray(dec), jnp.asarray(act),
                           jnp.asarray(err), JPES(learning_rate=3e-4), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    zero = pes_step(_t(dec), _t(act), torch.zeros(3), PES(), 64)
    assert torch.equal(zero, _t(dec))             # an exact fixed point


# --------------------------------------------------------------- lowering

def _slot_fields(slots):
    return [(s.name, s.kind, type(s.rule).__name__, s.src, s.dst, s.n_pre,
             s.n_post, s.pe_ids) for s in slots]


def test_lowering_matches_reference_on_chip_and_board():
    kw = dict(ADAPT_KW, n_channels=6, n_ticks=8)
    g = adaptive_control_graph(device="cpu", **kw)
    jg = j_adaptive_graph(**kw)
    chip, jchip = compile(g), j_compile(jg)
    assert _slot_fields(chip.learn_slots) == _slot_fields(jchip.learn_slots)
    assert chip.learn_slots[0].rule == PES(learning_rate=3e-6)
    board = compile_board(g, BoardSpec.parse("2x2", chip="2x1"),
                          refine=False)
    jboard = j_compile_board(jg, JBoardSpec.parse("2x2", chip="2x1"),
                             refine=False)
    assert _slot_fields(board.learn_slots) == _slot_fields(
        jboard.learn_slots)
    one = compile_board(g, BoardSpec(1, 1, chip=chip.mesh))
    assert one.learn_slots == chip.learn_slots
    frozen = adaptive_control_graph(plastic=False, device="cpu", **kw)
    assert compile(frozen).learn_slots == ()
    assert lower_plasticity(synfire_graph(8, device="cpu"), {}) == ()


def test_lowering_rejects_rule_payload_mismatch():
    pops = [Population("a", 8, 64), Population("b", 8, 64)]
    cases = [(Projection("a", "b", payload=GRADED, bits_per_packet=32,
                         plasticity=STDP()), "a->b: STDP needs a SPIKE"),
             (Projection("a", "b", plasticity=PES()),
              "a->b: PES needs a GRADED"),
             (Projection("a", "b", plasticity="nope"),
              "a->b: unknown plasticity rule")]
    for proj, match in cases:
        g = NetGraph(pops, [proj], semantics=object())
        with pytest.raises(ValueError, match=match):
            compile(g)
        with pytest.raises(ValueError, match=match):
            compile_board(g, BoardSpec(1, 1))


# ---------------------------------------------------------------- grouping

class _Program:
    def __init__(self, slots, n_pes=8):
        self.learn_slots = tuple(slots)
        self.n_pes = n_pes


def _pes_slots(n, n_pre=16, n_post=2, tiles=1):
    rule = PES(learning_rate=1e-4)
    return [LearnSlot(f"s{i}", "pes", rule, f"a{i}", f"b{i}", n_pre, n_post,
                      tuple((i + j) % 8 for j in range(tiles)))
            for i in range(n)]


def _stdp_slots(n, n_pre=12, n_post=4, tiles=1):
    return [LearnSlot(f"t{i}", "stdp", STDP(), f"a{i}", f"b{i}", n_pre,
                      n_post, tuple((i + j) % 8 for j in range(tiles)))
            for i in range(n)]


def _signals(slots, seed, state, rows=slice(None)):
    """One tick's learn signals of ``slots[rows]``, one group of
    ``state``, as the engine reads them: one (G, ...) record a signal."""
    rng = np.random.default_rng(seed)
    pre = (rng.random((len(slots), slots[0].n_pre)) < 0.3).astype(
        np.float32)
    if slots[0].kind == "pes":
        other = ("err", rng.standard_normal((len(slots), slots[0].n_post))
                 .astype(np.float32))
        other[1][::5] = 0.0                  # zero-error slots: no update
    else:
        other = ("post", (rng.random((len(slots), slots[0].n_post)) < 0.3)
                 .astype(np.float32))
    names = [s.name for s in slots[rows]]
    return {state.signal_key(names, "pre"): _t(pre[rows]),
            state.signal_key(names, other[0]): _t(other[1][rows])}


def _dw_key(slots):
    """The record key of a group's (G,) dw."""
    return learn_record_views([slots])[f"learn/{slots[0].name}/dw"][0]


def test_grouping_by_kind_rule_and_shape_in_program_order():
    a, b = _pes_slots(3), _stdp_slots(2)
    c = _pes_slots(2, n_pre=5)
    d = [LearnSlot("lr", "pes", PES(learning_rate=9e-9), "x", "y", 16, 2,
                   (0,))]
    groups = group_slots(a + b + c + d)
    assert [[s.name for s in g] for g in groups] == [
        [s.name for s in a], [s.name for s in b], [s.name for s in c], ["lr"]]


@pytest.mark.parametrize("mk", [_pes_slots, _stdp_slots],
                         ids=["pes", "stdp"])
def test_64_slot_group_matches_slots_one_by_one(mk):
    """A 64-slot group advanced together, from stacked signals, equals
    each slot advanced as a group of one, bitwise, over 5 ticks; its
    e_learn (two tiles a slot) equals the per-slot sum."""
    slots = mk(64, tiles=2)
    prog = _Program(slots)
    state = init_learn_state(prog, "cpu")
    solo = {s.name: init_learn_state(_Program([s]), "cpu") for s in slots}
    steps = {s.name: make_learn_step(_Program([s]), "cpu") for s in slots}
    step = make_learn_step(prog, "cpu")
    for t in range(5):
        state, upd = step(state, _signals(slots, t, state))
        assert set(upd) == {"e_learn", _dw_key(slots)}
        e_sum = np.zeros(8)
        for i, s in enumerate(slots):
            solo[s.name], s_upd = steps[s.name](
                solo[s.name],
                _signals(slots, t, solo[s.name], slice(i, i + 1)))
            for k, v in solo[s.name][s.name].items():
                assert torch.equal(state[s.name][k], v), (t, s.name, k)
            assert torch.equal(upd[_dw_key(slots)][i],
                               s_upd[_dw_key([s])][0])
            e_sum += s_upd["e_learn"].double().numpy()
        np.testing.assert_allclose(upd["e_learn"].numpy(), e_sum, rtol=1e-6)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mk", [_pes_slots, _stdp_slots],
                         ids=["pes", "stdp"])
def test_group_step_cost_does_not_grow_with_slots(mk):
    """The port's stand-in for the reference's trace-size gate: a tick of
    a 64-slot group dispatches exactly as many torch ops, and returns as
    many records, as a tick of an 8-slot group (no per-slot unroll), and
    the decays cost no fx_exp in the tick."""
    counts = {}
    for n in (8, 64):
        slots = mk(n)
        prog = _Program(slots)
        state = init_learn_state(prog, "cpu")
        step = make_learn_step(prog, "cpu")
        rec = _signals(slots, 0, state)
        with _OpCount() as ops:
            _, upd = step(state, rec)
        counts[n] = (ops.n, len(upd))
    assert counts[8] == counts[64], counts


# -------------------------------------------------------------- workloads

def test_stdp_pair_records_bitwise():
    rule, jrule = (STDP(w_min=0.1, w_max=0.9, w_init=0.5),
                   JSTDP(w_min=0.1, w_max=0.9, w_init=0.5))
    kw = dict(n_pre=16, n_post=4, n_ticks=256)
    rep = stdp_pair_workload(rule=rule, device="cpu", **kw)
    jrep = j_stdp_pair_workload(rule=jrule, **kw)
    assert_records(rep["recs"], jrep["recs"])
    assert rep["w_mean_last"] != rep["w_mean_first"]
    assert rep["post_spikes"] > 0 and rep["e_learn_j"] > 0
    for k in ("w_mean_first", "w_mean_last", "post_spikes", "e_learn_j",
              "learn_energy_frac"):
        assert rep[k] == pytest.approx(jrep[k], rel=1e-6), k
    assert rep["table"]["learn"]["energy_frac"] > 0


@pytest.fixture(scope="module")
def adaptive_runs():
    """The reference test's loop on one chip, through both packages."""
    return (adaptive_control_workload(device="cpu", err_window=64,
                                      **ADAPT_KW),
            j_adaptive_workload(err_window=64, **ADAPT_KW))


def _check_converged(rep):
    assert rep["convergence_tick"] >= 0
    assert rep["final_err"] < 0.1 and rep["dec_norm"] > 0
    e_l = rep["recs"]["e_learn"].numpy()
    assert (e_l >= 0).all() and e_l.sum() > 0
    # e_learn is charged exactly to the decoder-owning (nef) PEs
    prog = rep["program"]
    owners = sorted({pe for s in prog.learn_slots for pe in s.pe_ids})
    assert sorted(np.flatnonzero(e_l.sum(axis=0) > 0)) == owners
    assert rep["table"]["learn"]["energy_j"] == pytest.approx(
        float(e_l.sum()))


def test_adaptive_control_matches_reference_on_chip(adaptive_runs):
    rep, jrep = adaptive_runs
    assert_records(rep["recs"], jrep["recs"], close=ADAPT_FLOAT)
    _check_converged(rep)
    assert rep["convergence_tick"] == jrep["convergence_tick"]
    for k in ("final_err", "initial_err", "dec_norm"):
        assert rep[k] == pytest.approx(jrep[k], rel=FLOAT_RTOL), k
    for k in ("e_learn_j", "learn_energy_frac"):
        assert rep[k] == pytest.approx(jrep[k], rel=ENERGY_RTOL), k
    assert convergence_tick(rep["recs"]["track_err"].numpy(), 0.1, 64) \
        == rep["convergence_tick"]


def test_adaptive_control_converges_on_2x2_board():
    """The same graph through compile_board, 6 channels over 2x1-QPE
    chips with the greedy partition: loops cross chips, and the port
    converges at the reference's tick."""
    kw = dict(ADAPT_KW, n_channels=6, refine=False, err_window=64)
    rep = adaptive_control_workload(
        board=BoardSpec.parse("2x2", chip="2x1"), device="cpu", **kw)
    jrep = j_adaptive_workload(board=JBoardSpec.parse("2x2", chip="2x1"),
                               **kw)
    _check_converged(rep)
    assert float(rep["recs"]["flits_xchip"].sum()) > 0
    assert rep["convergence_tick"] == jrep["convergence_tick"]
    assert_records(rep["recs"], jrep["recs"], close=ADAPT_FLOAT)


def test_adaptive_board_matches_chip_records():
    """One chip and a 1x1 board of the same plastic graph: the same
    records, learning included, bit for bit."""
    kw = dict(ADAPT_KW, n_ticks=256)
    g = adaptive_control_graph(device="cpu", **kw)
    prog_c = compile(g)
    prog_b = compile_board(g, BoardSpec(1, 1, chip=prog_c.mesh))
    rc = ChipSim(prog_c, device="cpu").run(256)
    rb = ChipSim(prog_b, device="cpu").run(256)
    assert set(rc) == set(rb)
    for k in rc:
        assert torch.equal(rc[k], rb[k]), k


def test_run_continues_from_a_stepper_state():
    """``run(state=, start=)`` from a stepper's state at tick 40 gives
    ticks 40-95 of the whole run, the per-slot learn records and probes
    included, bit for bit."""
    kw = dict(ADAPT_KW, n_ticks=96)
    sim = ChipSim(compile(adaptive_control_graph(device="cpu", **kw)),
                  device="cpu")
    probe = (ProbeSpec("dw", "learn/nef1->plant1/dw", "sum", 16),)
    whole = sim.run(96)
    state, step = sim.make_stepper()
    for t in range(40):
        state, _ = step(state, t)
    rest = sim.run(56, state=state, start=40, probes=probe)
    assert set(rest) == set(whole) | {"probes"}
    for k, v in whole.items():
        assert torch.equal(rest[k], v[40:]), k
    dw, want = whole["learn/nef1->plant1/dw"], []
    for w0 in range(40, 96, 16):         # windows of the continued run
        acc = dw[w0]
        for t in range(w0 + 1, min(w0 + 16, 96)):
            acc = acc + dw[t]
        want.append(acc)
    assert torch.equal(rest["probes"]["dw"], torch.stack(want))


def test_carried_learn_state_runs_like_the_reference():
    """Mid-run learn states agree after 128 ticks of each stepper; then
    both continue 128 ticks from the reference's decoders and traces,
    carried across with ``learn_state_from_numpy``."""
    kw = dict(ADAPT_KW, n_ticks=256)
    prog = compile(adaptive_control_graph(device="cpu", **kw))
    jprog = j_compile(j_adaptive_graph(**kw))
    state, step = ChipSim(prog, device="cpu").make_stepper()
    jstate, jstep = JChipSim(jprog).make_stepper()
    jstep = jax.jit(jstep)
    for t in range(128):
        state, _ = step(state, t)
        jstate, _ = jstep(jstate, jnp.int32(t))
    jlearn = jax.tree_util.tree_map(np.asarray, jstate["learn"])
    got = state["learn"].numpy()
    assert set(got) == set(jlearn)
    for name, arrays in jlearn.items():
        np.testing.assert_array_equal(got[name]["tr"], arrays["tr"])
        np.testing.assert_allclose(got[name]["w"], arrays["w"],
                                   rtol=FLOAT_RTOL, atol=1e-9)
    # continue both from the reference's state
    carried = {k: torch.from_numpy(np.array(v)) for k, v in
               jax.tree_util.tree_map(np.asarray, jstate).items()
               if k != "learn"}
    carried["learn"] = learn_state_from_numpy(jlearn, prog, "cpu")
    want, got = [], []
    for t in range(128, 256):
        carried, rec = step(carried, t)
        jstate, jrec = jstep(jstate, jnp.int32(t))
        got.append(rec["u"].numpy().copy())
        want.append(np.asarray(jrec["u"]))
    np.testing.assert_allclose(np.array(got), np.array(want),
                               rtol=FLOAT_RTOL, atol=FLOAT_ATOL)


def test_plastic_semantics_must_carry_learn_state():
    g = adaptive_control_graph(device="cpu", **dict(ADAPT_KW, n_ticks=8))
    g.semantics.plastic = False        # builds state without "learn"
    with pytest.raises(ValueError, match="'learn' subtree"):
        ChipSim(compile(g), device="cpu").run(4)


# ----------------------------------------------------------- frozen graphs

def test_frozen_graphs_run_as_before():
    """No plasticity: no learn slots, no e_learn, the 8-PE synfire still
    ``simulate_synfire`` bit for bit, and the frozen adaptive twin equal
    to the reference's."""
    prog = compile(synfire_graph(8, seed=0, device="cpu"))
    assert prog.learn_slots == ()
    recs = ChipSim(prog, device="cpu").run(200)
    assert "e_learn" not in recs
    ref = simulate_synfire(build_synfire(0, device="cpu"), 200)
    for k in ref:
        assert torch.equal(recs[k], ref[k]), k
    kw = dict(ADAPT_KW, n_ticks=256, plastic=False)
    frozen = ChipSim(compile(adaptive_control_graph(device="cpu", **kw)),
                     device="cpu").run(256)
    jfrozen = JChipSim(j_compile(j_adaptive_graph(**kw))).run(256)
    assert "e_learn" not in frozen
    assert_records(frozen, jfrozen, close=ADAPT_FLOAT)
