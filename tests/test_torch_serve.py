"""The port's serving tier (``repro_torch.serve``, ``repro_torch.ckpt``,
``QueueDVFS``, the batched step and probes) against the JAX reference's
``repro.serve``, on the CPU.

At the reference tests' sizes (tests/test_serve_fleet.py: adaptive 1 x
32 with rounds of 32 ticks, KWS 2 x 32 with 8 hidden units, a 2x1 board
of 2x2 chips with 2 channels of 24):

* the host parts (queue, percentiles, ``select_width``, ``SessionTable``,
  ``PoissonTraffic``, ``QueueDVFS``) give the reference's results;
* the batched probe fold equals the reference's per-instance folds and
  its batched fold bitwise, for every (op, stride) of the reference's
  test; the batched learn step and NoC accounting equal their unbatched
  forms and issue as many ops at any width;
* a fleet of one is bitwise equal to the port's ``ChipSim.run``;
* on the traffic of three reference tests the port's fleet has the
  reference's schedule exactly (completed, rounds, widths, preemptions,
  ticks served and run), and every session's outputs hold: ``r`` and
  ``n_spk`` bitwise, ``u``, ``y``, ``track_err`` and ``hidden_out`` at
  rtol 1e-5 (atol 1e-6; float32 sums over the decoders and the hidden
  product in another order than XLA's), ``energy_j`` at rtol 1e-6;
* preemption is invisible (rtol 3e-6, atol 1e-7, the reference test's:
  the width changes the batched float sums), suspend and restore across
  engines bitwise, and a session the reference's engine checkpointed
  finishes in the port's equal to the reference's uninterrupted run;
* ``CheckpointManager`` round trips, keeps, publishes and reads the
  reference's checkpoints; ``python -m repro_torch.launch.fleet``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager
from repro.core.dvfs import QueueDVFS as JQueueDVFS
from repro.core.hybrid import frame_mac_energy_j as j_frame_mac_energy_j
from repro.obs import ProbeSpec as JProbeSpec
from repro.obs.metrics import DeviceMetricSpec as JDeviceMetricSpec
from repro.obs.metrics import make_device_metrics as j_make_device_metrics
from repro.obs.probes import make_batched_probe_step as j_batched_probe
from repro.obs.probes import make_probe_step as j_probe_step
from repro.serve.fleet import FleetEngine as JFleetEngine
from repro.serve.fleet import PoissonTraffic as JPoissonTraffic
from repro.serve.fleet import Session as JSession
from repro.serve.fleet import SessionTable as JSessionTable
from repro.serve.fleet import adaptive_scenario as j_adaptive_scenario
from repro.serve.fleet import kws_scenario as j_kws_scenario
from repro.serve.queue import RequestQueue as JRequestQueue
from repro.serve.queue import percentiles as j_percentiles
from repro.serve.queue import select_width as j_select_width

from repro_torch.board import BoardSpec
from repro_torch.chip import ChipSim, compile
from repro_torch.chip.workloads import hybrid_farm_graph
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.dvfs import QueueDVFS
from repro_torch.core.hybrid import frame_mac_energy_j
from repro_torch.kernels.link_load.ops import noc_link_loads
from repro_torch.learn.engine import make_learn_step
from repro_torch.launch.fleet import main as fleet_main
from repro_torch.obs import ProbeSpec
from repro_torch.obs.metrics import DeviceMetricSpec, make_device_metrics
from repro_torch.obs.probes import make_batched_probe_step, make_probe_step
from repro_torch.serve import RequestQueue, percentiles, select_width
from repro_torch.serve.fleet import (FleetEngine, PoissonTraffic, Session,
                                     SessionTable, adaptive_scenario,
                                     kws_scenario, stim_windows)
from repro_torch.serve.fleet.engine import broadcast_state

TC = 32
FLOAT_RTOL, FLOAT_ATOL, ENERGY_RTOL = 1e-5, 1e-6, 1e-6
EXACT = ("r", "n_spk")
# the traffic of three reference tests (tests/test_serve_fleet.py):
# scenario, scenario kwargs, engine kwargs (dvfs thresholds, levels,
# board), traffic kwargs
FLEETS = {
    "width_follows_queue_depth": (
        "adaptive", dict(n_neurons=32), ((3, 6), (2, 4, 8), None),
        dict(rate=8.0, n_sessions=8, seed=0, tick_range=(2 * TC, 4 * TC))),
    "kws_fleet_end_to_end": (
        "kws", dict(n_pairs=2, n_neurons=32, hidden=8, n_keywords=3),
        ((2, 5), (2, 4, 8), None),
        dict(rate=2.0, n_sessions=6, seed=3, tick_range=(TC, 3 * TC))),
    "board_fleet_smoke": (
        "adaptive", dict(n_channels=2, n_neurons=24), ((2,), (1, 2), "2x1"),
        dict(rate=1.0, n_sessions=2, seed=1, tick_range=(TC, 2 * TC))),
}


@pytest.fixture(scope="module")
def sc():
    return adaptive_scenario(n_neurons=32, device="cpu")


@pytest.fixture(scope="module")
def j_sc():
    return j_adaptive_scenario(n_neurons=32)


def _solo(sc, seed, total, **kw):
    """Uninterrupted single-session run (a width-1 fleet)."""
    eng = FleetEngine(sc, round_ticks=TC, capacity=1, device="cpu",
                      dvfs=QueueDVFS(thresholds=(2,), batch_levels=(1, 1)),
                      **kw)
    s = Session(sid=0, stream=sc.stream(seed), total_ticks=total)
    return eng.serve(None, sessions=[s])["sessions"][0]


def _j_solo(j_sc, seed, total):
    eng = JFleetEngine(j_sc, round_ticks=TC, capacity=1,
                       dvfs=JQueueDVFS(thresholds=(2,), batch_levels=(1, 1)))
    s = JSession(sid=0, stream=j_sc.stream(seed), total_ticks=total)
    return eng.serve(None, sessions=[s])["sessions"][0]


def assert_outputs(got: dict, want: dict, keys, exact=EXACT):
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL,
                                       atol=FLOAT_ATOL, err_msg=k)


# ------------------------------------------------------------ host parts

def _queue_trace(q):
    q.extend(["a", "b", "c"])
    q.submit("p", front=True)
    out = [len(q), q.depth, q.take(2), q.peek_depth_with(3), q.take(10),
           bool(q)]
    st = q.stats()
    return out, {k: st[k] for k in ("submitted", "taken", "waiting")}


def test_request_queue_matches_reference():
    assert _queue_trace(RequestQueue()) == _queue_trace(JRequestQueue())
    assert RequestQueue().stats() == JRequestQueue().stats()


@pytest.mark.parametrize("samples,ps", [
    ([], (50, 99)), (list(range(100)), (50, 99)), ([7.5], (50, 99)),
    ([None, 3.0, None], (50, 99)), ([None, None], (50, 99)),
    ([None, 1.0, 2.0], (0, 50, 100)),
    (list(np.random.default_rng(3).exponential(2.0, 57)), (10, 50, 90, 99)),
])
def test_percentiles_match_reference(samples, ps):
    assert percentiles(samples, ps) == j_percentiles(samples, ps)


@pytest.mark.parametrize("waiting,in_flight,capacity", [
    (w, f, c) for w in (0, 2, 3, 4, 15, 16) for f in (0, 1, 2, 4, 20)
    for c in (None, 12)])
def test_select_width_matches_reference(waiting, in_flight, capacity):
    dvfs = dict(thresholds=(4, 16), batch_levels=(8, 32, 128))
    q, jq = RequestQueue(), JRequestQueue()
    q.extend(range(waiting))
    jq.extend(range(waiting))
    assert select_width(QueueDVFS(**dvfs), q, in_flight, capacity) == \
        j_select_width(JQueueDVFS(**dvfs), jq, in_flight, capacity)


@pytest.mark.parametrize("depth", range(0, 40, 3))
def test_queue_dvfs_matches_reference(depth):
    for kw in ({}, dict(thresholds=(3,), batch_levels=(1, 4)),
               dict(thresholds=(8, 16), batch_levels=(16, 32, 64))):
        a, b = QueueDVFS(**kw), JQueueDVFS(**kw)
        assert a.select_level(depth) == b.select_level(depth)
        assert a.batch_size(depth) == b.batch_size(depth)


def test_session_table_matches_reference():
    def trace(table_cls, session_cls):
        t = table_cls(capacity=4)
        ss = [session_cls(sid=i, stream=None, total_ticks=1)
              for i in range(4)]
        out = [t.admit(s) for s in ss]
        with pytest.raises(RuntimeError):
            t.admit(session_cls(sid=9, stream=None, total_ticks=1))
        for slot in (0, 2, 1):
            ev, moved = t.evict(slot)
            out.append((ev.sid, moved, [s.sid for s in t.slots]))
        out.append(t.evict_tail().sid)
        return out + [t.n_active, len(t)]
    assert trace(SessionTable, Session) == trace(JSessionTable, JSession)


@pytest.mark.parametrize("rate,n,seed,ticks,quantum", [
    (2.0, 9, 5, (128, 384), 1), (8.0, 96, 0, (128, 384), 1),
    (8.0, 96, 1, (128, 384), 1), (8.0, 12, 2, (128, 384), 1),
    (0.5, 7, 11, (32, 96), 32), (10.0, 3, 2, (1, 1), 1)])
def test_poisson_traffic_matches_reference(rate, n, seed, ticks, quantum):
    kw = dict(rate=rate, n_sessions=n, seed=seed, tick_range=ticks,
              tick_quantum=quantum)
    a, b = PoissonTraffic(**kw), JPoissonTraffic(**kw)
    polls = []
    while not a.exhausted:
        got, want = a.poll(), b.poll()
        assert [(s.sid, s.seed, s.total_ticks) for s in got] == \
            [(s.sid, s.seed, s.total_ticks) for s in want]
        polls.append(len(got))
    assert b.exhausted and a.poll() == [] and sum(polls) == n


def test_frame_mac_energy_matches_reference():
    for t, k, n in ((1, 64, 64), (600, 256, 64), (7, 3, 5)):
        assert frame_mac_energy_j(t, k, n) == j_frame_mac_energy_j(t, k, n)


# ------------------------------------------------- batched building blocks

@pytest.mark.parametrize("op,stride", [("peak", 8), ("mean", 8), ("sum", 5),
                                       ("last", 8), ("ema", None)])
def test_batched_probe_step_equals_per_instance(op, stride):
    """The reference test's batched fold (3 instances at local ticks
    offset 0, 5 and 17, 14 steps, a 24-tick probe horizon) against the
    reference's per-instance folds and its batched fold, bitwise; the
    instance that starts at tick 0 also against the port's unbatched
    fold (which takes every run to start at tick 0)."""
    batch, n_ticks, n_steps = 3, 24, 14
    offs = np.asarray([0, 5, 17], np.int32)
    rng = np.random.default_rng(9)
    sig = rng.uniform(0.0, 8.0, (batch, n_steps, 4)).astype(np.float32)
    specs = (ProbeSpec("p", "sig", op, stride=stride, alpha=0.25),)
    j_specs = (JProbeSpec("p", "sig", op, stride=stride, alpha=0.25),)
    shapes = {"sig": jax.ShapeDtypeStruct((4,), jnp.float32)}

    obs, step, fin = make_batched_probe_step(specs, {"sig": (4,)}, n_ticks,
                                             batch, device="cpu")
    for j in range(n_steps):
        obs = step(obs, {"sig": torch.from_numpy(sig[:, j])},
                   torch.from_numpy(offs + j))
    got = fin(obs)["p"].numpy()

    binit, bstep, bfin = j_batched_probe(j_specs, shapes, n_ticks, batch)
    jobs = binit
    for j in range(n_steps):
        jobs = bstep(jobs, {"sig": jnp.asarray(sig[:, j])},
                     jnp.asarray(offs + j))
    np.testing.assert_array_equal(got, np.asarray(bfin(jobs)["p"]))
    init, jstep, jfin = j_probe_step(j_specs, shapes, n_ticks)
    for i in range(batch):
        o = init
        for j in range(n_steps):
            o = jstep(o, {"sig": jnp.asarray(sig[i, j])},
                      jnp.int32(int(offs[i]) + j))
        np.testing.assert_array_equal(got[i], np.asarray(jfin(o)["p"]))
    pobs, pstep, pfin = make_probe_step(specs, {"sig": torch.zeros(4)},
                                        n_ticks)
    for j in range(n_steps):
        pobs = pstep(pobs, {"sig": torch.from_numpy(sig[0, j])}, j)
    np.testing.assert_array_equal(got[0], pfin(pobs)["p"].numpy())


def test_device_metrics_match_reference():
    specs = (DeviceMetricSpec("spk", "n_spk", "sum"),
             DeviceMetricSpec("pl", "pl", "peak"),
             DeviceMetricSpec("pk", "packets", "sum"))
    j_specs = (JDeviceMetricSpec("spk", "n_spk", "sum"),
               JDeviceMetricSpec("pl", "pl", "peak"),
               JDeviceMetricSpec("pk", "packets", "sum"))
    W, T, P = 3, 5, 4
    rng = np.random.default_rng(0)
    recs = {"n_spk": rng.integers(0, 9, (T, W)).astype(np.float32),
            "pl": rng.integers(0, 4, (T, W, P)).astype(np.int32),
            "packets": rng.uniform(0, 3, (T, W, P)).astype(np.float32)}
    met, step = make_device_metrics(specs, W, device="cpu")
    jmet, jstep = j_make_device_metrics(j_specs, W)
    for t in range(T):
        met = step(met, {k: torch.from_numpy(v[t]) for k, v in recs.items()})
        jmet = jstep(jmet, {k: jnp.asarray(v[t]) for k, v in recs.items()})
    for k in ("spk", "pl", "pk"):
        np.testing.assert_array_equal(met[k].numpy(), np.asarray(jmet[k]))
    with pytest.raises(ValueError, match="unknown op"):
        DeviceMetricSpec("x", "n_spk", "mean")


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_batched_learn_step_equals_unbatched(sc):
    """A fleet's learn step over (w, G, ...) stacks equals each
    instance's own step bitwise, and dispatches as many torch ops at
    width 8 as at width 1 and as the unbatched step."""
    prog = compile(sc.graph(TC))
    step = make_learn_step(prog, "cpu")
    init = prog.init_state("cpu")["learn"]
    names = tuple(s.name for s in prog.learn_slots)
    rng = np.random.default_rng(4)
    ops = {}
    for w in (1, 8):
        lstate = broadcast_state(init, w)
        pre = torch.from_numpy((rng.random((w, 1, 32)) < 0.3)
                               .astype(np.float32))
        err = torch.from_numpy(rng.normal(0, 0.5, (w, 1, 1))
                               .astype(np.float32))
        rec = {lstate.signal_key(names, "pre"): pre,
               lstate.signal_key(names, "err"): err}
        with _OpCount() as count:
            got, upd = step(lstate, rec)
        ops[w] = count.n
        for i in range(w):
            one = {k: v[i] for k, v in rec.items()}
            want, wupd = step(init, one)
            for k in ("w", "tr"):
                assert torch.equal(got.stacks[0][k][i], want.stacks[0][k])
            for k, v in wupd.items():
                assert torch.equal(upd[k][i], v), k
    one = {k: v[0] for k, v in rec.items()}
    with _OpCount() as count:
        step(init, one)
    assert ops[1] == ops[8] == count.n, (ops, count.n)


@pytest.mark.parametrize("fan_in", ["padded", "csc"])
def test_noc_link_loads_rows_of_a_fleet(fan_in):
    """(w, P) packets with static (P,) or per-instance (w, P) flits give
    each instance's own link and flit loads, bitwise (the plain version
    here; the card sends the 2w rows through one launch)."""
    graph = hybrid_farm_graph(8, n_neurons=8, hidden=4, n_ticks=8,
                              device="cpu")
    prog = compile(graph)
    sinc = prog.sinc
    if fan_in == "padded":
        plan = (torch.as_tensor(sinc.link_major), None)
    else:
        src, ptr = sinc.csc
        plan = (torch.as_tensor(src.astype(np.int32)),
                torch.as_tensor(ptr.astype(np.int32)))
    rng = np.random.default_rng(1)
    P, w = prog.n_pes, 5
    packets = torch.from_numpy(rng.integers(0, 4, (w, P)).astype(np.float32))
    for flits in (torch.from_numpy(rng.integers(1, 5, P)
                                   .astype(np.float32)),
                  torch.from_numpy(rng.integers(1, 5, (w, P))
                                   .astype(np.float32))):
        both = noc_link_loads(packets, flits, *plan, n_links=sinc.n_links)
        assert both.shape == (2, w, sinc.n_links)
        for i in range(w):
            one = noc_link_loads(packets[i], flits if flits.dim() == 1
                                 else flits[i], *plan, n_links=sinc.n_links)
            assert torch.equal(both[:, i], one)


def test_batched_stepper_needs_served_semantics():
    graph = hybrid_farm_graph(2, n_neurons=8, hidden=4, n_ticks=8,
                              device="cpu")
    with pytest.raises(ValueError, match="HybridFarmSemantics.*no batched"):
        ChipSim(compile(graph), device="cpu").make_batched_stepper()


def test_stim_windows_match_reference(sc, j_sc):
    """Streams draw the reference's signals; a stack of windows encodes
    bitwise as each window alone and as the reference's encoding."""
    streams = [sc.stream(s) for s in (3, 40, 41)]
    j_streams = [j_sc.stream(s) for s in (3, 40, 41)]
    sig = np.stack([s.signal(32 * i, TC) for i, s in enumerate(streams)])
    win = stim_windows(sc.ens, sig)
    for i, (s, js) in enumerate(zip(streams, j_streams)):
        seg, jseg = s.segment(32 * i, TC), js.segment(32 * i, TC)
        np.testing.assert_array_equal(sig[i], jseg["r"])
        assert torch.equal(win["drive"][i], seg["drive"])
        np.testing.assert_array_equal(seg["drive"].numpy(), jseg["drive"])
    kws, j_kws = (kws_scenario(n_pairs=2, n_neurons=32, hidden=8,
                               n_keywords=3, device="cpu"),
                  j_kws_scenario(n_pairs=2, n_neurons=32, hidden=8,
                                 n_keywords=3))
    for seed in (0, 1, 7):
        a, b = kws.stream(seed), j_kws.stream(seed)
        assert (a.keyword, a.amp, a.period, a.phase) == \
            (b.keyword, b.amp, b.period, b.phase)


# ---------------------------------------------------------- the fleet

@pytest.mark.parametrize("kind", ["adaptive", "kws"])
def test_fleet_of_one_bitwise_matches_chipsim(kind, sc):
    """A width-1 fleet's streamed outputs equal ``ChipSim.run`` of the
    same program with the whole stimulus preloaded, bitwise."""
    if kind == "kws":
        sc = kws_scenario(n_pairs=2, n_neurons=32, hidden=8, device="cpu")
    T = 3 * TC
    sess = _solo(sc, 41, T)
    recs = ChipSim(compile(sc.graph(T, sc.stream(41).segment(0, T))),
                   device="cpu").run(T)
    for k in sc.output_keys:
        np.testing.assert_array_equal(sess.outputs[k], recs[k].numpy())


def _serve_pair(name):
    kind, sc_kw, (thr, levels, board), tr_kw = FLEETS[name]
    make = {"adaptive": (adaptive_scenario, j_adaptive_scenario),
            "kws": (kws_scenario, j_kws_scenario)}[kind]
    sc, j_sc = make[0](device="cpu", **sc_kw), make[1](**sc_kw)
    kw, j_kw = {}, {}
    if board is not None:
        from repro.board import BoardSpec as JBoardSpec
        kw["board"] = BoardSpec.parse(board, chip="2x2")
        j_kw["board"] = JBoardSpec.parse(board, chip="2x2")
        kw["refine"] = j_kw["refine"] = False
    out = FleetEngine(sc, round_ticks=TC, device="cpu",
                      dvfs=QueueDVFS(thresholds=thr, batch_levels=levels),
                      **kw).serve(PoissonTraffic(**tr_kw))
    j_out = JFleetEngine(j_sc, round_ticks=TC, dvfs=JQueueDVFS(
        thresholds=thr, batch_levels=levels), **j_kw).serve(
        JPoissonTraffic(**tr_kw))
    return sc, out, j_out


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_fleet_matches_reference(name):
    """The port's fleet against the reference's on the same traffic: the
    schedule exactly, every session's outputs and response at the stated
    tolerances, energy at rtol 1e-6."""
    sc, out, j_out = _serve_pair(name)
    st, jst = out["stats"], j_out["stats"]
    for k in ("completed", "rounds", "width_hist", "preemptions",
              "ticks_served", "ticks_run"):
        assert st[k] == jst[k], k
    assert st["queue"]["submitted"] == jst["queue"]["submitted"]
    assert st["joules_per_request"] == pytest.approx(
        jst["joules_per_request"], rel=ENERGY_RTOL)
    want = {s.sid: s for s in j_out["sessions"]}
    assert sorted(want) == sorted(s.sid for s in out["sessions"])
    for s in out["sessions"]:
        w = want[s.sid]
        assert (s.ticks_done, s.ticks_run, s.preemptions) == \
            (w.ticks_done, w.ticks_run, w.preemptions)
        assert_outputs(s.outputs, w.outputs, sc.output_keys)
        assert s.energy_j == pytest.approx(w.energy_j, rel=ENERGY_RTOL)
        for k, v in w.response.items():
            np.testing.assert_allclose(s.response[k], v, rtol=FLOAT_RTOL,
                                       atol=2e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["adaptive", "kws"])
def test_fleet_modes_serve_the_same(kind):
    """Every NoC and exec mode serves: on a 12-PE program (8 links),
    sparse NoC accounting (the link kernel's fleet rows; KWS with
    per-instance flits) and event mode (the event kernel's) give the
    dense fleet's outputs and energies bitwise."""
    sc = (adaptive_scenario(n_channels=6, n_neurons=16, device="cpu")
          if kind == "adaptive" else
          kws_scenario(n_pairs=6, n_neurons=16, hidden=4, device="cpu"))
    tr = dict(rate=3.0, n_sessions=3, seed=6, tick_range=(TC, 2 * TC))
    runs = []
    for noc, ex in (("dense", "dense"), ("sparse", "dense"),
                    ("sparse", "event")):
        eng = FleetEngine(sc, round_ticks=TC, device="cpu", noc_mode=noc,
                          exec_mode=ex, dvfs=QueueDVFS(thresholds=(2,),
                                                       batch_levels=(2, 4)))
        assert eng.sim.use_sparse_noc() == (noc == "sparse")
        assert eng.sim.use_event_mode() == (ex == "event")
        assert eng.sim.noc.n_links == 8
        runs.append(eng.serve(PoissonTraffic(**tr))["sessions"])
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert a.energy_j == b.energy_j
            for k in sc.output_keys:
                np.testing.assert_array_equal(a.outputs[k], b.outputs[k])


def test_preemption_and_resume_invisible(sc):
    """Sessions preempted when the fleet narrows finish equal to their
    uninterrupted solo runs (learn state included)."""
    totals = [2 * TC, 5 * TC, 5 * TC]
    specs = PoissonTraffic(rate=10.0, n_sessions=3, seed=2,
                           tick_range=(1, 1)).drain()
    sessions = [Session(sid=sp.sid, stream=sc.stream(sp.seed),
                        total_ticks=totals[sp.sid]) for sp in specs]
    eng = FleetEngine(sc, round_ticks=TC, device="cpu",
                      dvfs=QueueDVFS(thresholds=(3,), batch_levels=(1, 4)))
    out = eng.serve(None, sessions=sessions)
    assert out["stats"]["completed"] == 3
    assert out["stats"]["preemptions"] >= 1
    for sess in out["sessions"]:
        ref = _solo(sc, specs[sess.sid].seed, sess.total_ticks)
        for k in sc.output_keys:
            np.testing.assert_allclose(sess.outputs[k], ref.outputs[k],
                                       rtol=3e-6, atol=1e-7)


def test_suspend_restore_cross_engine_bitwise(sc, tmp_path):
    T, seed = 5 * TC, 99
    ref = _solo(sc, seed, T)
    kw = dict(round_ticks=TC, capacity=1, ckpt_dir=tmp_path, device="cpu",
              dvfs=QueueDVFS(thresholds=(2,), batch_levels=(1, 1)))
    eng1 = FleetEngine(sc, max_rounds=2, **kw)
    s1 = Session(sid=7, stream=sc.stream(seed), total_ticks=T)
    eng1.serve(None, sessions=[s1])
    assert s1.ticks_done == 2 * TC and not s1.done
    assert [s.sid for s in eng1.suspend()] == [7]
    part1 = {k: np.concatenate(v) for k, v in s1.outputs.items()}
    eng2 = FleetEngine(sc, **kw)
    s2 = eng2.restore_session(7, stream=sc.stream(seed), total_ticks=T)
    assert s2.ticks_done == 2 * TC
    done = eng2.serve(None, sessions=[s2])["sessions"][0]
    assert done.done
    for k in sc.output_keys:
        np.testing.assert_array_equal(
            np.concatenate([part1[k], done.outputs[k]]), ref.outputs[k])
    with pytest.raises(FileNotFoundError):
        eng2.restore_session(8)


def test_reference_checkpoint_resumes_in_the_port(sc, j_sc, tmp_path):
    """The reference's engine serves two rounds and suspends to disk; the
    port's engine restores the session from the reference's checkpoint
    (numpy carry -> the port's state, learn stacks included) and
    finishes it: the stitched outputs equal the reference's
    uninterrupted run."""
    T, seed = 5 * TC, 17
    ref = _j_solo(j_sc, seed, T)
    dvfs = dict(thresholds=(2,), batch_levels=(1, 1))
    eng1 = JFleetEngine(j_sc, round_ticks=TC, capacity=1, max_rounds=2,
                        ckpt_dir=tmp_path, dvfs=JQueueDVFS(**dvfs))
    s1 = JSession(sid=3, stream=j_sc.stream(seed), total_ticks=T)
    eng1.serve(None, sessions=[s1])
    eng1.suspend()
    part1 = {k: np.concatenate([np.asarray(x) for x in v])
             for k, v in s1.outputs.items()}
    eng2 = FleetEngine(sc, round_ticks=TC, capacity=1, ckpt_dir=tmp_path,
                       device="cpu", dvfs=QueueDVFS(**dvfs))
    s2 = eng2.restore_session(3, stream=sc.stream(seed), total_ticks=T)
    assert s2.ticks_done == 2 * TC
    done = eng2.serve(None, sessions=[s2])["sessions"][0]
    stitched = {k: np.concatenate([part1[k], done.outputs[k]])
                for k in sc.output_keys}
    assert_outputs(stitched, ref.outputs, sc.output_keys)
    assert done.energy_j > 0.0


def test_batched_probes_ride_the_fleet(sc):
    """Per-instance probe accumulators travel with sessions through the
    batched state (also across the slot moves of completions) and come
    back per session; each equals the session's own fold."""
    probes = (ProbeSpec("pl_mean", "pl", "mean", stride=TC),
              ProbeSpec("e_sum", "e_dvfs_baseline", "sum", stride=TC),
              ProbeSpec("y_ema", "y", "ema", stride=TC, alpha=0.1))
    kw = dict(round_ticks=TC, device="cpu", probes=probes,
              probe_ticks=4 * TC)
    eng = FleetEngine(sc, dvfs=QueueDVFS(thresholds=(2,),
                                         batch_levels=(1, 2)), **kw)
    out = eng.serve(PoissonTraffic(rate=2.0, n_sessions=3, seed=6,
                                   tick_range=(2 * TC, 4 * TC)))
    assert out["stats"]["completed"] == 3
    for s in out["sessions"]:
        pr = s.outputs["probes"]
        n_win = s.ticks_run // TC
        assert pr["pl_mean"].shape == (4, eng.program.n_pes)
        assert pr["e_sum"][:n_win].sum() > 0.0
        assert np.all(pr["e_sum"][n_win:] == 0.0)
        solo = FleetEngine(sc, capacity=1, dvfs=QueueDVFS(
            thresholds=(2,), batch_levels=(1, 1)), **kw).serve(
            None, sessions=[Session(sid=0, stream=s.stream,
                                    total_ticks=s.total_ticks)])
        for k, v in solo["sessions"][0].outputs["probes"].items():
            np.testing.assert_allclose(pr[k], v, rtol=3e-6, atol=1e-7,
                                       err_msg=k)


def test_engine_refuses_a_scenario_on_another_device(sc):
    from types import SimpleNamespace
    elsewhere = dataclasses.replace(
        sc, ens=SimpleNamespace(device=torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="one device"):
        FleetEngine(elsewhere, round_ticks=TC, device="cpu")


# ----------------------------------------------------------- checkpoints

def _tree(rng):
    return {"st": {"v": torch.from_numpy(rng.integers(-9, 9, (2, 3))
                                         .astype(np.int32)),
                   "learn": {"nef0->plant0": {
                       "w": torch.from_numpy(rng.normal(size=(4, 1))
                                             .astype(np.float32))}}},
            "obs": {}, "lst": [np.arange(3), np.float32(2.5)]}


def test_checkpoint_roundtrip_keep_latest_async(tmp_path):
    rng = np.random.default_rng(0)
    mgr = CheckpointManager(tmp_path / "a", keep=2, async_save=True)
    trees = {}
    for step in (10, 20, 30):
        trees[step] = _tree(rng)
        mgr.save(step, trees[step], meta={"step": step})
    mgr.wait()
    assert sorted(mgr.all_steps()) == [20, 30] and mgr.latest_step() == 30
    assert (tmp_path / "a" / "LATEST").read_text() == "30"
    for step in (20, 30):
        got, manifest = mgr.restore(trees[step], step, device="cpu")
        assert manifest["meta"] == {"step": step}
        assert torch.equal(got["st"]["v"], trees[step]["st"]["v"])
        assert got["st"]["v"].dtype == torch.int32
        assert torch.equal(got["st"]["learn"]["nef0->plant0"]["w"],
                           trees[step]["st"]["learn"]["nef0->plant0"]["w"])
        assert got["obs"] == {} and float(got["lst"][1]) == 2.5
    assert CheckpointManager(tmp_path / "empty").restore({}, device="cpu") \
        == (None, None)
    sync = CheckpointManager(tmp_path / "b", keep=1, async_save=False)
    sync.save(1, trees[30])
    assert not list((tmp_path / "b").glob("*.tmp"))


def test_checkpoints_cross_between_packages(tmp_path):
    """The on-disk layout is the reference's: each package reads the
    other's checkpoint, leaf for leaf."""
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    np_tree = {"st": {"v": tree["st"]["v"].numpy(),
                      "learn": {"nef0->plant0": {
                          "w": tree["st"]["learn"]["nef0->plant0"]["w"]
                          .numpy()}}},
               "obs": {}, "lst": [np.arange(3), np.float32(2.5)]}
    JCheckpointManager(tmp_path / "j", async_save=False).save(5, np_tree)
    got, _ = CheckpointManager(tmp_path / "j").restore(np_tree,
                                                       device="cpu")
    np.testing.assert_array_equal(got["st"]["v"].numpy(),
                                  np_tree["st"]["v"])
    CheckpointManager(tmp_path / "t", async_save=False).save(6, tree)
    jgot, manifest = JCheckpointManager(tmp_path / "t").restore(np_tree)
    assert manifest["step"] == 6
    np.testing.assert_array_equal(
        np.asarray(jgot["st"]["learn"]["nef0->plant0"]["w"]),
        np_tree["st"]["learn"]["nef0->plant0"]["w"])
    assert sorted(p.name for p in (tmp_path / "t" / "step_00000006")
                  .iterdir()) == sorted(
        p.name for p in (tmp_path / "j" / "step_00000005").iterdir())


# ------------------------------------------------------------ entry point

def test_launch_fleet_main_on_cpu(capsys, tmp_path):
    stats = fleet_main(["--device", "cpu", "--fleet", "4", "--sessions",
                        "3", "--rate", "2", "--round-ticks", "16",
                        "--min-ticks", "16", "--max-ticks", "40",
                        "--ckpt-dir", str(tmp_path)])
    assert stats["completed"] == 3
    assert "served 3 adaptive sessions on chip (cpu)" in \
        capsys.readouterr().out
