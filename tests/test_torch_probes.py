"""The port's probes and trace export (``repro_torch.obs``) against the
JAX reference's ``repro.obs``, on the CPU.

Probes off is the bare run; a probed run's records are the bare run's,
bit for bit.  Every op (peak, mean, sum, ema, last) over strides with a
ragged last window is held against the same fold of the reference's
UNPROBED records (the reference's probed run moves ``e_dvfs_baseline`` by
one ulp): probes of integer-valued signals bitwise for peak, sum and
last, every other probe at rtol 1e-6 (at rtol 1e-5, the records' own
tolerance, where the signal is a float32 sum of the decoders: u, y,
dw); and against the reference's own probe output the same way.
``keep_records=False``, the registry's errors, the link profile on a
chip and a board, and ``trace_events`` (the reference's payload on the
same records).
"""
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.board import BoardSpec as JBoardSpec
from repro.board import compile_board as j_compile_board
from repro.chip.chip import ChipSim as JChipSim
from repro.chip.compile import compile as j_compile
from repro.chip.workloads import synfire_graph as j_synfire_graph
from repro.learn.adaptive import adaptive_control_graph as j_adaptive_graph
from repro.obs import ProbeSpec as JProbeSpec
from repro.obs import default_probes as j_default_probes
from repro.obs import record_link_profile as j_record_link_profile
from repro.obs import trace_events as j_trace_events

from repro_torch.board import BoardSpec, compile_board
from repro_torch.chip import ChipSim, compile
from repro_torch.chip.workloads import synfire_graph
from repro_torch.learn.adaptive import adaptive_control_graph
from repro_torch.obs import (ProbeSpec, default_probes, link_profile,
                             link_profile_probes, make_probe_step,
                             record_link_profile, trace_events, write_trace)
from repro_torch.obs.trace import main as trace_main

# 2x2 board of 1x1-QPE chips: 4 plastic loops cross the chip-to-chip tier
BOARD_KW = dict(n_channels=4, n_neurons=50, n_ticks=128, period=128)
TICKS = 128
# every op, strides with a ragged last window (128 = 6 x 20 + 8, ...)
EXTRA = [("pk7", "link_flits", "peak", 7, 0.1),
         ("u_last", "u", "last", 30, 0.1),
         ("u_ema", "u", "ema", 50, 0.2),
         ("pl_sum", "pl", "sum", 9, 0.1),
         ("y_mean", "y", "mean", None, 0.1),
         ("dw_peak", "learn/nef2->plant2/dw", "peak", 11, 0.1)]
# signals that are float32 sums over the decoders (tests/test_torch_learn.py)
DECODER_SUMS = ("u", "y", "track_err", "dec_norm")


def _fold(x: np.ndarray, op: str, stride, alpha: float) -> np.ndarray:
    """The windowed reduction in float32, tick by tick in order."""
    x = x.astype(np.float32)
    T = len(x)
    s = T if stride is None else min(stride, T)
    out, ema = [], None
    for w0 in range(0, T, s):
        acc = None
        for t in range(w0, min(w0 + s, T)):
            v = x[t]
            if op == "ema":
                ema = v if ema is None else (np.float32(alpha) * v
                                             + np.float32(1 - alpha) * ema)
            elif acc is None or op == "last":
                acc = v
            elif op == "peak":
                acc = np.maximum(acc, v)
            else:
                acc = acc + v
        n = min(w0 + s, T) - w0
        out.append(ema if op == "ema" else
                   acc / np.float32(n) if op == "mean" else acc)
    return np.stack(out)


@pytest.fixture(scope="module")
def plastic_board():
    """(port sim, reference sim) of the plastic 2x2 board."""
    board = ("2x2", "1x1")
    sim = ChipSim(compile_board(
        adaptive_control_graph(device="cpu", **BOARD_KW),
        BoardSpec.parse(board[0], chip=board[1]), refine=False),
        device="cpu")
    jsim = JChipSim(j_compile_board(
        j_adaptive_graph(**BOARD_KW),
        JBoardSpec.parse(board[0], chip=board[1]), refine=False))
    return sim, jsim


@pytest.fixture(scope="module")
def board_runs(plastic_board):
    """Bare and probed port runs and the reference's bare and probed
    runs, with the default probes at stride 20 and every op in EXTRA."""
    sim, jsim = plastic_board
    specs = default_probes(sim.program, stride=20) + tuple(
        ProbeSpec(*e) for e in EXTRA)
    jspecs = j_default_probes(jsim.program, stride=20) + tuple(
        JProbeSpec(*e) for e in EXTRA)
    return (sim.run(TICKS), sim.run(TICKS, probes=specs), specs,
            jsim.run(TICKS), jsim.run(TICKS, probes=jspecs))


def test_probes_off_is_the_bare_run():
    sim = ChipSim(compile(synfire_graph(8, device="cpu")), device="cpu")
    recs = sim.run(100)
    again = sim.run(100, probes=())
    assert "probes" not in recs and set(recs) == set(again)
    for k in recs:
        assert torch.equal(recs[k], again[k]), k


def test_probed_board_run_keeps_records_and_matches_reference(board_runs):
    bare, probed, specs, jbare, jprobed = board_runs
    assert float(bare["flits_xchip"].sum()) > 0 and "e_learn" in bare
    assert set(probed) == set(bare) | {"probes"}
    for k in bare:
        assert torch.equal(bare[k], probed[k]), k
    out = probed["probes"]
    assert set(out) == set(jprobed["probes"]) == {s.name for s in specs}
    assert "pe_e_learn_sum" in out and "learn_dw_nef3->plant3" in out
    for s in specs:
        got = out[s.name].numpy()
        want = _fold(np.asarray(jbare[s.key]), s.op, s.stride, s.alpha)
        assert got.shape == want.shape, s.name
        exact = (s.op in ("peak", "sum", "last")
                 and np.array_equal(np.asarray(jbare[s.key]),
                                    np.round(np.asarray(jbare[s.key]))))
        rtol = 1e-5 if (s.key in DECODER_SUMS
                        or s.key.endswith("/dw")) else 1e-6
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=s.name)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12,
                                       err_msg=s.name)
        np.testing.assert_allclose(got, np.asarray(jprobed["probes"][s.name]),
                                   rtol=rtol, atol=1e-12, err_msg=s.name)
        # the port's fold is exactly the fold of its own records
        np.testing.assert_array_equal(
            got, _fold(bare[s.key].numpy(), s.op, s.stride, s.alpha),
            err_msg=s.name)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_slot_group_probes_fold_as_one():
    """Per-slot probes over a stacked group record fold as one batched
    accumulator: the values of folding each slot alone, and a tick costs
    as many torch ops at 64 slots as at 8."""
    rng = np.random.default_rng(0)
    ops = {}
    for G in (8, 64):
        names = [f"s{i}" for i in range(G)]
        views = {f"learn/{n}/dw": ("learn/s0../dw", i)
                 for i, n in enumerate(names)}
        specs = tuple(ProbeSpec(f"dw_{n}", f"learn/{n}/dw", "mean", 7)
                      for n in names) + (ProbeSpec("one", "learn/s3/dw",
                                                   "peak", 5),)
        x = torch.from_numpy(rng.random((20, G)).astype(np.float32))
        obs, step, finalize = make_probe_step(
            specs, {"learn/s0../dw": x[0]}, 20, row_views=views)
        for t in range(20):
            if t == 10:
                with _OpCount() as count:
                    step(obs, {"learn/s0../dw": x[t]}, t)
                ops[G] = count.n
            else:
                step(obs, {"learn/s0../dw": x[t]}, t)
        out = finalize(obs)
        assert list(out) == [s.name for s in specs]
        for i, n in enumerate(names):
            assert torch.equal(out[f"dw_{n}"], torch.from_numpy(
                _fold(x[:, i].numpy(), "mean", 7, 0.1))), n
        assert torch.equal(out["one"], torch.from_numpy(
            _fold(x[:, 3].numpy(), "peak", 5, 0.1)))
    assert ops[8] == ops[64], ops


def test_keep_records_false_and_registry_errors():
    sim = ChipSim(compile(synfire_graph(8, device="cpu")), device="cpu")
    full = sim.run(120)
    slim = sim.run(120, probes=(ProbeSpec("pk", "link_flits", "peak"),),
                   keep_records=False)
    assert set(slim) == {"probes"}
    assert torch.equal(slim["probes"]["pk"][-1],
                       full["link_flits"].max(0).values)
    recs = sim.run(16, probes=("link_flits", "dvfs"))
    assert set(recs["probes"]) == {"link_flits_peak", "link_flits_mean",
                                   "pe_pl_mean", "pe_pl_ema"}
    with pytest.raises(ValueError, match="unknown probe set"):
        sim.run(4, probes=("no_such_set",))
    with pytest.raises(KeyError, match="available keys"):
        sim.run(4, probes=(ProbeSpec("x", "no_such_rec_key", "peak"),))
    with pytest.raises(ValueError, match="duplicate probe names"):
        sim.run(4, probes=(ProbeSpec("x", "pl", "peak"),
                           ProbeSpec("x", "pl", "mean")))
    with pytest.raises(ValueError, match="unknown op"):
        ProbeSpec("x", "pl", "median")
    with pytest.raises(ValueError, match="keep_records"):
        sim.run(4, keep_records=False)


def test_link_profile_matches_reference_on_chip_and_board(plastic_board):
    sim, jsim = plastic_board
    # shot noise: the port's hash draws the reference's noise
    chip = ChipSim(compile(synfire_graph(16, noise_model="shot",
                                         device="cpu")), device="cpu")
    jchip = JChipSim(j_compile(j_synfire_graph(16, noise_model="shot")))
    for s, js, n in ((chip, jchip, 64), (sim, jsim, TICKS)):
        prof = record_link_profile(s, n)
        flits = s.run(n)["link_flits"].numpy()
        assert prof == {
            "n_onchip_links": int(getattr(s.program.noc, "n_onchip_links",
                                          s.program.noc.n_links)),
            "peak": np.round(flits.max(axis=0), 2).tolist(),
            "mean": np.round(flits.mean(axis=0), 4).tolist()}
        want = j_record_link_profile(js, n)
        assert prof["n_onchip_links"] == want["n_onchip_links"]
        assert prof["peak"] == want["peak"]
        np.testing.assert_allclose(prof["mean"], want["mean"], atol=1e-4)
    out = chip.run(64, probes=link_profile_probes(), keep_records=False)
    assert len(link_profile(chip.program, out["probes"])["peak"]) \
        == chip.program.noc.n_links


def test_trace_events_match_reference(board_runs, plastic_board, tmp_path):
    """On the reference's own records the port's payload is the
    reference's; on the port's records it has the same tracks."""
    sim, jsim = plastic_board
    bare, _, _, jbare, _ = board_runs
    want = j_trace_events(jsim.program, jbare)
    carried = {k: torch.from_numpy(np.array(v)) for k, v in jbare.items()}
    assert trace_events(sim.program, carried) == want
    got = trace_events(sim.program, bare)
    assert len(got["traceEvents"]) == len(want["traceEvents"])
    assert [(e["ph"], e["pid"], e["name"]) for e in got["traceEvents"]] \
        == [(e["ph"], e["pid"], e["name"]) for e in want["traceEvents"]]
    counters = {e["name"] for e in got["traceEvents"] if e["ph"] == "C"}
    assert {"flits/onchip", "flits/xchip"} <= counters
    assert any(n.startswith("dw ") for n in counters)
    path = write_trace(tmp_path / "t.json", sim.program, bare)
    assert json.loads(path.read_text()) == json.loads(json.dumps(got))
    assert trace_main(["--board", "1x2", "--chip", "1x1", "--workload",
                       "synfire", "--ticks", "8", "--device", "cpu",
                       "--out", str(tmp_path / "cli.json.gz")]) == 0
    assert (tmp_path / "cli.json.gz").exists()
