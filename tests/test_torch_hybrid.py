"""The port's hybrid SNN/DNN and DNN workloads against the JAX reference,
on the CPU.

The int8 MAC GEMM (``kernels/mac_gemm``), W8A8 quantization, the NEF
ensemble and its MAC-encoded drive, the event-triggered MAC, and the
chip workloads built on them (``hybrid_workload``, the board-scale
``hybrid_farm_graph`` in event mode, ``tiled_dnn_workload``), through
``repro`` and through ``repro_torch`` (device="cpu").  Integer records,
quantized operands and the s16.15 drive are compared bitwise.  The
decoded signal ``xhat`` and the MLP output ``hidden_out`` are float32
sums taken in another order than XLA's: they are held at rtol=1e-5
(atol 1e-6).  Energies at rtol=1e-6, the reference's own stability.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chip.chip import ChipSim as JChipSim
from repro.chip.compile import compile as j_compile
from repro.chip.workloads import hybrid_farm_graph as j_hybrid_farm_graph
from repro.chip.workloads import hybrid_graph as j_hybrid_graph
from repro.chip.workloads import hybrid_workload as j_hybrid_workload
from repro.chip.workloads import tiled_dnn_workload as j_tiled_dnn_workload
from repro.core import nef as jnef
from repro.core.hybrid import event_mac as j_event_mac
from repro.core.quant import quantize_params_linear as j_qparams
from repro.core.quant import quantize_per_axis as j_quantize
from repro.core.quant import quantized_linear as j_quantized_linear
from repro.kernels.mac_gemm import mac_gemm as j_mac_gemm
from repro.kernels.mac_gemm import mac_gemm_dequant as j_mac_gemm_dequant
from repro.kernels.mac_gemm import mac_gemm_ref as j_mac_gemm_ref

from repro_torch.chip import ChipSim, compile
from repro_torch.chip.workloads import (hybrid_farm_graph, hybrid_graph,
                                        hybrid_workload, tiled_dnn_workload)
from repro_torch.core import nef
from repro_torch.core.hybrid import event_mac
from repro_torch.core.quant import (quantize_params_linear,
                                    quantize_per_axis, quantized_linear)
from repro_torch.kernels import mac_gemm
from repro_torch.kernels.mac_gemm import mac_gemm_dequant, mac_gemm_ref

FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-6
ENERGY_RTOL = 1e-6
HYBRID_INT = ("spikes", "n_spk", "pl", "n_fifo", "packets", "payload_bits",
              "n_dispatched", "mac_events", "link_flits", "link_load",
              "graded_bits_out", "graded_bits_in", "syn_events",
              "active_sources", "active_frac", "touched_links",
              "touched_links_onchip", "t_sp")
HYBRID_FLOAT = ("xhat", "hidden_out")


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_workload_records(got, want, exact, close=()):
    """Port records against the reference's: ``exact`` keys bitwise (same
    dtype), ``close`` float keys at the float tolerance, energies at
    rtol=1e-6; every key of either run is covered."""
    assert set(got) == set(want)
    for k in got:
        g, w = got[k].cpu().numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k in close:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL,
                                       atol=FLOAT_ATOL, err_msg=k)
        else:
            assert k.startswith("e_"), k
            np.testing.assert_allclose(g, w, rtol=ENERGY_RTOL, atol=0,
                                       err_msg=k)


# ------------------------------------------------------------- mac_gemm

def _operands(rng, shape, dtype):
    lo, hi = (-128, 127) if dtype == np.int8 else (0, 255)
    return rng.integers(lo, hi, shape, endpoint=True).astype(dtype)


@pytest.mark.parametrize("a_t,b_t", [(np.int8, np.int8), (np.uint8, np.uint8),
                                     (np.int8, np.uint8), (np.uint8, np.int8)])
@pytest.mark.parametrize("m,k,n", [(37, 45, 29), (600, 1, 256), (130, 200, 3)])
def test_mac_gemm_matches_reference(a_t, b_t, m, k, n):
    """The plain version against the reference's oracle and its Pallas
    kernel (interpret mode, padded to 128-blocks), bitwise, for every
    signedness pair and shapes that are not block multiples."""
    rng = np.random.default_rng(m * k + n)
    a, b = _operands(rng, (m, k), a_t), _operands(rng, (k, n), b_t)
    got = mac_gemm(_t(a), _t(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    want = np.asarray(j_mac_gemm_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_mac_gemm(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(mac_gemm_ref(_t(a), _t(b)).numpy(), want)
    sa = rng.random(m).astype(np.float32)
    sb = rng.random(n).astype(np.float32)
    np.testing.assert_array_equal(
        mac_gemm_dequant(_t(a), _t(b), _t(sa), _t(sb)).numpy(),
        np.asarray(j_mac_gemm_dequant(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(sa), jnp.asarray(sb))))


def test_mac_gemm_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="int8 or uint8"):
        mac_gemm(torch.zeros(2, 3, dtype=torch.int32),
                 torch.zeros(3, 2, dtype=torch.int8))
    with pytest.raises(ValueError, match="bad shapes"):
        mac_gemm(torch.zeros(2, 3, dtype=torch.int8),
                 torch.zeros(4, 2, dtype=torch.int8))


# ------------------------------------------------------------- quantization

@pytest.mark.parametrize("shape,axis", [((600, 1), 1), ((1, 256), 0),
                                        ((256, 64), 0), ((40, 64), 1),
                                        ((5, 7), 1)])
def test_quantize_per_axis_matches_reference(shape, axis):
    rng = np.random.default_rng(shape[0])
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10)).astype(
        np.float32)
    x[0] = 0.0                                 # an all-zero slice
    q, s = quantize_per_axis(_t(x), axis)
    jq, js = j_quantize(jnp.asarray(x), axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantized_linear_and_event_mac_match_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    wq, ws = quantize_params_linear(_t(w))
    jwq, jws = j_qparams(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    np.testing.assert_array_equal(
        quantized_linear(_t(x), wq, ws).numpy(),
        np.asarray(j_quantized_linear(jnp.asarray(x), jwq, jws)))
    active = rng.random(40) < 0.3
    for cap in (None, 20):
        out, n = event_mac(_t(x), _t(active), wq, ws, capacity=cap)
        jout, jn = j_event_mac(jnp.asarray(x), jnp.asarray(active), jwq, jws,
                               capacity=cap)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        assert int(n) == int(jn) == active.sum()
        assert not out.numpy()[~active].any()


# ------------------------------------------------------------- NEF

@pytest.fixture(scope="module")
def ensembles():
    """(port, reference) ensembles of 64 neurons, seed 0."""
    return (nef.build_ensemble(64, 1, seed=0, device="cpu"),
            jnef.build_ensemble(64, 1, seed=0))


def test_build_ensemble_equals_the_carried_reference(ensembles):
    ens, jens = ensembles
    carried = nef.ensemble_from_numpy(jens, device="cpu")
    for got in (ens, carried):
        for k in ("encoders", "gains", "biases", "decoders"):
            np.testing.assert_array_equal(getattr(got, k), getattr(jens, k))
        assert got.lif == jens.lif
        assert got.enc_q.dtype == torch.int8
        np.testing.assert_array_equal(got.enc_q.numpy(), jens.enc_q)
        np.testing.assert_array_equal(got.enc_scale.numpy(), jens.enc_scale)
        assert got.tau_syn_ticks == jens.tau_syn_ticks


@pytest.mark.parametrize("use_mac", [True, False])
def test_encode_drive_matches_reference_bitwise(ensembles, use_mac):
    ens, jens = ensembles
    x = 0.8 * np.sin(2 * np.pi * np.arange(600) / 400)[:, None]
    got = nef.encode_drive(ens, x, use_mac=use_mac)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnef.encode_drive(jens, x, use_mac=use_mac)))


def test_run_channel_matches_reference(ensembles):
    ens, jens = ensembles
    x = 0.8 * np.sin(2 * np.pi * np.arange(300) / 400)[:, None]
    got, want = nef.run_channel(ens, x), jnef.run_channel(jens, x)
    np.testing.assert_array_equal(got["spikes"], want["spikes"])
    np.testing.assert_array_equal(got["spikes_per_tick"],
                                  want["spikes_per_tick"])
    np.testing.assert_allclose(got["xhat"], want["xhat"], rtol=FLOAT_RTOL,
                               atol=FLOAT_ATOL)
    e = np.full(300, 1e-9)
    assert nef.synop_metrics(ens, got["spikes_per_tick"], e) == \
        jnef.synop_metrics(jens, want["spikes_per_tick"], e)


# ------------------------------------------------------------- workloads

@pytest.fixture(scope="module")
def hybrid_runs():
    """The hybrid NEF -> MLP pipeline, 64 neurons, hidden 16, 200 ticks."""
    kw = dict(n_neurons=64, hidden=16, n_ticks=200)
    return hybrid_workload(**kw, device="cpu"), j_hybrid_workload(**kw)


def test_hybrid_workload_matches_reference(hybrid_runs):
    got, want = hybrid_runs
    assert not got["sim"].use_event_mode()
    assert_workload_records(got["recs"], want["recs"], HYBRID_INT,
                            HYBRID_FLOAT)
    assert got["rmse"] == pytest.approx(want["rmse"], rel=1e-4)
    for k in ("n_dispatched", "total_spikes", "duty_cycle", "energy_mac_j",
              "energy_mac_frame_j", "event_vs_frame"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["graded_bits_out"],
                                  want["graded_bits_out"])
    np.testing.assert_array_equal(got["graded_bits_in"],
                                  want["graded_bits_in"])
    for k, v in want["synops"].items():
        assert got["synops"][k] == pytest.approx(v, rel=1e-12), k
    assert got["total_spikes"] > 0


def test_hybrid_graded_payload_conserved(hybrid_runs):
    """Every graded payload bit the NEF PE emits arrives at the MLP PE one
    transport tick later."""
    got, _ = hybrid_runs
    out, inn = got["graded_bits_out"], got["graded_bits_in"]
    assert out.sum() > 0 and inn[0] == 0
    np.testing.assert_array_equal(out[:-1], inn[1:])


def test_carried_parameters_drive_the_same_channel():
    """The reference's ensemble and MLP weights carried across give the
    port the same graph operands as its own build from the seed."""
    jg_sem = j_hybrid_graph(64, 16, n_ticks=50).semantics
    carried = hybrid_graph(
        64, 16, n_ticks=50, ens=nef.ensemble_from_numpy(jg_sem.ens, "cpu"),
        wq=_t(np.asarray(jg_sem.wq)), w_scale=_t(np.asarray(jg_sem.w_scale)),
        device="cpu").semantics
    own = hybrid_graph(64, 16, n_ticks=50, device="cpu").semantics
    for sem in (carried, own):
        np.testing.assert_array_equal(sem.drive_fx.numpy(),
                                      np.asarray(jg_sem.drive_fx))
        np.testing.assert_array_equal(sem.wq.numpy(), np.asarray(jg_sem.wq))
        np.testing.assert_array_equal(sem.w_scale.numpy(),
                                      np.asarray(jg_sem.w_scale))


def test_hybrid_farm_event_mode_matches_reference():
    """128 NEF -> MLP channels on 256 PEs: the sparse NoC, so "auto" runs
    event mode with the event-mode accounting of graded multi-flit
    packets; the reference's run, and the port's dense run, bitwise."""
    T = 64
    jprog = j_compile(j_hybrid_farm_graph(128))
    jsim = JChipSim(jprog, event_impl="gather")
    assert jsim.use_event_mode()
    want = jsim.run(T)
    prog = compile(hybrid_farm_graph(128, device="cpu"))
    sim = ChipSim(prog, device="cpu")
    assert sim.use_event_mode()
    got = sim.run(T)
    exact = [k for k in want if not k.startswith("e_")
             and k != "hidden_out"]
    assert_workload_records(got, want, exact, ("hidden_out",))
    dense = sim.run(T, exec_mode="dense")
    for k in got:
        assert torch.equal(got[k], dense[k]), k
    assert got["link_flits"].sum() > got["link_load"].sum() > 0
    bits_out = got["graded_bits_out"].sum(1)
    np.testing.assert_array_equal(bits_out[:-1].numpy(),
                                  got["graded_bits_in"].sum(1)[1:].numpy())


def test_tiled_dnn_workload_matches_reference():
    got, want = tiled_dnn_workload(device="cpu"), j_tiled_dnn_workload()
    assert got["n_frames_out"] == want["n_frames_out"] == 4
    for k in ("latency_s", "compute_s", "noc_s", "n_pes_used", "mesh",
              "layers", "peak_link_load", "peak_link_flits"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["link_loads"], want["link_loads"])
    exact = [k for k in want["recs"] if not k.startswith("e_")]
    assert_workload_records(got["recs"], want["recs"], exact)
    for k in ("energy_mac_j", "energy_noc_j"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
