"""The port's fixed-point log, MAC-array convolution, flash attention and
paper MAC benchmarks (Fig. 15, Fig. 22/23) against the JAX reference, on
the CPU.

The same seeded numpy inputs go through the reference (its jnp oracle
and, on a few cases, its Pallas kernel in interpret mode) and through the
port's wrappers on CPU tensors, which run the plain versions.  ``fx_log``
and ``mac_conv2d`` are compared bitwise.  Attention is float32 arithmetic
summed in another order than XLA's: float32 at atol 2e-5, rtol 1e-4 and
bfloat16 at 0.03, the reference tests' own tolerances.  The benchmarks'
derived fields are rebuilt from the reference's functions (``PESpec``,
``_pe_power_w``, ``modeled_tops_per_w``) without running its ``main``,
which executes interpret-mode kernels.
"""
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:            # the reference's benchmarks/
    sys.path.insert(0, str(ROOT))

from benchmarks.dnn_layers import LAYERS as J_LAYERS  # noqa: E402
from benchmarks.dnn_layers import PLS as J_PLS  # noqa: E402
from benchmarks.dnn_layers import _pe_power_w as j_pe_power_w  # noqa: E402
from benchmarks.mac_efficiency import (  # noqa: E402
    modeled_tops_per_w as j_modeled_tops_per_w)
from repro.configs import paper as j_paper  # noqa: E402
from repro.core.pe import PESpec as JPESpec  # noqa: E402
from repro.core.pe import partition_layer_to_sram as j_partition  # noqa: E402
from repro.kernels.explog.ops import fx_log as j_fx_log  # noqa: E402
from repro.kernels.explog.ops import fx_log_float as j_fx_log_float  # noqa: E402
from repro.kernels.explog.ref import fx_log_ref as j_fx_log_ref  # noqa: E402
from repro.kernels.flash_attn import (  # noqa: E402
    flash_attention_kernel as j_flash_attention_kernel)
from repro.kernels.flash_attn import (  # noqa: E402
    flash_attention_ref as j_flash_attention_ref)
from repro.kernels.mac_conv import mac_conv2d as j_mac_conv2d  # noqa: E402
from repro.kernels.mac_conv import (  # noqa: E402
    mac_conv2d_ref as j_mac_conv2d_ref)

from repro_torch.bench import dnn_layers, mac_efficiency  # noqa: E402
from repro_torch.kernels import (flash_attention_kernel, fx_log,  # noqa: E402
                                 launch_counts, mac_conv2d,
                                 reset_launch_counts)
from repro_torch.kernels.explog import FX_ONE, fx_log_float  # noqa: E402
from repro_torch.kernels.explog.ref import (LN2, LOG_BAD,  # noqa: E402
                                            LOG_TABLE, fx_log_ref)
from repro_torch.kernels.flash_attn import flash_attention_ref  # noqa: E402
from repro_torch.kernels.mac_conv.ops import (  # noqa: E402
    route as conv_route)

CSRC = ROOT / "src" / "repro_torch" / "csrc"
I32 = np.iinfo(np.int32)
CONV_CASES = [                      # tests/test_kernels_mac_conv.py
    ((1, 8, 8, 16), (3, 3, 16, 32), (1, 1), "VALID"),
    ((2, 16, 16, 8), (3, 3, 8, 64), (1, 1), "SAME"),
    ((1, 28, 28, 1), (5, 5, 1, 6), (1, 1), "VALID"),       # LeNet C1
    ((1, 14, 14, 64), (1, 1, 64, 128), (1, 1), "VALID"),   # 1x1 bottleneck
    ((1, 16, 16, 16), (3, 3, 16, 32), (2, 2), "SAME"),     # strided
    ((1, 32, 32, 3), (3, 3, 3, 130), (1, 1), "SAME"),      # Cout 130
    ((1, 7, 9, 4), (2, 4, 4, 8), (1, 2), "VALID"),         # odd everything
]
PAIRINGS = [(np.int8, np.int8), (np.uint8, np.uint8), (np.int8, np.uint8),
            (np.uint8, np.int8)]
ATTN_SHAPES = [(2, 64, 2, 16), (1, 128, 4, 32), (1, 256, 1, 8)]
F32_TOL, BF16_TOL = dict(atol=2e-5, rtol=1e-4), dict(atol=0.03, rtol=0.03)


def _int8s(rng, shape, dtype):
    lo, hi = (-128, 127) if dtype == np.int8 else (0, 255)
    return rng.integers(lo, hi, shape, endpoint=True).astype(dtype)


def _log_inputs(rng, n):
    """x <= 0, 1, FX_ONE +- 1, powers of two up to 2^30, INT32_MAX and
    random values over the whole int32 range."""
    edges = [I32.min, -5, -1, 0, 1, 2, FX_ONE - 1, FX_ONE, FX_ONE + 1,
             I32.max] + [1 << k for k in range(31)]
    return np.concatenate([np.array(edges, np.int32),
                           rng.integers(I32.min, I32.max, n, np.int64,
                                        endpoint=True).astype(np.int32),
                           rng.integers(1, 1 << 22, n).astype(np.int32)])


# ------------------------------------------------------------------ fx_log

def test_fx_log_matches_reference_bitwise():
    x = _log_inputs(np.random.default_rng(0), 10000)
    got = fx_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_fx_log_ref(
        jnp.asarray(x))))
    np.testing.assert_array_equal(
        got[:4096], np.asarray(j_fx_log(jnp.asarray(x[:4096]),
                                        impl="pallas")))


def test_fx_log_float_matches_reference_and_ln():
    """The reference's test_log_accuracy band, and its flags."""
    xf = np.random.default_rng(1).uniform(1e-2, 6e4, 4096).astype(
        np.float32)
    got = fx_log_float(torch.from_numpy(xf)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_fx_log_float(xf)))
    assert np.max(np.abs(got - np.log(np.round(xf * FX_ONE) / FX_ONE))) \
        < 3e-4
    out = fx_log(torch.tensor([-5, 0, 1, FX_ONE], dtype=torch.int32))
    assert out[0] == out[1] == LOG_BAD and abs(int(out[3])) <= 1


def test_fx_log_float_array_input_asks_for_the_card(monkeypatch):
    """An array-like input runs on ``device``, by default the card: it
    raises without one and never falls to the CPU."""
    xf = np.array([0.5, 1.0, 2.0, 1234.5], np.float32)
    got = fx_log_float(xf, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_fx_log_float(xf)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arg in (xf, xf.tolist()):
        with pytest.raises(RuntimeError, match="CUDA device"):
            fx_log_float(arg)


def test_fx_log_keeps_shape():
    x = torch.arange(1, 25, dtype=torch.int32).reshape(2, 3, 4) * 9000
    got = fx_log(x)
    assert got.shape == (2, 3, 4)
    assert torch.equal(got.reshape(-1), fx_log_ref(x.reshape(-1)))


def test_explog_cuda_log_ladder_matches_the_plain_version():
    """The kernel's ladder table, ln 2, normalising shift and flag value
    are the plain version's.  The kernel normalises with one shift after
    a count of leading zeros; tests/test_torch_fxlog.py holds that, its
    select-free ladder and its division against the plain version's
    steps."""
    src = (CSRC / "explog.cu").read_text()
    table = re.search(r"kLogTable\[15\]\s*=\s*\{([^}]*)\}", src)
    assert tuple(int(v) for v in table.group(1).split(",")) == LOG_TABLE
    assert int(re.search(r"kLn2\s*=\s*(\d+)", src).group(1)) == LN2
    assert "(z0 << lead) >> 16" in src
    assert "imad(lead, -kLn2, 16 * kLn2)" in src          # (16 - lead) ln 2
    assert re.search(r"kLogBad\s*=\s*-\(1 << 30\)", src)
    assert LOG_BAD == -(1 << 30)


# ------------------------------------------------------------------ mac_conv2d

@pytest.mark.parametrize("xs,ws,stride,pad", CONV_CASES)
def test_mac_conv2d_matches_reference(xs, ws, stride, pad):
    rng = np.random.default_rng(sum(xs) + sum(ws))
    x, w = _int8s(rng, xs, np.int8), _int8s(rng, ws, np.int8)
    got = mac_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                     stride=stride, padding=pad)
    want = np.asarray(j_mac_conv2d_ref(jnp.asarray(x), jnp.asarray(w),
                                       stride=stride, padding=pad))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("x_t,w_t", PAIRINGS)
def test_mac_conv2d_signedness_pairings(x_t, w_t):
    rng = np.random.default_rng(7)
    x, w = _int8s(rng, (2, 11, 10, 12), x_t), _int8s(rng, (3, 2, 12, 70),
                                                      w_t)
    got = mac_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                     stride=(2, 1), padding="SAME")
    want = np.asarray(j_mac_conv2d_ref(jnp.asarray(x), jnp.asarray(w),
                                       stride=(2, 1), padding="SAME"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", [CONV_CASES[1], CONV_CASES[6]])
def test_mac_conv2d_matches_pallas(case):
    xs, ws, stride, pad = case
    rng = np.random.default_rng(3)
    x, w = _int8s(rng, xs, np.int8), _int8s(rng, ws, np.int8)
    got = mac_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                     stride=stride, padding=pad)
    want = np.asarray(j_mac_conv2d(jnp.asarray(x), jnp.asarray(w),
                                   stride=stride, padding=pad))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mac_conv2d_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 6, 6, 4, dtype=torch.int8)
    w = torch.zeros(3, 3, 4, 8, dtype=torch.int8)
    with pytest.raises(TypeError, match="int8 or uint8"):
        mac_conv2d(x.to(torch.int32), w)
    with pytest.raises(ValueError, match="bad shapes"):
        mac_conv2d(x, w[:, :, :3])
    with pytest.raises(ValueError, match="padding"):
        mac_conv2d(x, w, padding="FULL")
    with pytest.raises(ValueError, match="does not fit"):
        mac_conv2d(x[:, :2], w)


# the kernel each Fig. 22/23 conv layer takes on the card: the tensor
# cores where every 16-byte chunk of a patch row lies in one tap
CONV_ROUTES = {"lenet_c1": "dp4a", "lenet_c3": "dp4a",
               "vgg16_conv3_256": "wgmma", "resnet50_1x1_b2": "wgmma",
               "resnet50_3x3_b2": "wgmma", "mobilenetv2_pw": "dp4a"}


@pytest.mark.parametrize("name", list(CONV_ROUTES))
def test_mac_conv2d_route_of_each_fig22_23_layer(name):
    g = next(g for n, kind, g in dnn_layers.LAYERS if n == name)
    x_shape = (1, g["h"], g["w"], g["cin"])
    w_shape = (g["kh"], g["kw"], g["cin"], g["cout"])
    assert conv_route(x_shape, w_shape) == CONV_ROUTES[name]
    x = torch.zeros(x_shape[:1] + (g["kh"], g["kw"], g["cin"]),
                    dtype=torch.int8)
    assert conv_route(x, torch.zeros(w_shape, dtype=torch.int8)) == \
        CONV_ROUTES[name]


# ------------------------------------------------------------------ attention

def _fold(t):
    B, S, H, D = t.shape
    return t.transpose(0, 2, 1, 3).reshape(B * H, S, D)


def _j_attention(q, k, v, causal=True):
    B, S, H, D = q.shape
    out = j_flash_attention_ref(*(jnp.asarray(_fold(t)) for t in (q, k, v)),
                                causal=causal)
    return np.asarray(out).reshape(B, H, S, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_flash_attention_matches_reference(shape, causal):
    rng = np.random.default_rng(sum(shape))
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    got = flash_attention_kernel(*(torch.from_numpy(t) for t in (q, k, v)),
                                 causal=causal, bq=32, bk=32)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _j_attention(q, k, v, causal),
                               **F32_TOL)


def test_flash_attention_bf16_io():
    """bfloat16 in and out against the float32 reference (the
    reference's test_bf16_io)."""
    rng = np.random.default_rng(5)
    qkv = [torch.from_numpy(rng.standard_normal((1, 64, 2, 16)).astype(
        np.float32)).bfloat16() for _ in range(3)]
    got = flash_attention_kernel(*qkv, bq=32, bk=32)
    assert got.dtype == torch.bfloat16
    want = _j_attention(*(t.float().numpy() for t in qkv))
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


CARD_BF16_TOL = dict(atol=4e-3, rtol=2 ** -7)   # chip_smoke.py's ATTN_TOL


def _bf16_kernel_arithmetic(q, k, v, causal):
    """The bfloat16 tensor-core kernel's arithmetic, written out on
    (B, S, H, D) bf16 tensors: Q K^T in float32 from the bf16 values, p in
    float32 and rounded to bf16 before P V, l summed from the float32 p,
    one bf16 rounding of the output."""
    B, S, H, D = q.shape
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / np.float32(np.sqrt(D))
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), vf)
    return (out / p.sum(-1, keepdim=True)).bfloat16().transpose(1, 2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 512, 2, 128), (2, 130, 3, 40)])
def test_flash_bf16_p_rounding_stays_in_card_tolerance(shape, causal):
    """Rounding p to bf16 before P V keeps the result within the card's
    bf16 limit of the reference (float32 on the same bf16 inputs)."""
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16() for _ in range(3))
    got = _bf16_kernel_arithmetic(q, k, v, causal)
    want = _j_attention(*(t.float().numpy() for t in (q, k, v)), causal)
    np.testing.assert_allclose(got.float().numpy(), want, **CARD_BF16_TOL)


def test_flash_attention_matches_pallas():
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 128, 2, 16)).astype(np.float32)
               for _ in range(3))
    got = flash_attention_kernel(*(torch.from_numpy(t) for t in (q, k, v)))
    want = np.asarray(j_flash_attention_kernel(
        *(jnp.asarray(t) for t in (q, k, v)), bq=32, bk=64))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_flash_attention_plain_version_on_folded_heads():
    """flash_attention_ref takes (B H, S, D) as the reference's does."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((3, 40, 8)).astype(np.float32)
               for _ in range(3))
    got = flash_attention_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                              causal=True)
    want = j_flash_attention_ref(*(jnp.asarray(t) for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_kernel(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_kernel(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="one"):
        flash_attention_kernel(q, q[:, :4], q)


def test_new_wrappers_count_no_launches_on_the_cpu():
    reset_launch_counts()
    fx_log(torch.ones(3, dtype=torch.int32))
    mac_conv2d(torch.ones(1, 4, 4, 2, dtype=torch.uint8),
               torch.ones(2, 2, 2, 3, dtype=torch.int8))
    flash_attention_kernel(*[torch.ones(1, 4, 1, 8)] * 3)
    counts = launch_counts()
    assert counts["fx_log"] == counts["mac_conv2d"] == \
        counts["flash_attention_kernel"] == 0


# ------------------------------------------------------------------ benchmarks

def _j_layer_rows(name, kind, g):
    """The reference's Fig. 22/23 rows of one layer, from its functions."""
    pe = JPESpec()
    if kind == "conv":
        _, _, n_tiles = j_partition(pe, **g)
        mac_cyc, arm_cyc = pe.mac_conv_cycles(**g), pe.arm_conv_cycles(**g)
    else:
        mac_cyc = pe.mac_mm_cycles(g["m"], g["k"], g["n"])
        arm_cyc = pe.arm_mm_cycles(g["m"], g["k"], g["n"])
        n_tiles = 1
    speedup = arm_cyc / mac_cyc
    rows = []
    for vdd, f, pl in J_PLS:
        t_mac, t_arm = mac_cyc / f, arm_cyc / f
        util = min(g.get("m", 64), 4) / 4.0 if kind == "mm" else 1.0
        gain = (t_arm * j_pe_power_w(vdd, f, mac=False)) / (
            t_mac * j_pe_power_w(vdd, f, mac=True, util=util))
        band = "116-610" if kind == "conv" else "9-28"
        eband = "148-652" if kind == "conv" else "297-482"
        rows.append((f"fig22_23_{name}_{pl}",
                     f"speedup={speedup:.0f}(paper_band={band});"
                     f"eff_gain={gain:.0f}(paper_band={eband});"
                     f"t_mac_us={t_mac*1e6:.0f};tiles={n_tiles}",
                     speedup, gain, t_mac * 1e6, n_tiles))
    return rows


def test_bench_layers_are_the_references():
    assert dnn_layers.LAYERS == J_LAYERS
    assert dnn_layers.PLS == J_PLS


@pytest.mark.parametrize("layer", J_LAYERS, ids=[n for n, _, _ in J_LAYERS])
def test_fig22_23_derived_fields_match_reference(layer):
    got = dnn_layers.layer_model(*layer)
    want = _j_layer_rows(*layer)
    assert [(n, d) for n, d, _ in got] == [(n, d) for n, d, *_ in want]
    for (_, _, v), (_, _, speedup, gain, t_mac_us, tiles) in zip(got, want):
        assert (v["speedup"], v["eff_gain"], v["t_mac_us"], v["tiles"]) == \
            (speedup, gain, t_mac_us, tiles)
    for vdd, f, _ in J_PLS:
        for mac in (True, False):
            assert dnn_layers._pe_power_w(vdd, f, mac=mac) == \
                j_pe_power_w(vdd, f, mac=mac)


def test_fig15_model_matches_reference():
    for (v, f), measured in j_paper.MAC_TOPS_PER_W.items():
        got = mac_efficiency.modeled_tops_per_w(v, f)
        assert got == j_modeled_tops_per_w(v, f)
        assert abs(got - measured) / measured < 0.10


def test_mac_efficiency_runs_on_the_cpu(capsys):
    rows = mac_efficiency.main(device="cpu")
    assert [r["name"] for r in rows] == [
        "fig14_coremark_50V_200MHz", "fig14_coremark_60V_400MHz",
        "fig15_mac_mm_50V_200MHz", "fig15_mac_mm_60V_400MHz",
        "fig15_mac_mm_50V_320MHz", "fig15_mac_mm_with_hw_bug"]
    assert all(r["values"]["within10pct"] for r in rows[2:5])
    assert all(r["device"] == "cpu" for r in rows)
    assert capsys.readouterr().out.splitlines()[2].startswith(
        "fig15_mac_mm_50V_200MHz,")


def test_dnn_layers_reduced_instances_run_on_the_cpu(capsys):
    rows = dnn_layers.main(device="cpu", reduced=True)
    assert len(rows) == 2 * len(J_LAYERS)
    want = [r for layer in J_LAYERS for r in _j_layer_rows(*layer)]
    assert [(r["name"], r["derived"]) for r in rows] == \
        [(n, d) for n, d, *_ in want]
    conv3 = rows[2 * 2]["values"]["shapes"]
    assert conv3 == [[1, 14, 14, 32], [3, 3, 32, 32]]
    assert rows[-1]["values"]["shapes"] == [[1, 512], [512, 128]]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(rows) and lines[0].startswith(
        "fig22_23_lenet_c1_PL2,")


def test_dnn_layer_operands_are_the_references_draws():
    """The reduced instances are the reference's arrays from seed 1."""
    for _, kind, g in J_LAYERS:
        rng = np.random.default_rng(1)
        if kind == "conv":
            h, w = min(g["h"], 14), min(g["w"], 14)
            cin, cout = min(g["cin"], 32), min(g["cout"], 32)
            want = (rng.integers(-128, 127, (1, h, w, cin)),
                    rng.integers(-128, 127, (g["kh"], g["kw"], cin, cout)))
        else:
            k, n = min(g["k"], 512), min(g["n"], 128)
            want = (rng.integers(-128, 127, (g["m"], k)),
                    rng.integers(-128, 127, (k, n)))
        got = dnn_layers.layer_operands(kind, g, reduced=True)
        for a, b in zip(got, want):
            assert a.dtype == np.int8
            np.testing.assert_array_equal(a, b.astype(np.int8))


def test_bench_entry_points_ask_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for bench in (mac_efficiency.main, dnn_layers.main):
        with pytest.raises(RuntimeError, match="CUDA device"):
            bench()
