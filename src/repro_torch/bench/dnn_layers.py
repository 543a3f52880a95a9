"""Fig. 22 + Fig. 23: DNN layer speedup and energy-efficiency gain of the
MAC accelerator vs an Arm CMSIS-NN implementation.

Layers from LeNet / VGG-16 / ResNet-50 / MobileNetV2 are partitioned to the
128 kB PE SRAM (``core/pe.py``) and timed with the PE cycle model at both
DVFS operating points.  Each layer also runs through the port's kernels
(``mac_conv2d`` for the conv rows, ``mac_gemm`` for the FC rows), held
bitwise against their plain versions: on the card at its full published
size, or with ``reduced=True`` at the reference's reduced instance (h, w
<= 14, cin, cout <= 32, FC k <= 512, n <= 128), which the CPU can afford.

Paper bands: conv speedup 116-610x, MM speedup 9-28x; efficiency gain
148-652x (conv) and 297-482x (FC).

    python -m repro_torch.bench.dnn_layers [--device cpu] [--reduced]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bench.common import check_equal, emit, time_call
from repro_torch.configs import paper
from repro_torch.core.pe import PESpec, partition_layer_to_sram
from repro_torch.kernels.mac_conv import mac_conv2d, mac_conv2d_ref
from repro_torch.kernels.mac_gemm import mac_gemm, mac_gemm_ref

# (name, kind, geometry)
LAYERS = [
    ("lenet_c1", "conv", dict(h=28, w=28, cin=1, cout=6, kh=5, kw=5)),
    ("lenet_c3", "conv", dict(h=14, w=14, cin=6, cout=16, kh=5, kw=5)),
    ("vgg16_conv3_256", "conv", dict(h=56, w=56, cin=256, cout=256, kh=3,
                                     kw=3)),
    ("resnet50_1x1_b2", "conv", dict(h=56, w=56, cin=64, cout=64, kh=1,
                                     kw=1)),
    ("resnet50_3x3_b2", "conv", dict(h=56, w=56, cin=64, cout=64, kh=3,
                                     kw=3)),
    ("mobilenetv2_pw", "conv", dict(h=56, w=56, cin=24, cout=144, kh=1,
                                    kw=1)),
    ("lenet_fc", "mm", dict(m=1, k=400, n=120)),
    ("vgg16_fc_tile", "mm", dict(m=1, k=4096, n=512)),
]

PLS = [(0.50, 200e6, "PL2"), (0.60, 400e6, "PL3")]
BANDS = {"conv": ((116, 610), (148, 652)), "mm": ((9, 28), (297, 482))}


def _pe_power_w(vdd, f, *, mac: bool, util: float = 1.0) -> float:
    """Per-power-lane power at (vdd, f) — the paper measures each rail's
    shunt separately (Sec. VI-D), so the Arm lane carries baseline + core
    dynamic while the MAC lane carries only the accelerator dynamic."""
    base = {0.50: paper.PL2.p_baseline_w, 0.60: paper.PL3.p_baseline_w}[vdd]
    if mac:
        # measured accelerator-lane efficiency (Fig. 15) -> J/op; the
        # 1.56x data-transfer bug stretches time, not per-op energy
        tops_w = paper.MAC_TOPS_PER_W[(vdd, f)]
        return util * 2 * 64 * f / (tops_w * 1e12)
    core_dyn = paper.COREMARK_UW_PER_MHZ[(vdd, f)] * 1e-6 * f / 1e6
    return base + core_dyn


def layer_model(name: str, kind: str, g: dict) -> list[tuple]:
    """The cycle and energy model of one layer at both PLs: per PL the
    row name, the reference's derived string and its numbers."""
    pe = PESpec()
    if kind == "conv":
        _, _, n_tiles = partition_layer_to_sram(pe, **g)
        mac_cyc = pe.mac_conv_cycles(**g)
        arm_cyc = pe.arm_conv_cycles(**g)
    else:
        mac_cyc = pe.mac_mm_cycles(g["m"], g["k"], g["n"])
        arm_cyc = pe.arm_mm_cycles(g["m"], g["k"], g["n"])
        n_tiles = 1
    speedup = arm_cyc / mac_cyc
    (lo, hi), (elo, ehi) = BANDS[kind]
    out = []
    for vdd, f, pl in PLS:
        t_mac = mac_cyc / f
        t_arm = arm_cyc / f
        util = min(g.get("m", 64), 4) / 4.0 if kind == "mm" else 1.0
        e_mac = t_mac * _pe_power_w(vdd, f, mac=True, util=util)
        e_arm = t_arm * _pe_power_w(vdd, f, mac=False)
        gain = e_arm / e_mac
        derived = (f"speedup={speedup:.0f}(paper_band={lo}-{hi});"
                   f"eff_gain={gain:.0f}(paper_band={elo}-{ehi});"
                   f"t_mac_us={t_mac*1e6:.0f};tiles={n_tiles}")
        out.append((f"fig22_23_{name}_{pl}", derived,
                    dict(speedup=speedup, speedup_band=[lo, hi],
                         eff_gain=gain, eff_gain_band=[elo, ehi],
                         t_mac_us=t_mac * 1e6, tiles=n_tiles)))
    return out


def layer_operands(kind: str, g: dict, reduced: bool):
    """The layer's int8 operands, as numpy arrays from the reference's
    seed: (x NHWC, w HWIO) for conv, (a, b) for FC; ``reduced`` cuts them
    to the reference's reduced instance."""
    cap = min if reduced else (lambda v, _: v)
    rng = np.random.default_rng(1)
    if kind == "conv":
        h, w = cap(g["h"], 14), cap(g["w"], 14)
        cin, cout = cap(g["cin"], 32), cap(g["cout"], 32)
        x = rng.integers(-128, 127, (1, h, w, cin)).astype(np.int8)
        wt = rng.integers(-128, 127, (g["kh"], g["kw"], cin, cout))
        return x, wt.astype(np.int8)
    k, n = cap(g["k"], 512), cap(g["n"], 128)
    a = rng.integers(-128, 127, (g["m"], k)).astype(np.int8)
    b = rng.integers(-128, 127, (k, n)).astype(np.int8)
    return a, b


def main(device=None, reduced: bool = False) -> list[dict]:
    """Print and return the Fig. 22/23 rows; each layer runs on
    ``device`` (default: the card) at full size, or at the reference's
    reduced instance."""
    dev = resolve_device(device)
    rows = []
    for name, kind, g in LAYERS:
        lhs, rhs = (torch.from_numpy(t).to(dev)
                    for t in layer_operands(kind, g, reduced))
        if kind == "conv":
            fn, ref = mac_conv2d, mac_conv2d_ref
        else:
            fn, ref = mac_gemm, mac_gemm_ref
        us = time_call(fn, lhs, rhs)
        check_equal(fn(lhs, rhs), ref(lhs, rhs), f"{name} {fn.__name__}")
        shapes = [list(lhs.shape), list(rhs.shape)]
        for row, derived, values in layer_model(name, kind, g):
            rows.append(emit(row, us, derived, dev, shapes=shapes,
                             **values))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's reduced layer instances")
    args = ap.parse_args()
    main(args.device, reduced=args.reduced)
