"""Processing-element abstraction (paper Sec. III-C, Fig. 7).

Captures the PE's resources and cycle model so benchmarks can translate
workloads into time/energy the way the test chip measurements do, and so
the DNN-layer benchmark can partition layers into 128 kB SRAM tiles
("we divide the layers to fit into the 128 kByte SRAM per PE").
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.configs import paper


@dataclass(frozen=True)
class PESpec:
    sram_bytes: int = paper.SRAM_BYTES
    mac_rows: int = paper.MAC_ROWS
    mac_cols: int = paper.MAC_COLS
    sram_port_bytes_per_clk: int = paper.SRAM_PORT_BYTES_PER_CLK
    noc_port_bytes_per_clk: int = paper.NOC_PORT_BYTES_PER_CLK

    @property
    def macs_per_cycle(self) -> int:
        return self.mac_rows * self.mac_cols              # 64

    def mac_mm_cycles(self, m: int, k: int, n: int) -> float:
        """MM mode: output-stationary over 16-wide x 4-tall output tiles;
        only min(m, 4) rows are active for skinny matrices; operand fetch at
        128 bit/clk must keep up (Sec. III-C)."""
        active = self.mac_cols * min(m, self.mac_rows)
        compute = m * k * n / active
        # A-operand streaming from SRAM: k bytes per output row tile
        fetch = (m / self.mac_rows) * k * np.ceil(n / self.mac_cols) \
            / self.sram_port_bytes_per_clk
        return max(compute, fetch)

    def mac_conv_cycles(self, h, w, cin, cout, kh, kw, stride=1) -> float:
        """CONV mode: shift-register IFM reuse relaxes fetch to 4 B / 4 clk."""
        ho, wo = h // stride, w // stride
        compute = ho * wo * cout * cin * kh * kw / self.macs_per_cycle
        fetch = h * w * cin / self.sram_port_bytes_per_clk / 4.0
        return max(compute, fetch)

    def arm_mm_cycles(self, m, k, n) -> float:
        """CMSIS-NN-class Arm M4F int8 fully-connected: SMLAD dual-MAC with
        load/loop overhead -> ~1.7 cycles/MAC (Lai et al. 2018)."""
        return m * k * n * 1.7

    def arm_conv_cycles(self, h, w, cin, cout, kh, kw, stride=1) -> float:
        """Arm q7 convolution: im2col + GEMM -> ~5 cycles/MAC effective
        (CMSIS-NN reports ~0.05 GMAC/s at 216 MHz on M4/M7-class cores),
        calibrated inside the 116-610x band of Fig. 22."""
        ho, wo = h // stride, w // stride
        macs = ho * wo * cout * cin * kh * kw
        return macs * 5.0 + ho * wo * cin * kh * kw

    def fits_sram(self, *tensors_bytes) -> bool:
        return sum(tensors_bytes) <= self.sram_bytes


@dataclass(frozen=True)
class QPESpec:
    pes: int = 4
    noc_freq_hz: float = paper.NOC_FREQ_HZ


def partition_layer_to_sram(pe: PESpec, h, w, cin, cout, kh, kw,
                            bytes_per=1):
    """Split (h x w x cin) -> (cout) conv into PE-sized tiles: returns
    (rows_per_tile, cout_per_tile, n_tiles) such that input tile + weights +
    output tile fit the 128 kB SRAM."""
    for cout_t in (cout, 64, 32, 16, 8, 4):
        if cout_t > cout:
            continue
        for rows in range(h, 0, -1):
            in_b = (rows + kh - 1) * w * cin * bytes_per
            w_b = kh * kw * cin * cout_t * bytes_per
            out_b = rows * w * cout_t * 4
            if in_b + w_b + out_b <= pe.sram_bytes:
                n_tiles = -(-h // rows) * -(-cout // cout_t)
                return rows, cout_t, n_tiles
    return 1, min(4, cout), h * -(-cout // 4)
