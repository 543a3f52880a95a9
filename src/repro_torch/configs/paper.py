"""Constants measured/defined in the paper (Hoeppner et al. 2021).

Table I   — energy-model parameters of the SpiNNaker2 test chip PE.
Table II  — synfire chain network parameters.
Sec. VI-A — MAC array efficiency operating points.

A copy of ``repro.configs.paper`` without its accelerator roofline
constants, which describe other hardware than the port runs on.
"""
from __future__ import annotations

from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Performance levels (test chip, Sec. VI-B)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PerfLevel:
    name: str
    vdd: float          # V
    freq_hz: float      # Hz
    p_baseline_w: float     # P_BL,i  [W]   (Table I)
    e_neuron_j: float       # e_neur,i [J]  (Table I)
    e_synapse_j: float      # e_syn,i  [J]  (Table I)


PL1 = PerfLevel("PL1", 0.5, 100e6, 22.38e-3, 1.51e-9, 0.20e-9)
PL2 = PerfLevel("PL2", 0.5, 200e6, 29.72e-3, 1.50e-9, 0.20e-9)
PL3 = PerfLevel("PL3", 0.6, 400e6, 66.44e-3, 1.89e-9, 0.26e-9)
PERF_LEVELS = (PL1, PL2, PL3)

# Implementation operating points (Sec. IV-B): MEP & high-performance level.
MEP_VDD, MEP_FREQ = 0.50, 200e6
HIGH_VDD, HIGH_FREQ = 0.60, 400e6

# ---------------------------------------------------------------------------
# Synfire chain (Table II + Sec. VI-B)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SynfireParams:
    n_exc: int = 200                 # excitatory neurons per PE
    n_inh: int = 50                  # inhibitory neurons per PE
    neurons_per_core: int = 250
    synapses_per_core: int = 20_000
    avg_fan_out: int = 80
    fan_in_exc: int = 60             # presynaptic exc connections per neuron
    fan_in_inh: int = 25             # presynaptic inh connections per exc neuron
    l_th1: int = 17                  # spike-count threshold PL1 -> PL2
    l_th2: int = 59                  # spike-count threshold PL2 -> PL3
    delay_inh_ms: float = 8.0        # inh -> exc synaptic delay
    delay_exc_ms: float = 10.0       # exc -> next layer delay
    t_sys_ms: float = 1.0            # simulation tick
    n_pes: int = 8                   # test chip: 2 QPEs = 8 PEs, ring


SYNFIRE = SynfireParams()

# Paper Table III reference results (mW) for validation
TABLE_III = {
    "only_pl3": {"baseline": 66.4, "neuron": 3.3, "synapse": 1.6, "total": 71.3},
    "dvfs": {"baseline": 24.3, "neuron": 2.6, "synapse": 1.3, "total": 28.2},
    "reduction": {"baseline": 0.634, "neuron": 0.212, "synapse": 0.187, "total": 0.604},
}

# ---------------------------------------------------------------------------
# PE / MAC array (Sec. III-C, VI-A)
# ---------------------------------------------------------------------------

MAC_ROWS, MAC_COLS = 4, 16           # 16x4 MAC array, 64 MACs/cycle
MAC_OPS_PER_CYCLE = 2 * MAC_ROWS * MAC_COLS   # 1 MAC = 2 ops
SRAM_BYTES = 128 * 1024              # 128 kB local SRAM per PE
SRAM_PORT_BYTES_PER_CLK = 16         # 128 bit / clk local SRAM port
NOC_PORT_BYTES_PER_CLK = 16          # 128 bit / clk NoC port

# Measured MAC efficiency (Fig. 15); the hardware data-transfer bug divides
# achieved TOPS/W by ~1.56.
MAC_TOPS_PER_W = {
    (0.50, 200e6): 1.47,
    (0.60, 400e6): 1.51,
    (0.50, 320e6): 1.75,
}
MAC_HW_BUG_FACTOR = 1.56

# CoreMark processor efficiency (Fig. 14), uW/MHz
COREMARK_UW_PER_MHZ = {(0.50, 200e6): 16.68, (0.60, 400e6): 20.16}

# NoC (Sec. III-A)
DNOC_FLIT_BITS = 192
CNOC_FLIT_BITS = 32
NOC_HOP_CYCLES = 5
NOC_FREQ_HZ = 400e6
NOC_PAYLOAD_BITS_MAX = 128

# Loihi comparison point (Sec. VI-C): 24 pJ / synaptic op
LOIHI_PJ_PER_SYNOP = 24.0

# NEF neuron-update dynamic energy (Sec. VI-C).  The Table I e_neur
# (1.5 nJ) was measured on the SNN benchmark whose per-neuron work includes
# the event-driven synapse-FIFO walk; the NEF neuron loop only integrates
# the MAC-array-precomputed current.  Calibrated against the paper's own
# reported operating point (~10 pJ per equivalent synop at 512 neurons).
NEF_E_NEURON_J = 0.5e-9

# ---------------------------------------------------------------------------
# Cycle model for the SNN engine (used to compute t_sp in Eq. (1)).
# Derived from Table I: the dynamic energy per neuron/synapse update and the
# baseline powers imply per-update service times on the order of hundreds of
# processor cycles, consistent with SpiNNaker-1 software loops [8,9].
# ---------------------------------------------------------------------------
CYCLES_PER_NEURON_UPDATE = 100
CYCLES_PER_SYN_EVENT = 32
CYCLES_TICK_OVERHEAD = 2_000         # wake-up, FIFO drain, bookkeeping
