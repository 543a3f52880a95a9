"""Synaptic plasticity rules: trace-based STDP and error-driven PES.

The paper motivates the PE's exponential-function accelerator as a
speedup for synaptic plasticity (Sec. III-B); this is the rule library.
Each rule has a fixed-point path in s16.15, the on-PE arithmetic
(eligibility traces decay by a factor the ``fx_exp`` kernel computes,
weights and traces stay int32, every multiply is ``fx_mul``'s hi/lo
split), and a float oracle (``*_ref``) with the same op order.

``STDP``: pair-based with pre/post eligibility traces.  Per tick the
traces decay by exp(-1/tau) and add this tick's spikes; every post spike
potentiates by ``a_plus * pre_trace``, every pre spike depresses by
``a_minus * post_trace``; weights clip to [``w_min``, ``w_max``] (s16.15,
1.0 == ``FX_ONE``).

``PES``: the NEF's error-driven decoder rule, ``d <- d - lr/n * a * e``
with ``a`` the filtered activity in Hz (an s16.15 trace) and ``e`` the
arrived error.  Zero error is an exact fixed point.  Decoders stay
float32, as on the Arm core.

Every function takes any leading batch axes: a group of same-shape
slots advances as one (G, ...) tensor.  The decay factor is a constant
of the rule: ``trace_decays_fx`` evaluates all of a run's taus with one
``fx_exp`` launch, and the steps take the resulting integers.

Energy: a weight update is a MAC-class op, a trace decay one accelerator
evaluation of ``EXP_ACC_CYCLES`` shift-add iterations.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import paper
from repro_torch.kernels.explog.ops import fx_exp, to_fx
from repro_torch.kernels.explog.ref import FX_ONE, wrap32
from repro_torch.kernels.lif.ref import FRAC, fx_mul

# one exp-accelerator evaluation = one shift-add iteration per ln(1+2^-k)
# table entry (a 16-entry table in s16.15)
EXP_ACC_CYCLES = 16


@dataclass(frozen=True)
class STDP:
    """Pair-based STDP on a SPIKE projection.  Time constants in ticks
    (1 tick = 1 ms); weights and bounds in the float domain."""
    a_plus: float = 0.02
    a_minus: float = 0.022
    tau_plus_ticks: float = 20.0
    tau_minus_ticks: float = 20.0
    w_min: float = 0.0
    w_max: float = 1.0
    w_init: float = 0.5

    def __post_init__(self):
        if not self.w_min <= self.w_init <= self.w_max:
            raise ValueError(
                f"STDP w_init {self.w_init} outside bounds "
                f"[{self.w_min}, {self.w_max}]")


@dataclass(frozen=True)
class PES:
    """Prescribed Error Sensitivity: error-driven NEF decoder learning on
    a GRADED projection (the decoders live on the source PE)."""
    learning_rate: float = 1e-5
    tau_ticks: float = 20.0            # activity-trace filter constant
    w_init: float = 0.0


PLASTICITY_RULES = (STDP, PES)


# ---------------------------------------------------------------------------
# Eligibility traces (s16.15 + float oracle)
# ---------------------------------------------------------------------------

def trace_decays_fx(taus, device=None) -> dict:
    """{tau: exp(-1/tau) in s16.15} for every tau of ``taus``, computed by
    ONE ``fx_exp`` launch on ``device`` (the CUDA device unless the
    caller asks for the CPU) and read back once."""
    taus = sorted(set(float(t) for t in taus))
    if not taus:
        return {}
    args = torch.as_tensor(to_fx(np.float32([-1.0 / t for t in taus])),
                           device=resolve_device(device))
    return dict(zip(taus, fx_exp(args).tolist()))


def trace_decay_fx(tau_ticks: float, device=None) -> int:
    """Per-tick decay factor exp(-1/tau) in s16.15, by the exp
    accelerator kernel."""
    return trace_decays_fx([tau_ticks], device)[float(tau_ticks)]


def fx_mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``fx_mul`` of int32 ``a`` by an int ``b`` as int32.  For 0 <= b <=
    FX_ONE (a decay factor, a learning amplitude below 1) no int32 product
    of the hi/lo split leaves the range, so int32 arithmetic is exact;
    any other ``b`` goes through the wrapping int64 path."""
    if 0 <= b <= FX_ONE:
        return (a >> FRAC) * b + (((a & 0x7FFF) * b) >> FRAC)
    return fx_mul(a.to(torch.int64), b).to(torch.int32)


def trace_step_fx(tr, spikes, decay: int):
    """tr: int32 s16.15 trace -> decayed by ``decay`` (``trace_decays_fx``)
    + FX_ONE per spike; the int32 sum wraps as the reference's does."""
    out = fx_mul32(tr.to(torch.int32), decay).to(torch.int64) \
        + spikes.to(torch.int64) * FX_ONE
    return wrap32(out).to(torch.int32)


def trace_step_ref(tr, spikes, tau_ticks: float):
    """Float oracle of ``trace_step_fx`` (same decay-then-add order)."""
    return tr * np.float32(np.exp(-1.0 / tau_ticks)) \
        + spikes.to(torch.float32)


def trace_to_hz(tr_fx, tau_ticks: float):
    """s16.15 trace -> filtered firing-rate estimate in Hz: a trace
    accumulating 1.0 a spike with decay alpha settles at rate/(1 - alpha)
    spikes a tick, so scale by (1 - alpha) * 1000."""
    one_m_alpha = 1.0 - float(np.exp(-1.0 / tau_ticks))
    return tr_fx.to(torch.float32) * (one_m_alpha * 1000.0 / FX_ONE)


# ---------------------------------------------------------------------------
# STDP weight update (s16.15 + float oracle)
# ---------------------------------------------------------------------------

def stdp_step_fx(w, pre_tr, post_tr, pre_spk, post_spk, rule: STDP,
                 decays: dict):
    """One tick of pair STDP in s16.15.  w (..., n_pre, n_post) int32;
    traces int32; spikes 0/1; ``decays`` from ``trace_decays_fx``.
    Returns (w, pre_tr, post_tr), traces advanced by this tick."""
    pre_tr = trace_step_fx(pre_tr, pre_spk, decays[rule.tau_plus_ticks])
    post_tr = trace_step_fx(post_tr, post_spk, decays[rule.tau_minus_ticks])
    pre_i = pre_spk.to(torch.int64)
    post_i = post_spk.to(torch.int64)
    pot = fx_mul32(pre_tr, int(round(rule.a_plus * FX_ONE))) \
        .to(torch.int64)[..., :, None] * post_i[..., None, :]
    dep = pre_i[..., :, None] \
        * fx_mul32(post_tr, int(round(rule.a_minus * FX_ONE)))[..., None, :]
    w = wrap32(wrap32(w.to(torch.int64) + pot) - dep).clamp(
        int(round(rule.w_min * FX_ONE)), int(round(rule.w_max * FX_ONE)))
    return w.to(torch.int32), pre_tr, post_tr


def stdp_step_ref(w, pre_tr, post_tr, pre_spk, post_spk, rule: STDP):
    """Float oracle of ``stdp_step_fx`` (identical op order)."""
    pre_tr = trace_step_ref(pre_tr, pre_spk, rule.tau_plus_ticks)
    post_tr = trace_step_ref(post_tr, post_spk, rule.tau_minus_ticks)
    pre_f = pre_spk.to(torch.float32)
    post_f = post_spk.to(torch.float32)
    pot = (rule.a_plus * pre_tr)[..., :, None] * post_f[..., None, :]
    dep = pre_f[..., :, None] * (rule.a_minus * post_tr)[..., None, :]
    w = torch.clamp(w + pot - dep, rule.w_min, rule.w_max)
    return w, pre_tr, post_tr


# ---------------------------------------------------------------------------
# PES decoder update (float: decoders live on the Arm core)
# ---------------------------------------------------------------------------

def pes_step(dec, act_hz, err, rule: PES, n_pre: int):
    """d <- d - lr/n * a e.  dec (..., n_pre, d); act_hz (..., n_pre);
    err (..., d).  Zero error is an exact fixed point."""
    return dec - (rule.learning_rate / n_pre) * act_hz[..., :, None] \
        * err[..., None, :].to(torch.float32)


# ---------------------------------------------------------------------------
# Energy pricing
# ---------------------------------------------------------------------------

def exp_op_energy_j(n_ops, pl: paper.PerfLevel = paper.PERF_LEVELS[2]):
    """Energy of ``n_ops`` exp-accelerator evaluations: EXP_ACC_CYCLES
    shift-add iterations each at the PL's per-cycle baseline energy."""
    return n_ops * EXP_ACC_CYCLES * pl.p_baseline_w / pl.freq_hz
