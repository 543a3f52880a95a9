"""Plain PyTorch version of the s16.15 LIF neuron update.

Exponential membrane decay (alpha = exp(-dt/tau) from the exp
accelerator), synaptic current injection, threshold/reset, refractory
hold.  The int32 products and sums wrap as the reference's do; they are
computed in int64 and wrapped explicitly (``wrap32``), so the result is
bit-identical to ``repro.kernels.lif.ref.lif_step_ref`` and to
``csrc/lif.cu`` for every input.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.explog.ref import wrap32

FRAC = 15


def fx_mul(a: torch.Tensor, b) -> torch.Tensor:
    """s16.15 multiply of int64 ``a`` by ``b`` as the reference's int32
    hi/lo split computes it, wraps included (int64 result)."""
    ah = a >> FRAC                      # arithmetic shift (floor)
    al = a & 0x7FFF
    return wrap32(wrap32(ah * b) + (wrap32(al * b) >> FRAC))


def lif_step_ref(v, ref_ct, i_syn, *, alpha, v_th, v_reset, ref_ticks,
                 v_min=None):
    """One 1 ms tick.  int32 s16.15 ``v`` and ``i_syn``, int32 counts
    ``ref_ct``.  ``v_min`` (optional, s16.15) is the inhibitory reversal
    floor.  Returns (v_new, ref_new, spikes), all int32."""
    v = v.to(torch.int64)
    rc = ref_ct.to(torch.int64)
    active = rc <= 0
    v1 = wrap32(fx_mul(v, alpha) + i_syn.to(torch.int64))
    if v_min is not None:
        v1 = torch.clamp(v1, min=v_min)
    spike = active & (v1 >= v_th)
    v_new = torch.where(spike, v_reset, torch.where(active, v1, v))
    ref_new = torch.where(spike, ref_ticks, torch.clamp(wrap32(rc - 1),
                                                        min=0))
    return (v_new.to(torch.int32), ref_new.to(torch.int32),
            spike.to(torch.int32))
