"""Event-triggered MAC layer: the paper's hybrid SNN/DNN mechanism
(Sec. II: "the MAC array could be run not frame-based, but in an
event-triggered fashion ... graded weight x graded activity-related
input").

A batch of graded spike events (values + active mask) hits an int8
weight matrix; only active rows are dispatched to the MAC array
(``kernels/mac_gemm``).  Energy is proportional to dispatched events
(activity), not to the frame size.
"""
from __future__ import annotations

import torch

from repro_torch.configs import paper
from repro_torch.core.quant import quantize_per_axis
from repro_torch.kernels.mac_gemm.ops import mac_gemm


def event_mac(values, active, wq, w_scale, *, capacity=None):
    """values: (T, K) float graded payloads; active: (T,) bool event mask;
    wq: (K, N) int8.  Returns (out (T, N) float32, n_dispatched).

    Inactive rows produce exact zeros and are never multiplied: active
    rows are compacted to a fixed-capacity buffer by one static-size sort
    (ascending ids, sentinel T after, as the reference's
    ``nonzero(size=C)``; no host synchronisation), multiplied, and
    scattered back.
    """
    T, K = values.shape
    C = capacity or T
    rows = torch.arange(T, dtype=torch.int32, device=values.device)
    idx = torch.sort(torch.where(active, rows, T)).values[:C].long()
    src = torch.cat([values.to(torch.float32),
                     values.new_zeros((1, K), dtype=torch.float32)])
    xq, x_scale = quantize_per_axis(src[idx], axis=1)
    acc = mac_gemm(xq, wq)
    yq = acc.to(torch.float32) * x_scale[:, None] * w_scale[None, :]
    out = torch.zeros((T + 1, wq.shape[1]), dtype=torch.float32,
                      device=values.device)
    out[idx] = yq                 # sentinel lanes all write row T, dropped
    return out[:T], active.sum(dtype=torch.int32)


def event_mac_tick(spikes, w_eff):
    """One tick of the event-triggered MAC: accumulate one weight row per
    spiking input.  spikes: (K,) 0/1 events arriving this tick; w_eff:
    (K, N) float32 dequantized weights.  Returns (out (N,), n_events):
    ticks with no events produce exact zeros and dispatch nothing."""
    s = spikes.to(torch.float32)
    return s @ w_eff, s.sum().to(torch.int32)


def event_mac_energy_j(n_events, k, n, *, tops_per_w=None):
    """Energy of event-triggered MAC ops from the paper's measured
    efficiency (Fig. 15: 1.47 TOPS/W at PL2)."""
    tops_per_w = tops_per_w or paper.MAC_TOPS_PER_W[(0.50, 200e6)]
    ops = 2.0 * float(n_events) * k * n
    return ops / (tops_per_w * 1e12)


def frame_mac_energy_j(t, k, n, **kw):
    """Energy of a frame-based (every row dispatched) MAC layer of ``t``
    rows: the event-triggered pricing with every row an event."""
    return event_mac_energy_j(t, k, n, **kw)
