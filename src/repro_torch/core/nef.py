"""Neural Engineering Framework ensemble (paper Sec. VI-C, Fig. 19).

The paper's hybrid SNN/DNN showcase, with the same split as the test
chip:

    encode  (vector -> input currents)  = matrix multiply  -> MAC array
    neuron update (spiking LIF)          = SNN path          -> Arm core
    decode  (spikes -> vector)           = event-based adds  -> Arm core

Encoding runs through the int8 MAC GEMM (``kernels/mac_gemm``) as the
test chip offloads it to its 16x4 array; the neuron update is the s16.15
LIF (``kernels/lif``); decoding accumulates the decoder rows of neurons
that spiked.  The decoder solve is numpy, as in the reference, so a
seed gives the reference's ensemble exactly.

Energy accounting implements both of the paper's synaptic-event metrics:
equivalent synops (N per input spike) and hardware ops (N*D MACs encode
+ M*D adds decode, M = spikers).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.quant import quantize_per_axis
from repro_torch.kernels.lif.ops import lif_params_fx, lif_step
from repro_torch.kernels.mac_gemm.ops import mac_gemm

FX_ONE = 1 << 15


@dataclass
class Ensemble:
    n_neurons: int
    dims: int
    encoders: np.ndarray       # (N, D) float64
    gains: np.ndarray          # (N,)
    biases: np.ndarray         # (N,)
    decoders: np.ndarray       # (N, D) float64
    lif: dict
    enc_q: torch.Tensor        # (D, N) int8: the MAC path's operand
    enc_scale: torch.Tensor    # (N,) float32
    tau_syn_ticks: float = 20.0

    @property
    def device(self) -> torch.device:
        return self.enc_q.device


def _lif_rate(J, tau_ref=0.002, tau_rc=0.02):
    """Steady-state LIF rate curve used for decoder solving (float)."""
    J = np.maximum(J, 1.0 + 1e-6)
    return 1.0 / (tau_ref + tau_rc * np.log1p(1.0 / (J - 1.0)))


def build_ensemble(n_neurons=512, dims=1, seed=0, tau_ms=20.0,
                   ref_ticks=2, device=None) -> Ensemble:
    """Nengo-style ensemble: numpy draws and decoder solve in the
    reference's order, then the LIF constants (exp kernel) and the int8
    encoders on ``device`` (the CUDA device unless the caller asks for
    the CPU)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((n_neurons, dims))
    enc /= np.linalg.norm(enc, axis=1, keepdims=True)
    intercepts = rng.uniform(-0.9, 0.9, n_neurons)
    max_rates = rng.uniform(200.0, 400.0, n_neurons)
    gains = (1.0 - 1.0 / (1.0 - np.exp((0.002 * max_rates - 1.0)
                                       / (0.02 * max_rates)))) \
        / (intercepts - 1.0)
    biases = 1.0 - gains * intercepts

    # decoder solve on sampled points (regularized least squares)
    xs = np.linspace(-1, 1, 256)[:, None] if dims == 1 else \
        rng.uniform(-1, 1, (512, dims))
    J = gains[None, :] * (xs @ enc.T) + biases[None, :]
    A = np.where(J > 1.0, _lif_rate(J), 0.0)             # (S, N)
    reg = 0.1 * A.max()
    G = A.T @ A + reg**2 * len(xs) * np.eye(n_neurons)
    dec = np.linalg.solve(G, A.T @ xs)                   # (N, D)

    lif = lif_params_fx(tau_ms=tau_ms, v_th=1.0, v_reset=0.0,
                        ref_ticks=ref_ticks, device=device)
    enc_w = torch.as_tensor((gains[:, None] * enc).T.astype(np.float32),
                            device=device)               # (D, N)
    enc_q, enc_scale = quantize_per_axis(enc_w, axis=0)
    return Ensemble(n_neurons, dims, enc, gains, biases, dec, lif,
                    enc_q=enc_q, enc_scale=enc_scale)


def ensemble_from_numpy(ens, device=None) -> Ensemble:
    """The port's ``Ensemble`` from any object with the reference
    ensemble's fields (numpy encoders, gains, biases, decoders, enc_q,
    enc_scale; the ``lif`` dict), carried across onto ``device``."""
    device = resolve_device(device)
    return Ensemble(
        n_neurons=int(ens.n_neurons), dims=int(ens.dims),
        encoders=np.array(ens.encoders), gains=np.array(ens.gains),
        biases=np.array(ens.biases), decoders=np.array(ens.decoders),
        lif=dict(ens.lif),
        enc_q=torch.as_tensor(np.array(ens.enc_q, np.int8), device=device),
        enc_scale=torch.as_tensor(np.array(ens.enc_scale, np.float32),
                                  device=device),
        tau_syn_ticks=float(ens.tau_syn_ticks))


def encode_drive(ens: Ensemble, x_seq, *, use_mac=True) -> torch.Tensor:
    """(T, D) inputs (numpy, or a tensor) -> (T, N) int32 s16.15 per-tick
    membrane drive, on the ensemble's device.

    Encoding runs through the int8 MAC array (Fig. 19 left); the result
    is the discretization of dv/dt = (J - v)/tau_rc: v' = a v + (1-a) J.
    The float32 operations are the reference's, in its order, each
    Python constant rounded to float32 first (as JAX's weak types do), so
    the rounded drive is the reference's bit for bit.
    """
    dev = ens.device
    x = (x_seq.to(dev, torch.float32) if isinstance(x_seq, torch.Tensor)
         else torch.as_tensor(np.asarray(x_seq, np.float32), device=dev))
    if use_mac:
        xq, x_scale = quantize_per_axis(x, axis=1)
        acc = mac_gemm(xq, ens.enc_q)                    # (T, N) int32
        J = acc.to(torch.float32) * x_scale[:, None] * ens.enc_scale[None, :]
    else:
        J = x @ torch.as_tensor((ens.gains[:, None] * ens.encoders).T,
                                dtype=torch.float32, device=dev)
    J = J + torch.as_tensor(ens.biases, dtype=torch.float32,
                            device=dev)[None, :]
    alpha = ens.lif["alpha"] / FX_ONE
    return torch.round(J * (1.0 - alpha) * FX_ONE).to(torch.int32)


def run_channel(ens: Ensemble, x_seq: np.ndarray, *, dt_ms=1.0,
                use_mac=True):
    """Communication channel: the decoded output follows the input.

    x_seq: (T, D) inputs in [-1, 1].  Returns numpy ``xhat`` (T, D),
    ``spikes_per_tick`` (T,) and ``spikes`` (T, N)."""
    T, D = np.shape(x_seq)
    N, dev = ens.n_neurons, ens.device
    dec = torch.as_tensor(ens.decoders, dtype=torch.float32, device=dev)
    alpha_syn = float(np.exp(-1.0 / ens.tau_syn_ticks))
    drive_fx = encode_drive(ens, x_seq, use_mac=use_mac)
    v = torch.zeros(N, dtype=torch.int32, device=dev)
    ref = torch.zeros_like(v)
    xhat = torch.zeros(D, dtype=torch.float32, device=dev)
    xhats = torch.empty((T, D), dtype=torch.float32, device=dev)
    spikes = torch.empty((T, N), dtype=torch.int32, device=dev)
    for t in range(T):
        v, ref, spk = lif_step(v, ref, drive_fx[t], **ens.lif)
        # event-based decode: only spiking neurons contribute (Arm core)
        contrib = spk.to(torch.float32) @ dec
        # spikes/tick -> rate in Hz (decoders were solved against Hz)
        xhat = alpha_syn * xhat + (1 - alpha_syn) * contrib * (1000.0 / dt_ms)
        xhats[t], spikes[t] = xhat, spk
    return {"xhat": xhats.cpu().numpy(),
            "spikes_per_tick": spikes.sum(1).cpu().numpy(),
            "spikes": spikes.cpu().numpy()}


def synop_metrics(ens: Ensemble, spikes_per_tick: np.ndarray,
                  dyn_energy_per_tick_j: np.ndarray | float) -> dict:
    """The paper's two energy-per-synaptic-event metrics (Sec. VI-C)."""
    N, D = ens.n_neurons, ens.dims
    T = len(spikes_per_tick)
    e = np.broadcast_to(np.asarray(dyn_energy_per_tick_j, np.float64), (T,))
    # equivalent synops: if the NxN matrix were not factorized, each spike
    # causes N synaptic ops
    eq_synops = spikes_per_tick.astype(np.float64) * N
    # hardware ops: N*D MACs (encode) + M*D adds (decode)
    hw_ops = N * D + spikes_per_tick.astype(np.float64) * D
    return {
        "pj_per_eq_synop": float(e.sum() / max(eq_synops.sum(), 1) * 1e12),
        "pj_per_hw_synop": float(e.sum() / max(hw_ops.sum(), 1) * 1e12),
        "mean_rate_hz": float(spikes_per_tick.mean() / N / 1e-3),
    }
