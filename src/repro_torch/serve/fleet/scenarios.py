"""Served workloads: stimulus-streaming semantics for the fleet engine.

The two scenarios Yan et al. (arXiv:2009.08921) frame as one-user-per-
instance services, rebuilt as *served* graphs:

* **adaptive control**: each user session is a closed PES-learning
  control loop; the session streams its reference signal r(t) in, the
  instance tracks it through the mesh (NEF ensemble -> decoded control ->
  plant -> error back over a graded projection) and streams the plant
  state and tracking error out.  Decoders adapt on-mesh per session.
* **keyword spotting (KWS)**: each session streams an audio-like
  waveform (one of ``n_keywords`` synthetic keyword templates) into a
  hybrid NEF -> event-MAC channel farm; the instance streams the MAC
  layer's hidden activations out, and the response summarises them into
  a per-request score vector.

Where the stimulus lives is what makes them served: a served semantics
carries the stimulus in its state (``state["stim"]``), a per-session
window of the input stream (the raw signal and its int8-MAC s16.15
encoding), and the tick reads it at ``t mod window``.  The fleet engine
replaces the windows between scheduling rounds, every resident
session's in one encode (``stim_windows``: one host-to-device copy and
one ``mac_gemm`` launch), and a checkpoint of the state snapshots the
in-flight input with the neuron and learn state.  A plain
``ChipSim.run`` of the same program needs no engine change:
``init_state`` preloads the default stimulus, so a fleet of one equals
the unbatched engine bit for bit.

Each semantics has two ticks built from one body: ``make_tick`` (one
instance, host tick ``t``) and ``make_batched_tick`` (a fleet, ``t`` a
(w,) device tensor of each instance's local tick), whose every state
and record tensor has a leading (w,) axis.  The body indexes the window
per instance and has no host synchronisation and no data-dependent
branch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.chip.compile import ChipProgram
from repro_torch.chip.graph import (GRADED, NetGraph, Population,
                                    Projection, mac_dynamic_energy_j)
from repro_torch.core.nef import Ensemble, build_ensemble, encode_drive
from repro_torch.core.quant import quantize_per_axis
from repro_torch.kernels.lif.ops import lif_step
from repro_torch.learn.engine import init_learn_state, mean_scale
from repro_torch.learn.rules import PES


def stim_windows(ens: Ensemble, signals) -> dict:
    """Stimulus windows of several sessions at once: (w, n) signals ->
    {"r": (w, n) float32, "drive": (w, n, N) int32 s16.15 MAC-encoded
    drive}, on the ensemble's device, in one host-to-device copy and one
    encode.  ``encode_drive`` quantizes each time step on its own (a
    per-row int8 scale), so any stack of windows encodes bit for bit as
    each window alone, and a streamed stimulus as the same one
    preloaded."""
    r = torch.as_tensor(np.asarray(signals, np.float32), device=ens.device)
    w, n = r.shape
    drive = encode_drive(ens, r.reshape(w * n, 1), use_mac=True)
    return {"r": r, "drive": drive.reshape(w, n, -1)}


def _as_stim(r, ens: Ensemble) -> dict:
    """One stimulus window: the raw signal and its encoded drive."""
    win = stim_windows(ens, np.asarray(r, np.float32)[None])
    return {"r": win["r"][0], "drive": win["drive"][0]}


def blank_stim(ens: Ensemble, n_ticks: int) -> dict:
    """The idle-slot stimulus: silence (and its encoding)."""
    return _as_stim(np.zeros(n_ticks, np.float32), ens)


def _stim_state(stim: dict, device) -> dict:
    return {"r": torch.as_tensor(stim["r"], device=device),
            "drive": torch.as_tensor(stim["drive"], device=device)}


def _window_reader(batched: bool, device):
    """``read(stim, t) -> (drive (..., N), r (...))``: tick ``t`` of the
    stimulus window, at ``t mod window`` of each instance."""
    if not batched:
        def read(stim, t: int):
            i = t % stim["r"].shape[-1]
            return stim["drive"][i], stim["r"][i]
        return read
    rows: dict = {}

    def read_batched(stim, t):
        w = t.shape[0]
        if w not in rows:
            rows[w] = torch.arange(w, device=device)
        i = t % stim["r"].shape[-1]
        return stim["drive"][rows[w], i], stim["r"][rows[w], i]
    return read_batched


# -------------------------------------------------------------------------
# Session input streams
# -------------------------------------------------------------------------

@dataclass
class SineStream:
    """One user's input stream: an amp/period/phase sine drawn from the
    session seed (the Yan et al. stimulus class, one parameterization per
    user).  ``signal(t0, n)`` is ticks [t0, t0+n) of it, ``segment(t0,
    n)`` the same as a stimulus window: deterministic in (seed, t0, n),
    so a preempted session regenerates exactly the input it would have
    seen."""
    ens: Ensemble
    seed: int
    keyword: Optional[int] = None         # KWS: index into the period table
    periods: tuple = (64.0, 96.0, 144.0, 216.0)
    # control references are SLOW sines (trackable through the loop's
    # 2-tick transport delay); keyword waveforms are fast enough to
    # separate spike patterns per class
    period_range: tuple = (512.0, 2048.0)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        if self.keyword is None:
            self.amp = float(rng.uniform(0.3, 0.9))
            self.period = float(rng.uniform(*self.period_range))
        else:                              # keyword template + user timbre
            self.amp = float(rng.uniform(0.6, 0.9))
            self.period = float(self.periods[self.keyword
                                             % len(self.periods)])
        self.phase = float(rng.uniform(0.0, self.period))

    def signal(self, t0: int, n: int) -> np.ndarray:
        t = np.arange(t0, t0 + n, dtype=np.float64)
        return (self.amp * np.sin(2 * np.pi * (t + self.phase)
                                  / self.period)).astype(np.float32)

    def segment(self, t0: int, n: int) -> dict:
        return _as_stim(self.signal(t0, n), self.ens)


# -------------------------------------------------------------------------
# Served adaptive control (PES learning per session)
# -------------------------------------------------------------------------

@dataclass
class ServedAdaptiveSemantics:
    """The adaptive-control loop of ``repro_torch.learn.adaptive`` with
    the reference signal streamed through ``state["stim"]``.

    All K channels track the session's ONE reference (K redundant
    controllers per user); the rest (decode through the learn state,
    1-tick graded transport each way, PES error signals) is the
    ``AdaptiveControlSemantics`` tick."""
    ens: Ensemble
    n_channels: int
    default_stim: dict                    # {"r": (L,), "drive": (L, N)}
    plastic: bool = True
    tau_plant_ticks: float = 4.0
    t_sys_s: float = 1e-3
    frozen_decoders: Optional[np.ndarray] = None

    def slot_name(self, k: int) -> str:
        return f"nef{k}->plant{k}"

    def _pe_ids(self, program: ChipProgram):
        nef = np.array([program.pe_slices[f"nef{k}"].start
                        for k in range(self.n_channels)])
        pla = np.array([program.pe_slices[f"plant{k}"].start
                        for k in range(self.n_channels)])
        return nef, pla

    def init_state(self, program: ChipProgram, device):
        K, N = self.n_channels, self.ens.n_neurons

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        st = {"v": zeros(K, N, dtype=torch.int32),
              "ref": zeros(K, N, dtype=torch.int32),
              "u_filt": zeros(K), "u_buf": zeros(K), "err_buf": zeros(K),
              "y": zeros(K), "stim": _stim_state(self.default_stim, device)}
        if self.plastic:
            st["learn"] = init_learn_state(program, device)
        return st

    def make_tick(self, program: ChipProgram, *, dvfs, em, seed, noise,
                  device):
        return self._tick(program, dvfs, em, device, batched=False)

    def make_batched_tick(self, program: ChipProgram, *, dvfs, em, seed,
                          noise, device):
        return self._tick(program, dvfs, em, device, batched=True)

    def _tick(self, program, dvfs, em, device, batched: bool):
        ens = self.ens
        K, N = self.n_channels, ens.n_neurons
        P = program.n_pes
        alpha_syn = float(np.exp(-1.0 / ens.tau_syn_ticks))
        k_p = 1.0 / self.tau_plant_ticks
        nef_np, pla_np = self._pe_ids(program)

        def per_pe(nef_val, pla_val):
            out = np.zeros(P, np.float32)
            out[nef_np], out[pla_np] = nef_val, pla_val
            return torch.as_tensor(out, device=device)

        # static per-PE rows: one packet from every loop PE a tick, the
        # FIFO fill and so the performance level
        n_neur = per_pe(N, 1.0).to(torch.int32)
        packets = per_pe(1.0, 1.0)
        fifo = per_pe(N, 1.0)
        pl = dvfs.select_pl(fifo.to(torch.int32))
        pl3 = torch.full((P,), 2, dtype=torch.int32, device=device)
        # (..., K) nef values -> (..., P) rows by one gather
        perm_np = np.full(P, K, np.int64)
        perm_np[nef_np] = np.arange(K)
        perm = torch.as_tensor(perm_np, device=device)
        z1 = torch.zeros(1, dtype=torch.float32, device=device)
        dec_scale = mean_scale(K * N)
        names = tuple(self.slot_name(k) for k in range(K))
        if not self.plastic:
            d_frozen = torch.as_tensor(
                self.frozen_decoders if self.frozen_decoders is not None
                else np.zeros(N), dtype=torch.float32, device=device)
        read = _window_reader(batched, device)

        def tick(state, t):
            stim = state["stim"]
            drive, r_now = read(stim, t)                  # (..., N), (...)
            lead = r_now.shape
            dfx = drive.unsqueeze(-2).expand(lead + (K, N)).contiguous()
            v, ref, spk = lif_step(state["v"], state["ref"], dfx, **ens.lif)
            spk_f = spk.to(torch.float32)                 # (..., K, N)
            n_spk = spk_f.sum(-1)                         # (..., K)

            # decode with the CURRENT decoders (the engine advances the
            # learn state after this tick)
            if self.plastic:
                lstate = state["learn"]
                d_all = lstate.stacked(names, "w")[..., 0]
            else:
                d_all = d_frozen.expand(lead + (K, N))
            contrib = (spk_f * d_all).sum(-1)             # (..., K)
            u = alpha_syn * state["u_filt"] \
                + (1 - alpha_syn) * contrib * 1000.0

            # the plant consumes LAST tick's control (1-tick transport)
            y = state["y"] + (state["u_buf"] - state["y"]) * k_p
            r_k = r_now.unsqueeze(-1).expand(lead + (K,))
            e_now = y - r_k
            e_arr = state["err_buf"]     # error arriving at nef this tick

            snn_ev = torch.cat([n_spk, z1.expand(lead + (1,))],
                               -1)[..., perm]
            e_dvfs = em.tick_energy(pl, n_neur, snn_ev, dvfs=True)
            e_pl3 = em.tick_energy(pl3, n_neur, snn_ev, dvfs=False)
            rows = lead + (P,)
            rec = {
                "packets": packets.expand(rows),
                "pl": pl.expand(rows),
                "n_fifo": fifo.expand(rows),
                "syn_events": snn_ev,
                "n_spk": n_spk.sum(-1),
                "u": u,
                "y": y,
                "r": r_k,
                "track_err": e_now.abs(),
                "dec_norm": d_all.abs().sum((-2, -1)) * dec_scale,
                "e_dvfs_baseline": e_dvfs["baseline"],
                "e_dvfs_neuron": e_dvfs["neuron"].expand(rows),
                "e_dvfs_synapse": e_dvfs["synapse"],
                "e_pl3_baseline": e_pl3["baseline"],
                "e_pl3_neuron": e_pl3["neuron"].expand(rows),
                "e_pl3_synapse": e_pl3["synapse"],
            }
            if self.plastic:
                rec[lstate.signal_key(names, "pre")] = spk_f
                rec[lstate.signal_key(names, "err")] = e_arr[..., None]

            new_state = {"v": v, "ref": ref, "u_filt": u, "u_buf": u,
                         "err_buf": e_now, "y": y, "stim": stim}
            if self.plastic:
                new_state["learn"] = lstate   # the engine advances it
            return new_state, rec

        return tick


def served_adaptive_graph(n_channels: int = 1, n_neurons: int = 64,
                          stim: dict | None = None, stim_len: int = 32,
                          seed: int = 0, learning_rate: float = 3e-6,
                          plastic: bool = True, *,
                          ens: Ensemble | None = None,
                          device=None) -> NetGraph:
    """The adaptive-control service graph: the populations and
    projections of ``adaptive_control_graph`` with stimulus-streaming
    semantics.  The default stimulus (``stim`` or ``stim_len`` ticks of
    silence) sizes the window every streamed segment must match.
    ``ens`` (else built from ``seed`` on ``device``, the CUDA device
    unless the caller asks for the CPU) is the NEF ensemble."""
    ens = ens or build_ensemble(n_neurons, 1, seed=seed, device=device)
    stim = stim if stim is not None else blank_stim(ens, stim_len)

    nef_sram = n_neurons * (3 * 4 + 2 * 4) + n_neurons * 4 * 2
    plant_sram = 64
    pops = ([Population(name=f"nef{k}", n=n_neurons, sram_bytes=nef_sram)
             for k in range(n_channels)]
            + [Population(name=f"plant{k}", n=1, sram_bytes=plant_sram)
               for k in range(n_channels)])
    rule = PES(learning_rate=learning_rate) if plastic else None
    projs = ([Projection(src=f"nef{k}", dst=f"plant{k}", payload=GRADED,
                         bits_per_packet=32, delay_ticks=1, plasticity=rule)
              for k in range(n_channels)]
             + [Projection(src=f"plant{k}", dst=f"nef{k}", payload=GRADED,
                           bits_per_packet=32, delay_ticks=1)
                for k in range(n_channels)])
    sem = ServedAdaptiveSemantics(ens=ens, n_channels=n_channels,
                                  default_stim=stim, plastic=plastic)
    return NetGraph(populations=pops, projections=projs, semantics=sem,
                    name=f"served_adaptive{n_channels}"
                         + ("" if plastic else "_frozen"))


# -------------------------------------------------------------------------
# Served keyword spotting (hybrid NEF -> event-MAC farm)
# -------------------------------------------------------------------------

@dataclass
class ServedKwsSemantics:
    """``HybridFarmSemantics`` with the drive streamed per session: all
    K channels of the instance integrate the session's ONE waveform, and
    the MAC layer's hidden activations are the streamed response."""
    ens: Ensemble
    w_eff: torch.Tensor                   # (N, hidden) float32 dequantized
    n_pairs: int
    default_stim: dict                    # {"r": (L,), "drive": (L, N)}
    bits_per_spike: int = 16
    t_sys_s: float = 1e-3

    def _pe_ids(self, program: ChipProgram):
        nef = np.array([program.pe_slices[f"nef{k}"].start
                        for k in range(self.n_pairs)])
        mlp = np.array([program.pe_slices[f"mlp{k}"].start
                        for k in range(self.n_pairs)])
        return nef, mlp

    def init_state(self, program: ChipProgram, device):
        K, N = self.n_pairs, self.ens.n_neurons
        return {"v": torch.zeros((K, N), dtype=torch.int32, device=device),
                "ref": torch.zeros((K, N), dtype=torch.int32, device=device),
                "spike_buf": torch.zeros((K, N), dtype=torch.float32,
                                         device=device),
                "stim": _stim_state(self.default_stim, device)}

    def make_tick(self, program: ChipProgram, *, dvfs, em, seed, noise,
                  device):
        return self._tick(program, dvfs, em, device, batched=False)

    def make_batched_tick(self, program: ChipProgram, *, dvfs, em, seed,
                          noise, device):
        return self._tick(program, dvfs, em, device, batched=True)

    def _tick(self, program, dvfs, em, device, batched: bool):
        ens = self.ens
        K, N, D = self.n_pairs, ens.n_neurons, ens.dims
        P = program.n_pes
        w_eff = self.w_eff.to(device)
        hidden = w_eff.shape[1]
        nef_np, mlp_np = self._pe_ids(program)
        n_neur_np = np.zeros(P, np.int32)
        n_neur_np[nef_np] = N
        n_neur = torch.as_tensor(n_neur_np, device=device)
        pl3 = torch.full((P,), 2, dtype=torch.int32, device=device)
        # every per-PE record row is (nef values | mlp values | 0
        # elsewhere): one gather through this (P,) table places it
        perm_np = np.full(P, 2 * K, np.int64)
        perm_np[nef_np] = np.arange(K)
        perm_np[mlp_np] = K + np.arange(K)
        perm = torch.as_tensor(perm_np, device=device)
        z1 = torch.zeros(1, dtype=torch.float32, device=device)
        zk1 = torch.zeros(K, dtype=torch.float32, device=device)
        n_k = torch.full((K,), float(N), device=device)
        read = _window_reader(batched, device)

        def tick(state, t):
            stim = state["stim"]
            drive, r_now = read(stim, t)
            lead = r_now.shape
            zk = zk1.expand(lead + (K,))
            z = z1.expand(lead + (1,))

            def place2(nef_vals, mlp_vals):
                """(..., K) nef values + (..., K) mlp values -> (..., P)."""
                return torch.cat([nef_vals, mlp_vals, z], -1)[..., perm]

            dfx = drive.unsqueeze(-2).expand(lead + (K, N)).contiguous()
            v, ref, spk = lif_step(state["v"], state["ref"], dfx, **ens.lif)
            spk_f = spk.to(torch.float32)                 # (..., K, N)
            n_spk = spk_f.sum(-1)                         # (..., K)
            active = (n_spk > 0).to(torch.float32)
            bits_out = self.bits_per_spike * n_spk

            # MLP PEs consume last tick's spike vectors (1-tick transport)
            arr = state["spike_buf"]                      # (..., K, N)
            h = arr @ w_eff                               # (..., K, hidden)
            n_arr = arr.sum(-1)                           # (..., K)
            mac_events = n_arr * hidden
            bits_in = self.bits_per_spike * n_arr

            fifo = place2(n_k.expand(lead + (K,)), n_arr)
            pl = dvfs.select_pl(fifo.to(torch.int32))
            snn_ev = place2(n_spk * D, zk)
            syn_ev = place2(n_spk * D, mac_events)
            e_dvfs = em.tick_energy(pl, n_neur, snn_ev, dvfs=True)
            e_pl3 = em.tick_energy(pl3, n_neur, snn_ev, dvfs=False)
            e_mac = place2(zk, mac_dynamic_energy_j(mac_events))

            rec = {
                "packets": place2(active, zk),
                "payload_bits": place2(bits_out, zk),
                "graded_bits_out": place2(bits_out, zk),
                "graded_bits_in": place2(zk, bits_in),
                "pl": pl,
                "n_fifo": fifo,
                "syn_events": syn_ev,
                "n_spk": n_spk.sum(-1),
                "hidden_out": h,
                "e_dvfs_baseline": e_dvfs["baseline"],
                "e_dvfs_neuron": e_dvfs["neuron"],
                "e_dvfs_synapse": e_dvfs["synapse"] + e_mac,
                "e_pl3_baseline": e_pl3["baseline"],
                "e_pl3_neuron": e_pl3["neuron"].expand(lead + (P,)),
                "e_pl3_synapse": e_pl3["synapse"] + e_mac,
            }
            return {"v": v, "ref": ref, "spike_buf": spk_f,
                    "stim": stim}, rec

        return tick


def served_kws_graph(n_pairs: int = 1, n_neurons: int = 64,
                     hidden: int = 16, stim: dict | None = None,
                     stim_len: int = 32, seed: int = 0, *,
                     ens: Ensemble | None = None, device=None) -> NetGraph:
    """The KWS service graph: ``hybrid_farm_graph``'s populations with
    stimulus-streaming semantics (one user waveform into all channels),
    on ``device`` (the CUDA device unless the caller asks for the CPU);
    ``ens`` (else built from ``seed``) is the NEF ensemble."""
    ens = ens or build_ensemble(n_neurons, 1, seed=seed, device=device)
    stim = stim if stim is not None else blank_stim(ens, stim_len)
    rng = np.random.default_rng(seed)
    w = torch.as_tensor((rng.standard_normal((n_neurons, hidden))
                         * 0.1).astype(np.float32), device=ens.device)
    wq, ws = quantize_per_axis(w, axis=0)
    w_eff = wq.to(torch.float32) * ws[None, :]

    nef_sram = n_neurons * (3 * 4 + 2 * 4)
    mlp_sram = n_neurons * hidden + hidden * 4 + n_neurons // 8
    pops = ([Population(name=f"nef{k}", n=n_neurons, sram_bytes=nef_sram)
             for k in range(n_pairs)]
            + [Population(name=f"mlp{k}", n=hidden, sram_bytes=mlp_sram)
               for k in range(n_pairs)])
    projs = [Projection(src=f"nef{k}", dst=f"mlp{k}", payload=GRADED,
                        bits_per_packet=16 * n_neurons, delay_ticks=1)
             for k in range(n_pairs)]
    sem = ServedKwsSemantics(ens=ens, w_eff=w_eff, n_pairs=n_pairs,
                             default_stim=stim)
    return NetGraph(populations=pops, projections=projs, semantics=sem,
                    name=f"served_kws{n_pairs}")


# -------------------------------------------------------------------------
# The scenario catalog the fleet engine serves from
# -------------------------------------------------------------------------

@dataclass
class ServedScenario:
    """Everything the fleet engine needs to serve one workload class:
    how to build the program for a given stimulus window, how to open a
    session's input stream, which per-tick rec keys stream back to the
    user, and how to summarise a finished session into a response."""
    name: str
    ens: Ensemble
    build_graph: Callable                 # (stim) -> NetGraph
    make_stream: Callable                 # (seed) -> SineStream
    output_keys: tuple
    response: Callable = None             # ({key: (T, ...) np}) -> dict

    @property
    def device(self) -> torch.device:
        return self.ens.device

    def graph(self, stim_len: int, stim: dict | None = None) -> NetGraph:
        return self.build_graph(stim if stim is not None
                                else blank_stim(self.ens, stim_len))

    def stream(self, seed: int):
        return self.make_stream(seed)


def adaptive_scenario(n_channels: int = 1, n_neurons: int = 64,
                      seed: int = 0, learning_rate: float = 3e-6,
                      plastic: bool = True, device=None) -> ServedScenario:
    """Adaptive-control-as-a-service: per-session PES learning, on
    ``device`` (the CUDA device unless the caller asks for the CPU)."""
    ens = build_ensemble(n_neurons, 1, seed=seed, device=device)

    def build(stim):
        return served_adaptive_graph(n_channels, n_neurons, stim=stim,
                                     seed=seed, learning_rate=learning_rate,
                                     plastic=plastic, ens=ens)

    def response(outs: dict) -> dict:
        err = np.asarray(outs["track_err"])         # (T, K)
        tail = max(1, len(err) // 4)
        return {"final_err": float(err[-tail:].max(axis=1).mean()),
                "initial_err": float(err[:tail].max(axis=1).mean())}

    return ServedScenario(
        name=f"adaptive{n_channels}ch", ens=ens, build_graph=build,
        make_stream=lambda seed: SineStream(ens, seed),
        output_keys=("u", "y", "r", "track_err"), response=response)


def kws_scenario(n_pairs: int = 1, n_neurons: int = 64, hidden: int = 16,
                 n_keywords: int = 4, seed: int = 0,
                 device=None) -> ServedScenario:
    """Keyword spotting on the hybrid farm: each session streams one of
    ``n_keywords`` waveform templates; the response is the time-mean
    hidden-activation profile (the per-request score vector)."""
    ens = build_ensemble(n_neurons, 1, seed=seed, device=device)

    def build(stim):
        return served_kws_graph(n_pairs, n_neurons, hidden, stim=stim,
                                seed=seed, ens=ens)

    def make_stream(session_seed: int):
        kw = int(np.random.default_rng(session_seed).integers(n_keywords))
        return SineStream(ens, session_seed, keyword=kw)

    def response(outs: dict) -> dict:
        h = np.asarray(outs["hidden_out"])          # (T, K, hidden)
        scores = np.abs(h).mean(axis=(0, 1))        # (hidden,)
        return {"scores": scores.round(5).tolist(),
                "top_unit": int(scores.argmax()),
                "spikes": float(np.asarray(outs["n_spk"]).sum())}

    return ServedScenario(
        name=f"kws{n_pairs}ch", ens=ens, build_graph=build,
        make_stream=make_stream, output_keys=("hidden_out", "n_spk"),
        response=response)


SCENARIOS = {"adaptive": adaptive_scenario, "kws": kws_scenario}
