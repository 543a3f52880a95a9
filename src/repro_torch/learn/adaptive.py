"""Closed-loop adaptive control with on-mesh PES learning, and the STDP
pair: the workloads of the plasticity subsystem.

``adaptive_control_graph`` is the control loop Yan et al.
(arXiv:2009.08921) ran on a SpiNNaker 2 prototype with the NEF: a
spiking ensemble encodes the reference r(t), its decoded output u drives
a first-order plant y' = (u - y)/tau, and the tracking error e = y - r
closes the loop back to the ensemble, where PES adapts the decoders
online.  On the mesh that is K independent channels of two populations,
``nef{k}`` (ensemble + decoders) and ``plant{k}`` (plant + error), joined
by two GRADED projections: the decoded control value outbound (the
plastic one, ``PES``) and the error inbound, each a graded packet with a
1-tick transport delay.  All nef populations precede all plant
populations, so on a board most loops cross chip boundaries.

``stdp_pair_graph`` is the minimal STDP workload: a Poisson source
population spiking into a LIF population over a plastic SPIKE
projection.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.chip.chip import ChipSim, chip_power_table
from repro_torch.chip.compile import ChipProgram, compile as compile_graph
from repro_torch.chip.graph import GRADED, NetGraph, Population, Projection
from repro_torch.core.nef import Ensemble, build_ensemble, encode_drive
from repro_torch.kernels.explog.ref import FX_ONE
from repro_torch.kernels.lif.ops import lif_params_fx, lif_step
from repro_torch.learn.engine import init_learn_state, mean_scale
from repro_torch.learn.rules import PES, STDP


# -------------------------------------------------------------------------
# Adaptive control (PES): K closed loops over the mesh
# -------------------------------------------------------------------------

@dataclass
class AdaptiveControlSemantics:
    """Per-tick step of the K-channel adaptive-control loop.

    States batch the channel axis ((K, N) LIF tensors, one ``lif_step``
    launch for the whole farm).  Per channel and tick: the nef PE
    integrates the MAC-encoded reference drive, decodes its spikes
    through the CURRENT decoders (read from the learn state), low-pass
    filters them into the control u and sends it as one 32 b graded
    packet; the plant PE consumes LAST tick's u, advances y += (u - y) /
    tau_p and sends the error e = y - r back; the error arriving at the
    nef PE (one more tick later) is what the engine's PES step consumes,
    reported with the pre spikes for the group of the K slots at once.

    ``plastic=False``: the projections carry no rule and the decode uses
    ``frozen_decoders``, the frozen twin.
    """
    ens: Ensemble
    drive_fx: torch.Tensor               # (T, N) s16.15 encode of r(t)
    r_table: np.ndarray                  # (T,) reference signal
    n_channels: int
    plastic: bool = True
    tau_plant_ticks: float = 4.0
    bits_per_value: int = 32
    t_sys_s: float = 1e-3
    frozen_decoders: Optional[np.ndarray] = None   # (N,) used if frozen

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
              "u_filt": zeros(K), "u_buf": zeros(K),   # nef -> plant wire
              "err_buf": zeros(K),                     # plant -> nef wire
              "y": zeros(K)}
        if self.plastic:
            st["learn"] = init_learn_state(program, device)
        return st

    def make_tick(self, program: ChipProgram, *, dvfs, em, seed, noise,
                  device):
        ens = self.ens
        K, N = self.n_channels, ens.n_neurons
        P = program.n_pes
        drive = self.drive_fx.to(device)
        r = torch.as_tensor(np.asarray(self.r_table, np.float32),
                            device=device)
        T = drive.shape[0]
        # co-prime phase offsets decorrelate the channels
        offsets = torch.as_tensor((np.arange(K) * 31) % T, device=device)
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
        # (K,) nef values -> (P,) row by one gather, zero elsewhere
        perm_np = np.full(P, K, np.int64)
        perm_np[nef_np] = np.arange(K)
        perm = torch.as_tensor(perm_np, device=device)
        z1 = torch.zeros(1, dtype=torch.float32, device=device)
        dec_scale = mean_scale(K * N)
        # the K slots share one rule and shape: one group, one record a
        # signal
        names = tuple(self.slot_name(k) for k in range(K))
        if not self.plastic:
            d_frozen = torch.as_tensor(
                self.frozen_decoders if self.frozen_decoders is not None
                else np.zeros(N), dtype=torch.float32, device=device)

        def tick(state, t: int):
            tt = (offsets + t) % T
            dfx = drive[tt]                                   # (K, N)
            v, ref, spk = lif_step(state["v"], state["ref"], dfx, **ens.lif)
            spk_f = spk.to(torch.float32)                     # (K, N)
            n_spk = spk_f.sum(1)                              # (K,)

            # decode with the CURRENT decoders (the engine advances the
            # learn state after this tick)
            if self.plastic:
                lstate = state["learn"]
                d_all = lstate.stacked(names, "w")[..., 0]
            else:
                d_all = d_frozen.expand(K, N)
            contrib = (spk_f * d_all).sum(1)                  # (K,)
            u = alpha_syn * state["u_filt"] \
                + (1 - alpha_syn) * contrib * 1000.0

            # the plant consumes LAST tick's control (1-tick transport)
            y = state["y"] + (state["u_buf"] - state["y"]) * k_p
            r_now = r[tt]                                     # (K,)
            e_now = y - r_now
            e_arr = state["err_buf"]     # error arriving at nef this tick

            snn_ev = torch.cat([n_spk, z1])[perm]   # event-based decode
            e_dvfs = em.tick_energy(pl, n_neur, snn_ev, dvfs=True)
            e_pl3 = em.tick_energy(pl3, n_neur, snn_ev, dvfs=False)
            rec = {
                "packets": packets,
                "pl": pl,
                "n_fifo": fifo,
                "syn_events": snn_ev,
                "n_spk": n_spk.sum(),
                "u": u,
                "y": y,
                "r": r_now,
                "track_err": e_now.abs(),
                "dec_norm": d_all.abs().sum() * dec_scale,
                "e_dvfs_baseline": e_dvfs["baseline"],
                "e_dvfs_neuron": e_dvfs["neuron"],
                "e_dvfs_synapse": e_dvfs["synapse"],
                "e_pl3_baseline": e_pl3["baseline"],
                "e_pl3_neuron": e_pl3["neuron"],
                "e_pl3_synapse": e_pl3["synapse"],
            }
            if self.plastic:
                rec[lstate.signal_key(names, "pre")] = spk_f
                rec[lstate.signal_key(names, "err")] = e_arr[:, None]

            new_state = {"v": v, "ref": ref, "u_filt": u, "u_buf": u,
                         "err_buf": e_now, "y": y}
            if self.plastic:
                new_state["learn"] = lstate   # the engine advances it
            return new_state, rec

        return tick


def adaptive_control_graph(n_channels: int = 4, n_neurons: int = 100,
                           n_ticks: int = 1024, seed: int = 0,
                           learning_rate: float = 3e-6,
                           plastic: bool = True,
                           tau_plant_ticks: float = 4.0,
                           period: int = 2048, amp: float = 0.8,
                           device=None) -> NetGraph:
    """K closed adaptive-control loops as one graph (2K populations), on
    ``device`` (the CUDA device unless the caller asks for the CPU).

    The reference r(t) is a slow sine; its MAC-encoded drive table is
    shared by all channels at co-prime phase offsets.  ``plastic=False``
    builds the frozen twin (no rules, fixed decoders)."""
    ens = build_ensemble(n_neurons, 1, seed=seed, device=device)
    t = np.arange(n_ticks)
    r = amp * np.sin(2 * np.pi * t / period)
    drive_fx = encode_drive(ens, r[:, None], use_mac=True)

    nef_sram = n_neurons * (3 * 4 + 2 * 4) + n_neurons * 4 * 2   # + dec/tr
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
    sem = AdaptiveControlSemantics(
        ens=ens, drive_fx=drive_fx, r_table=r, n_channels=n_channels,
        plastic=plastic, tau_plant_ticks=tau_plant_ticks)
    return NetGraph(populations=pops, projections=projs, semantics=sem,
                    name=f"adaptive_control{n_channels}"
                         + ("" if plastic else "_frozen"))


def convergence_tick(track_err: np.ndarray, threshold: float,
                     window: int) -> int:
    """First tick after which the windowed mean of the worst channel's
    |error| stays below ``threshold`` for good (-1: never converges)."""
    worst = np.asarray(track_err).max(axis=1)            # (T,)
    if len(worst) < window:
        return -1
    kern = np.ones(window) / window
    smooth = np.convolve(worst, kern, mode="valid")      # (T - w + 1,)
    bad = np.flatnonzero(smooth >= threshold)
    if smooth[-1] >= threshold:
        return -1
    if not bad.size:
        return 0                                          # converged at t=0
    return int(bad[-1]) + window                          # in raw ticks


def adaptive_control_workload(n_channels: int = 4, n_neurons: int = 100,
                              n_ticks: int = 2048, board=None,
                              err_threshold: float = 0.1,
                              err_window: int = 64, seed: int = 0,
                              refine: bool = True, device=None,
                              **graph_kw) -> dict:
    """Build, compile and run the adaptive-control loop on ``device`` and
    report convergence and the learning-energy share.

    ``board=None`` compiles to one chip; a ``BoardSpec`` routes the same
    graph through ``compile_board``.  ``refine=False`` keeps the greedy
    graph-order partition (all nef populations fill the first chips), so
    the loops cross chip boundaries."""
    graph = adaptive_control_graph(n_channels, n_neurons, n_ticks=n_ticks,
                                   seed=seed, device=device, **graph_kw)
    if board is not None:
        from repro_torch.board import compile_board
        prog = compile_board(graph, board, refine=refine)
    else:
        prog = compile_graph(graph)
    sim = ChipSim(prog, device=device)
    recs = sim.run(n_ticks)
    track = recs["track_err"].cpu().numpy()              # (T, K)
    tab = chip_power_table(sim, recs)
    return {
        "sim": sim, "recs": recs, "table": tab, "program": prog,
        "convergence_tick": convergence_tick(track, err_threshold,
                                             err_window),
        "final_err": float(track[-err_window:].max(axis=1).mean()),
        "initial_err": float(track[:err_window].max(axis=1).mean()),
        "e_learn_j": tab.get("learn", {}).get("energy_j", 0.0),
        "learn_energy_frac": tab.get("learn", {}).get("energy_frac", 0.0),
        "dec_norm": float(recs["dec_norm"][-1]),
    }


# -------------------------------------------------------------------------
# STDP pair: Poisson source -> LIF over a plastic spike projection
# -------------------------------------------------------------------------

@dataclass
class StdpPairSemantics:
    """Pre spikes stream over the mesh (1-tick delay) into a LIF
    population whose fan-in weights the engine's STDP step moves every
    tick.  The forward pass reads the CURRENT weights, so potentiation
    feeds back into excitability."""
    pre_table: np.ndarray                # (T, n_pre) 0/1 spike trains
    n_post: int
    lif: dict                            # ``lif_params_fx`` constants
    gain: float = 0.55
    t_sys_s: float = 1e-3

    def init_state(self, program: ChipProgram, device):
        n_pre = self.pre_table.shape[1]
        return {"buf": torch.zeros(n_pre, dtype=torch.float32,
                                   device=device),
                "v": torch.zeros(self.n_post, dtype=torch.int32,
                                 device=device),
                "ref": torch.zeros(self.n_post, dtype=torch.int32,
                                   device=device),
                "learn": init_learn_state(program, device)}

    def make_tick(self, program: ChipProgram, *, dvfs, em, seed, noise,
                  device):
        table = torch.as_tensor(np.asarray(self.pre_table, np.float32),
                                device=device)
        T, n_pre = table.shape
        n_post = self.n_post
        P = program.n_pes
        pre_mask = torch.zeros(P, dtype=torch.float32, device=device)
        post_mask = torch.zeros_like(pre_mask)
        pre_mask[program.pe_slices["pre"].start] = 1.0
        post_mask[program.pe_slices["post"].start] = 1.0
        n_neur = (post_mask * n_post).to(torch.int32)
        pl3 = torch.full((P,), 2, dtype=torch.int32, device=device)
        w_scale = mean_scale(n_pre * n_post)
        gain = self.gain

        def tick(state, t: int):
            pre_spk = table[t % T]                       # emitted now
            arr = state["buf"]                           # arrived (1-tick)
            lstate = state["learn"]
            w = lstate["pre->post"]["w"]                 # (n_pre, n_post)
            keys = [lstate.signal_key(("pre->post",), sig)
                    for sig in ("pre", "post")]
            w_f = w.to(torch.float32) / FX_ONE
            # arr @ w_f is exact in float32 (0/1 times multiples of 2^-15
            # below 2^24 ulps): the integer sum of the arrived rows, in
            # float32, divided by FX_ONE, is the same float, and no
            # product runs on TF32
            rows = (w * arr.to(torch.int32)[:, None]).sum(0,
                                                          dtype=torch.int64)
            x = rows.to(torch.float32) / FX_ONE
            i_syn = torch.round(x * gain * FX_ONE).to(torch.int32)
            v, ref, post_spk = lif_step(state["v"], state["ref"], i_syn,
                                        **self.lif)

            n_arr = arr.sum()
            fifo = post_mask * n_arr
            pl = dvfs.select_pl(fifo.to(torch.int32))
            syn_ev = post_mask * n_arr * n_post
            e_dvfs = em.tick_energy(pl, n_neur, syn_ev, dvfs=True)
            e_pl3 = em.tick_energy(pl3, n_neur, syn_ev, dvfs=False)
            rec = {
                "packets": pre_mask * pre_spk.sum(),
                "pl": pl,
                "n_fifo": fifo,
                "syn_events": syn_ev,
                keys[0]: arr[None],
                keys[1]: post_spk.to(torch.float32)[None],
                "post_spikes": post_spk.sum(dtype=torch.int32),
                "w_mean": w_f.sum() * w_scale,
                "e_dvfs_baseline": e_dvfs["baseline"],
                "e_dvfs_neuron": e_dvfs["neuron"],
                "e_dvfs_synapse": e_dvfs["synapse"],
                "e_pl3_baseline": e_pl3["baseline"],
                "e_pl3_neuron": e_pl3["neuron"],
                "e_pl3_synapse": e_pl3["synapse"],
            }
            new_state = {"buf": pre_spk, "v": v, "ref": ref,
                         "learn": state["learn"]}
            return new_state, rec

        return tick


def stdp_pair_graph(n_pre: int = 24, n_post: int = 8, n_ticks: int = 512,
                    rate: float = 0.08, seed: int = 0,
                    rule: STDP | None = None, device=None) -> NetGraph:
    """Poisson source -> LIF pair with a plastic STDP projection; the LIF
    constants come from the exp kernel on ``device``.  Pre rates ramp
    across the population (0.5x .. 1.5x ``rate``)."""
    rng = np.random.default_rng(seed)
    rates = rate * np.linspace(0.5, 1.5, n_pre)
    table = (rng.random((n_ticks, n_pre)) < rates[None, :]).astype(
        np.float32)
    rule = rule or STDP()
    pops = [Population(name="pre", n=n_pre, sram_bytes=n_pre * 8),
            Population(name="post", n=n_post,
                       sram_bytes=n_pre * n_post * 4 + n_post * 8)]
    projs = [Projection(src="pre", dst="post", delay_ticks=1,
                        plasticity=rule)]
    lif = lif_params_fx(tau_ms=10.0, v_th=1.0, v_reset=0.0, ref_ticks=2,
                        device=resolve_device(device))
    sem = StdpPairSemantics(pre_table=table, n_post=n_post, lif=lif)
    return NetGraph(populations=pops, projections=projs, semantics=sem,
                    name="stdp_pair")


def stdp_pair_workload(n_pre: int = 24, n_post: int = 8,
                       n_ticks: int = 512, seed: int = 0,
                       rule: STDP | None = None, device=None) -> dict:
    """Compile and run the STDP pair on ``device`` and report weight
    motion and bounds."""
    graph = stdp_pair_graph(n_pre, n_post, n_ticks=n_ticks, seed=seed,
                            rule=rule, device=device)
    prog = compile_graph(graph)
    sim = ChipSim(prog, device=device)
    recs = sim.run(n_ticks)
    w_mean = recs["w_mean"].cpu().numpy()
    tab = chip_power_table(sim, recs)
    return {
        "sim": sim, "recs": recs, "table": tab, "program": prog,
        "w_mean_first": float(w_mean[0]),
        "w_mean_last": float(w_mean[-1]),
        "post_spikes": float(recs["post_spikes"].sum()),
        "e_learn_j": tab.get("learn", {}).get("energy_j", 0.0),
        "learn_energy_frac": tab.get("learn", {}).get("energy_frac", 0.0),
    }
