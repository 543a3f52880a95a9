"""Chip-scale workloads as graph-building functions on the chip API.

The paper's three workload families, each a ``NetGraph`` (populations +
typed projections + tick semantics) compiled with ``compile`` and run
tick by tick by the workload-agnostic ``ChipSim``:

* ``synfire_graph`` — the Sec. VI-B benchmark: ring of per-PE neuron
  populations, binary spike projections; its semantics is the synfire
  tick (``core.snn.make_synfire_tick``, dense or event) over all PEs.
* ``dnn_graph``     — feedforward conv layers split into 128 kB-SRAM tile
  populations (Sec. VI-D), graded activation-burst projections; frames
  stream through the pipeline tick by tick.
* ``hybrid_graph``  — the Sec. II hybrid: a NEF ensemble (SNN path) on
  one QPE spiking into an event-triggered MAC MLP (DNN path) on another,
  the per-tick spike vector crossing the mesh as a graded payload
  packet; ``hybrid_farm_graph`` runs many such channels at board scale.

The ``*_board_graph`` builders size the same workloads to a multi-chip
board (``repro_torch.board``), and ``board_workload`` compiles and runs
one across it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.chip.chip import ChipSim, chip_power_table
from repro_torch.chip.compile import ChipProgram, compile as compile_graph
from repro_torch.chip.graph import (GRADED, NetGraph, Population, Projection,
                                    busy_window_energy, mac_dynamic_energy_j)
from repro_torch.chip.mapping import synfire_sram_bytes
from repro_torch.chip.mesh_noc import MeshSpec
from repro_torch.configs import paper
from repro_torch.core.dvfs import DVFSController
from repro_torch.core.hybrid import event_mac_energy_j, event_mac_tick
from repro_torch.core.nef import (Ensemble, build_ensemble, encode_drive,
                                  synop_metrics)
from repro_torch.core.pe import PESpec, partition_layer_to_sram
from repro_torch.core.quant import quantize_params_linear
from repro_torch.core.snn import (build_synfire, make_synfire_tick,
                                  synfire_init_state)
from repro_torch.kernels.lif.ops import lif_step


@dataclass
class SynfireSemantics:
    """Per-tick step of the synfire ring: the single-chip tick function,
    run on the sim's device."""
    net: object                        # core.snn.SynfireNet

    def init_state(self, program: ChipProgram, device):
        return synfire_init_state(self.net, device)

    def make_tick(self, program: ChipProgram, *, dvfs, em, seed, noise,
                  device):
        return make_synfire_tick(self.net.to(device), dvfs=dvfs, em=em,
                                 seed=seed, noise=noise)

    def make_event_tick(self, program: ChipProgram, *, dvfs, em, seed,
                        noise, device):
        """The activity-compressed synfire tick (``ChipSim`` event mode):
        the same records as ``make_tick``, bit for bit."""
        return make_synfire_tick(self.net.to(device), dvfs=dvfs, em=em,
                                 seed=seed, noise=noise, event=True)

    def dvfs_controller(self):
        """The net's own FIFO thresholds (Table II l_th1/l_th2)."""
        sp = self.net.params
        return DVFSController(sp.l_th1, sp.l_th2)


def synfire_graph(n_pes: int = 8, seed: int = 0,
                  sp: paper.SynfireParams = paper.SYNFIRE, device=None,
                  **build_kw) -> NetGraph:
    """Synfire ring of any length as a graph, its net built on ``device``
    (the CUDA device by default): one population per PE, spike
    projections around the ring."""
    net = build_synfire(seed, n_pes=n_pes, sp=sp, device=device, **build_kw)
    sram = synfire_sram_bytes(net.params)
    pops = [Population(name=f"pe{i}", n=net.params.neurons_per_core,
                       sram_bytes=sram) for i in range(n_pes)]
    projs = [Projection(src=f"pe{i}", dst=f"pe{(i + 1) % n_pes}",
                        delay_ticks=int(net.params.delay_exc_ms))
             for i in range(n_pes)]
    return NetGraph(populations=pops, projections=projs,
                    semantics=SynfireSemantics(net), name=f"synfire{n_pes}")


def synfire_workload(n_pes: int = 8, mesh: MeshSpec | None = None,
                     n_ticks: int = 1200, seed: int = 0,
                     device=None) -> dict:
    """Build, compile, run and account a synfire ring on the mesh."""
    graph = synfire_graph(n_pes, seed=seed, device=device)
    sim = ChipSim(compile_graph(graph, mesh), device=device)
    recs = sim.run(n_ticks)
    return {"sim": sim, "recs": recs, "table": chip_power_table(sim, recs)}


# -------------------------------------------------------------------------
# Tiled DNN (feedforward pipeline)
# -------------------------------------------------------------------------

# A small VGG-ish feedforward stack (the paper's Sec. VI-D keyword-spotting
# class of networks): enough layers to spread over tens of PEs.
DEFAULT_DNN = [
    dict(name="conv1", h=32, w=32, cin=3, cout=32, kh=3, kw=3),
    dict(name="conv2", h=32, w=32, cin=32, cout=32, kh=3, kw=3),
    dict(name="conv3", h=16, w=16, cin=32, cout=64, kh=3, kw=3),
    dict(name="conv4", h=16, w=16, cin=64, cout=64, kh=3, kw=3),
]


def dnn_graph(layers=None, pe: PESpec = PESpec(),
              bytes_per: int = 1) -> NetGraph:
    """Feedforward conv stack as a graph: one population per layer, tiled
    to the 128 kB SRAM; graded projections carry each tile's activation
    burst (its share of the layer's output) to every next-layer tile."""
    layers = layers or DEFAULT_DNN
    pops, projs = [], []
    for li, ly in enumerate(layers):
        rows, cout_t, n_tiles = partition_layer_to_sram(
            pe, ly["h"], ly["w"], ly["cin"], ly["cout"], ly["kh"], ly["kw"],
            bytes_per=bytes_per)
        in_b = (rows + ly["kh"] - 1) * ly["w"] * ly["cin"] * bytes_per
        w_b = ly["kh"] * ly["kw"] * ly["cin"] * cout_t * bytes_per
        out_b = rows * ly["w"] * cout_t * 4
        name = ly.get("name", f"layer{li}")
        out_bytes = ly["h"] * ly["w"] * ly["cout"] * bytes_per
        macs = ly["h"] * ly["w"] * ly["cout"] * ly["cin"] * ly["kh"] * ly["kw"]
        pops.append(Population(
            name=name, n=out_bytes, sram_bytes=in_b + w_b + out_b,
            n_tiles=n_tiles,
            meta=dict(
                ly, rows_per_tile=rows, cout_per_tile=cout_t,
                cycles_per_tile=pe.mac_conv_cycles(
                    min(rows, ly["h"]), ly["w"], ly["cin"], cout_t,
                    ly["kh"], ly["kw"]),
                macs_per_tile=macs / n_tiles,
                in_events=(ly["h"] * ly["w"] * ly["cin"] if li == 0
                           else pops[-1].n),
                out_bytes=out_bytes)))
        if li:
            prev = pops[-2]
            projs.append(Projection(
                src=prev.name, dst=name, payload=GRADED,
                bits_per_packet=-(-prev.meta["out_bytes"] * 8
                                  // prev.n_tiles)))
    g = NetGraph(populations=pops, projections=projs, name="tiled_dnn")
    g.semantics = DnnPipelineSemantics(graph=g)
    return g


@dataclass
class DnnPipelineSemantics:
    """Tick-by-tick streaming inference over the tiled layer pipeline.

    Frames are injected into the first layer every ``frame_interval``
    ticks.  A tile queues arriving frames in its FIFO (occupancy drives
    DVFS, as spike counts do for the SNN), processes one frame for
    ``stage_ticks`` ticks at PL3, and on completion the layer multicasts
    one graded activation burst per tile to every next-layer tile (1-tick
    NoC transport delay).  Energy: Eq. (1) baseline from the busy window
    plus MAC-array dynamic energy per dispatched op.
    """
    graph: NetGraph
    n_frames: int = 4
    frame_interval: int = 0            # 0 -> auto: slowest stage
    t_sys_s: float = 1e-3
    _tables: dict = field(default_factory=dict, init=False, repr=False)

    def static_tables(self, program: ChipProgram) -> dict:
        """Placement-derived per-PE numpy tables (stage latencies, layer
        membership, event counts), memoized per program."""
        key = id(program)
        if key not in self._tables:
            self._tables[key] = self._build_tables(program)
        return self._tables[key]

    def _build_tables(self, program: ChipProgram):
        pops = self.graph.populations
        P = program.n_pes
        n_layers = len(pops)
        pl3_cycles = paper.PERF_LEVELS[2].freq_hz * self.t_sys_s
        stage_ticks = np.array(
            [max(1, int(np.ceil(p.meta["cycles_per_tile"] / pl3_cycles)))
             for p in pops], np.int32)
        member = np.zeros((n_layers, P), np.float32)
        stage_pe = np.zeros(P, np.int32)
        macs_tick = np.zeros(P, np.float32)
        cycles_tick = np.zeros(P, np.float32)
        in_events = np.zeros(P, np.int32)
        for li, p in enumerate(pops):
            sl = program.pe_slices[p.name]
            member[li, sl] = 1.0
            stage_pe[sl] = stage_ticks[li]
            macs_tick[sl] = p.meta["macs_per_tile"] / stage_ticks[li]
            cycles_tick[sl] = p.meta["cycles_per_tile"] / stage_ticks[li]
            in_events[sl] = p.meta["in_events"]
        tiles_per_layer = member.sum(axis=1)
        # emission: layer l done -> 1 frame arrives at every tile of l+1
        nxt = np.zeros((n_layers, P), np.float32)
        for li in range(n_layers - 1):
            nxt[li, program.pe_slices[pops[li + 1].name]] = 1.0
        emit_mask = (member[:-1].sum(axis=0) > 0).astype(np.float32) \
            if n_layers > 1 else np.zeros(P, np.float32)
        first_mask = member[0]
        interval = self.frame_interval or int(stage_ticks.max() + 1)
        return dict(member=member, tiles=tiles_per_layer, nxt=nxt,
                    stage_pe=stage_pe, macs_tick=macs_tick,
                    cycles_tick=cycles_tick, in_events=in_events,
                    emit_mask=emit_mask, first_mask=first_mask,
                    interval=interval, stage_ticks=stage_ticks)

    def init_state(self, program: ChipProgram, device):
        P = program.n_pes
        return {"fifo": torch.zeros(P, dtype=torch.int32, device=device),
                "remaining": torch.zeros(P, dtype=torch.int32,
                                         device=device),
                "buf": torch.zeros(P, dtype=torch.float32, device=device)}

    def make_tick(self, program: ChipProgram, *, dvfs, em, seed, noise,
                  device):
        st = self.static_tables(program)
        tab = {k: torch.as_tensor(st[k], device=device) for k in (
            "member", "tiles", "nxt", "stage_pe", "macs_tick", "cycles_tick",
            "in_events", "emit_mask", "first_mask")}
        interval, n_frames = st["interval"], self.n_frames
        tops_pl3 = paper.MAC_TOPS_PER_W[(paper.HIGH_VDD, paper.HIGH_FREQ)]

        def tick(state, t: int):
            inject = t % interval == 0 and t < n_frames * interval
            arr = state["buf"] + float(inject) * tab["first_mask"]
            arr_i = arr.to(torch.int32)
            fifo = state["fifo"] + arr_i
            n_fifo = arr_i * tab["in_events"]          # events entering FIFO
            pl_arr = dvfs.select_pl(n_fifo)

            start = (state["remaining"] == 0) & (fifo > 0)
            fifo = fifo - start.to(torch.int32)
            remaining = state["remaining"] + start * tab["stage_pe"]
            busy = remaining > 0
            pl = torch.maximum(pl_arr, busy.to(torch.int32) * 2)
            remaining = remaining - busy.to(torch.int32)
            done = busy & (remaining == 0)

            done_f = done.to(torch.float32)
            layer_done = (tab["member"] @ done_f >= tab["tiles"]).to(
                torch.float32)
            packets = done_f * tab["emit_mask"]        # activation bursts
            buf = layer_done @ tab["nxt"]              # arrives next tick

            busy_f = busy.to(torch.float32)
            macs = busy_f * tab["macs_tick"]
            cycles = busy_f * tab["cycles_tick"]
            e_mac = mac_dynamic_energy_j(macs)
            e_mac_pl3 = mac_dynamic_energy_j(macs, tops_per_w=tops_pl3)
            zeros = torch.zeros_like(e_mac)
            rec = {
                "packets": packets,
                "pl": pl,
                "n_fifo": n_fifo,
                "syn_events": macs,
                "busy": busy,
                "layer_done": layer_done,
                "frame_out": layer_done[-1],
                "e_dvfs_baseline": busy_window_energy(
                    pl, cycles, t_sys_s=self.t_sys_s, dvfs=True),
                "e_dvfs_neuron": zeros,
                "e_dvfs_synapse": e_mac,
                "e_pl3_baseline": busy_window_energy(
                    torch.full_like(pl, 2), cycles, t_sys_s=self.t_sys_s,
                    dvfs=False),
                "e_pl3_neuron": zeros,
                "e_pl3_synapse": e_mac_pl3,
            }
            return {"fifo": fifo, "remaining": remaining, "buf": buf}, rec

        return tick


def tiled_dnn_workload(layers=None, mesh: MeshSpec | None = None,
                       pe: PESpec = PESpec(), n_frames: int = 4,
                       n_ticks: int | None = None, device=None) -> dict:
    """Map a feedforward stack over the mesh and stream frames through it
    on ``device``: tiles process when their FIFO holds a frame,
    completions multicast graded activation bursts over real mesh links,
    and the DVFS/NoC accounting falls out of the per-tick records."""
    layers = layers or DEFAULT_DNN
    graph = dnn_graph(layers, pe=pe)
    graph.semantics.n_frames = n_frames
    prog = compile_graph(graph, mesh, pe=pe)
    sim = ChipSim(prog, device=device)

    st = graph.semantics.static_tables(prog)
    pipeline_ticks = int(st["stage_ticks"].sum() + len(layers))
    if n_ticks is None:
        n_ticks = st["interval"] * n_frames + pipeline_ticks + 4
    recs = sim.run(n_ticks)

    frame_out = recs["frame_out"].cpu().numpy()
    out_ticks = np.flatnonzero(frame_out > 0)
    latency_s = (float(out_ticks[0] + 1) * graph.semantics.t_sys_s
                 if out_ticks.size else float("nan"))
    loads = recs["link_load"].cpu().numpy()              # (T, L)
    flits = recs["link_flits"].cpu().numpy()
    per_layer = []
    for pop, ticks in zip(graph.populations, st["stage_ticks"]):
        per_layer.append({
            "name": pop.name, "n_tiles": pop.n_tiles,
            "rows_per_tile": pop.meta["rows_per_tile"],
            "cout_per_tile": pop.meta["cout_per_tile"],
            "cycles_per_tile": pop.meta["cycles_per_tile"],
            "stage_ticks": int(ticks),
            "layer_latency_s": float(ticks) * graph.semantics.t_sys_s,
        })
    compute_s = sum(ly["layer_latency_s"] for ly in per_layer)
    return {
        "sim": sim, "recs": recs, "table": chip_power_table(sim, recs),
        "layers": per_layer,
        "n_pes_used": prog.n_pes,
        "mesh": (prog.mesh.width, prog.mesh.height),
        "n_frames_out": int(frame_out.sum()),
        "latency_s": latency_s,
        "compute_s": compute_s,
        "noc_s": prog.worst_tree_hops * prog.noc.spec.hop_cycles
                 / prog.noc.spec.freq_hz,
        "energy_mac_j": float(recs["e_dvfs_synapse"].double().sum()),
        "energy_noc_j": float(recs["e_noc"].double().sum()),
        "link_loads": loads,
        "peak_link_load": float(loads.max()) if loads.size else 0.0,
        "peak_link_flits": float(flits.max()) if flits.size else 0.0,
    }


# -------------------------------------------------------------------------
# Hybrid NEF + event-MAC MLP
# -------------------------------------------------------------------------

def _channel_operands(n_neurons, hidden, n_ticks, period, seed, ens, wq,
                      w_scale, device):
    """The ensemble, input x (T, 1), MAC-encoded drive (T, N) and int8
    MLP weights of one NEF -> MLP channel; a carried ensemble or weights
    replace the ones built from ``seed``."""
    device = resolve_device(device)
    ens = ens if ens is not None else build_ensemble(n_neurons, 1, seed=seed,
                                                     device=device)
    # a slow sine (Fig. 20's stimulus class), MAC-encoded by the same
    # helper ``core.nef.run_channel`` uses
    x = 0.8 * np.sin(2 * np.pi * np.arange(n_ticks) / period)[:, None]
    drive_fx = encode_drive(ens, x, use_mac=True)
    if wq is None:
        rng = np.random.default_rng(seed)
        w = (rng.standard_normal((n_neurons, hidden)) * 0.1).astype(
            np.float32)
        wq, w_scale = quantize_params_linear(torch.as_tensor(w,
                                                             device=device))
    return ens, x, drive_fx, wq.to(device), w_scale.to(device)


@dataclass
class HybridSemantics:
    """NEF ensemble (SNN path) on one QPE, event-triggered MAC MLP (DNN
    path) on another, executing tick by tick on the mesh (Sec. II).

    Per tick: the ensemble's LIF neurons integrate the (MAC-encoded)
    drive; spiking neurons are decoded event-based into ``xhat``; the
    spike vector crosses the mesh as one graded-payload packet (16 b per
    spike) and is consumed by the MLP PE on the next tick, where only
    arrived events dispatch weight rows.  Ticks with no spikes send
    nothing and multiply nothing.
    """
    ens: Ensemble
    wq: torch.Tensor                    # (N, hidden) int8
    w_scale: torch.Tensor               # (hidden,) float32
    drive_fx: torch.Tensor              # (T, N) int32 s16.15 encode drive
    bits_per_spike: int = 16
    t_sys_s: float = 1e-3

    def init_state(self, program: ChipProgram, device):
        N = self.ens.n_neurons
        return {"v": torch.zeros(N, dtype=torch.int32, device=device),
                "ref": torch.zeros(N, dtype=torch.int32, device=device),
                "xhat": torch.zeros(self.ens.dims, dtype=torch.float32,
                                    device=device),
                "spike_buf": torch.zeros(N, dtype=torch.float32,
                                         device=device)}

    def make_tick(self, program: ChipProgram, *, dvfs, em, seed, noise,
                  device):
        ens = self.ens
        N, D = ens.n_neurons, ens.dims
        hidden = self.wq.shape[1]
        dec = torch.as_tensor(ens.decoders, dtype=torch.float32,
                              device=device)
        w_eff = (self.wq.to(device).to(torch.float32)
                 * self.w_scale.to(device)[None, :])
        alpha_syn = float(np.exp(-1.0 / ens.tau_syn_ticks))
        drive = self.drive_fx.to(device)
        T = drive.shape[0]
        P = program.n_pes
        nef_mask = torch.zeros(P, device=device)
        nef_mask[program.pe_slices["nef"].start] = 1.0
        mlp_mask = torch.zeros(P, device=device)
        mlp_mask[program.pe_slices["mlp"].start] = 1.0
        n_neur = (nef_mask * N).to(torch.int32)
        pl3 = torch.full((P,), 2, dtype=torch.int32, device=device)

        def tick(state, t: int):
            v, ref, spk = lif_step(state["v"], state["ref"], drive[t % T],
                                   **ens.lif)
            spk_f = spk.to(torch.float32)
            n_spk = spk_f.sum().to(torch.int32)
            # event-based decode on the Arm core (only spikers contribute)
            contrib = spk_f @ dec
            # spikes/tick -> rate in Hz (decoders were solved against Hz
            # rates), as in core.nef.run_channel
            xhat = (alpha_syn * state["xhat"]
                    + (1 - alpha_syn) * contrib * 1000.0)

            # NoC: one graded packet iff the tick had spikes
            packets = nef_mask * (n_spk > 0).to(torch.float32)
            bits_out = (self.bits_per_spike * n_spk).to(torch.float32)

            # MLP PE consumes last tick's spike vector (1-tick transport)
            h, n_arr = event_mac_tick(state["spike_buf"], w_eff)
            mac_events = n_arr * hidden
            bits_in = self.bits_per_spike * n_arr

            # DVFS: inbound event counts pick the PL on both PEs
            fifo = nef_mask * N + mlp_mask * n_arr.to(torch.float32)
            pl = dvfs.select_pl(fifo.to(torch.int32))
            # Arm-core synaptic events (decode adds) price via Eq. (1);
            # the MLP's MAC-array ops via TOPS/W only
            snn_ev = nef_mask * n_spk.to(torch.float32) * D
            syn_ev = snn_ev + mlp_mask * mac_events.to(torch.float32)
            e_dvfs = em.tick_energy(pl, n_neur, snn_ev, dvfs=True)
            e_pl3 = em.tick_energy(pl3, n_neur, snn_ev, dvfs=False)
            e_mac = mlp_mask * mac_dynamic_energy_j(
                mac_events.to(torch.float32))

            rec = {
                "packets": packets,
                "payload_bits": nef_mask * bits_out,
                "graded_bits_out": nef_mask * bits_out,
                "graded_bits_in": mlp_mask * bits_in.to(torch.float32),
                "pl": pl,
                "n_fifo": fifo,
                "syn_events": syn_ev,
                "spikes": spk.to(torch.int8),
                "n_spk": n_spk,
                "n_dispatched": (n_arr > 0).to(torch.int32),
                "mac_events": mac_events,
                "xhat": xhat,
                "hidden_out": h,
                "e_dvfs_baseline": e_dvfs["baseline"],
                "e_dvfs_neuron": e_dvfs["neuron"],
                "e_dvfs_synapse": e_dvfs["synapse"] + e_mac,
                "e_pl3_baseline": e_pl3["baseline"],
                "e_pl3_neuron": e_pl3["neuron"],
                "e_pl3_synapse": e_pl3["synapse"] + e_mac,
            }
            return {"v": v, "ref": ref, "xhat": xhat,
                    "spike_buf": spk_f}, rec

        return tick


def hybrid_graph(n_neurons: int = 256, hidden: int = 64,
                 n_ticks: int = 600, seed: int = 0, *,
                 ens: Ensemble | None = None, wq=None, w_scale=None,
                 device=None) -> NetGraph:
    """NEF ensemble + event-MAC MLP as a two-population graph with a
    graded projection (16 b per spike event) between separate QPEs, its
    operands on ``device`` (the CUDA device by default).  ``ens``, ``wq``
    and ``w_scale`` carry parameters in (e.g. the reference's)."""
    ens, x, drive_fx, wq, ws = _channel_operands(
        n_neurons, hidden, n_ticks, 400, seed, ens, wq, w_scale, device)
    nef_sram = n_neurons * (3 * 4 + 2 * 4) + n_neurons * 1 * 4 * 2
    mlp_sram = n_neurons * hidden + hidden * 4 + n_neurons // 8
    pops = [
        Population(name="nef", n=n_neurons, sram_bytes=nef_sram,
                   align_qpe=True, meta={"x": x}),
        Population(name="mlp", n=hidden, sram_bytes=mlp_sram,
                   align_qpe=True),
    ]
    projs = [Projection(src="nef", dst="mlp", payload=GRADED,
                        bits_per_packet=16 * n_neurons, delay_ticks=1)]
    sem = HybridSemantics(ens=ens, wq=wq, w_scale=ws, drive_fx=drive_fx)
    return NetGraph(populations=pops, projections=projs, semantics=sem,
                    name="hybrid_nef_mlp")


@dataclass
class HybridFarmSemantics:
    """K independent NEF -> event-MAC channels ticking in lockstep: the
    Sec. II hybrid at board scale (one channel = ``HybridSemantics``).

    All channels share one ensemble build but integrate phase-shifted
    copies of the drive, so spike times, and the NoC traffic, decorrelate
    across the mesh.  States batch the channel axis: (K, N) tensors, one
    ``lif_step`` launch for the whole farm.  Each NEF PE emits at most one
    graded spike-vector packet per tick (16 b per spike), consumed by its
    paired MLP PE on the next tick.
    """
    ens: Ensemble
    w_eff: torch.Tensor                 # (N, hidden) float32 dequantized
    drive_fx: torch.Tensor              # (T, N) int32 s16.15 encode drive
    n_pairs: int
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
                                         device=device)}

    def make_tick(self, program: ChipProgram, *, dvfs, em, seed, noise,
                  device):
        ens = self.ens
        K, N, D = self.n_pairs, ens.n_neurons, ens.dims
        hidden = self.w_eff.shape[1]
        P = program.n_pes
        drive = self.drive_fx.to(device)
        T = drive.shape[0]
        w_eff = self.w_eff.to(device)
        # co-prime phase offsets decorrelate the channels' spike times
        offsets = torch.as_tensor((np.arange(K) * 17) % T, device=device)
        nef_np, mlp_np = self._pe_ids(program)
        n_neur_np = np.zeros(P, np.int32)
        n_neur_np[nef_np] = N
        n_neur = torch.as_tensor(n_neur_np, device=device)
        pl3 = torch.full((P,), 2, dtype=torch.int32, device=device)
        # static placement permutation: every per-PE record row is (nef
        # values | mlp values | 0 elsewhere), so one gather through this
        # (P,) index table places each record with no scatter
        perm_np = np.full(P, 2 * K, np.int64)
        perm_np[nef_np] = np.arange(K)
        perm_np[mlp_np] = K + np.arange(K)
        perm = torch.as_tensor(perm_np, device=device)
        zk = torch.zeros(K, dtype=torch.float32, device=device)
        z1 = torch.zeros(1, dtype=torch.float32, device=device)
        n_k = torch.full((K,), float(N), device=device)

        def place2(nef_vals, mlp_vals):
            """(K,) nef values + (K,) mlp values -> (P,) per-PE row."""
            return torch.cat([nef_vals, mlp_vals, z1])[perm]

        def tick(state, t: int):
            dfx = drive[(t + offsets) % T]                    # (K, N)
            v, ref, spk = lif_step(state["v"], state["ref"], dfx, **ens.lif)
            spk_f = spk.to(torch.float32)                     # (K, N)
            n_spk = spk_f.sum(1)                              # (K,)
            active = (n_spk > 0).to(torch.float32)
            bits_out = self.bits_per_spike * n_spk

            # MLP PEs consume last tick's spike vectors (1-tick transport)
            arr = state["spike_buf"]                          # (K, N)
            h = arr @ w_eff                                   # (K, hidden)
            n_arr = arr.sum(1)                                # (K,)
            mac_events = n_arr * hidden
            bits_in = self.bits_per_spike * n_arr

            fifo = place2(n_k, n_arr)
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
                "n_spk": n_spk.sum(),
                "hidden_out": h,
                "e_dvfs_baseline": e_dvfs["baseline"],
                "e_dvfs_neuron": e_dvfs["neuron"],
                "e_dvfs_synapse": e_dvfs["synapse"] + e_mac,
                "e_pl3_baseline": e_pl3["baseline"],
                "e_pl3_neuron": e_pl3["neuron"],
                "e_pl3_synapse": e_pl3["synapse"] + e_mac,
            }
            return {"v": v, "ref": ref, "spike_buf": spk_f}, rec

        return tick


def hybrid_farm_graph(n_pairs: int, n_neurons: int = 32, hidden: int = 16,
                      n_ticks: int = 256, seed: int = 0, *,
                      ens: Ensemble | None = None, wq=None, w_scale=None,
                      device=None) -> NetGraph:
    """``n_pairs`` independent NEF -> event-MAC channels as one graph
    (2 * n_pairs populations), operands on ``device``.  All NEF
    populations are laid out before all MLP populations, so channel k's
    projection crosses a long stretch of the snake: board-scale multicast
    traffic over real mesh links."""
    ens, _, drive_fx, wq, ws = _channel_operands(
        n_neurons, hidden, n_ticks, 97, seed, ens, wq, w_scale, device)
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
    sem = HybridFarmSemantics(ens=ens, w_eff=w_eff, drive_fx=drive_fx,
                              n_pairs=n_pairs)
    return NetGraph(populations=pops, projections=projs, semantics=sem,
                    name=f"hybrid_farm{n_pairs}")


# -------------------------------------------------------------------------
# Board-scale variants: the same three workload classes sized to fill a
# multi-chip board and compiled across chip boundaries
# -------------------------------------------------------------------------

def synfire_board_graph(board, fill: float = 1.0, seed: int = 0,
                        sp: paper.SynfireParams = paper.SYNFIRE,
                        device=None, **build_kw) -> NetGraph:
    """Synfire ring sized to ``fill`` of a board's PEs — one population
    per PE, so the ring snakes through every chip and the wrap-around
    edge crosses the whole chip grid."""
    return synfire_graph(n_pes=max(2, int(board.n_pes * fill)), seed=seed,
                         sp=sp, device=device, **build_kw)


def dnn_board_graph(board, layer: dict | None = None,
                    pe: PESpec = PESpec(), bytes_per: int = 1) -> NetGraph:
    """Feedforward conv pipeline sized to a board: the template ``layer``
    (default: a 64x64x32->64 conv, ~13 tiles under the 128 kB SRAM)
    repeats until the tiled stack fills the board's PEs, so consecutive
    layers land on neighbouring chips and every inter-layer activation
    burst that crosses a boundary rides a chip-to-chip link."""
    layer = layer or dict(h=64, w=64, cin=32, cout=64, kh=3, kw=3)
    _, _, tiles = partition_layer_to_sram(
        pe, layer["h"], layer["w"], layer["cin"], layer["cout"],
        layer["kh"], layer["kw"], bytes_per=bytes_per)
    # populations are atomic on a chip, so size by whole layers per chip
    n_layers = max(2, (board.chip.n_pes // tiles) * board.n_chips)
    return dnn_graph([dict(layer, name=f"conv{i}") for i in range(n_layers)],
                     pe=pe, bytes_per=bytes_per)


def hybrid_farm_board_graph(board, n_neurons: int = 32, hidden: int = 16,
                            n_ticks: int = 256, seed: int = 0,
                            **kw) -> NetGraph:
    """Hybrid NEF -> event-MAC farm sized to a board: one channel per PE
    pair.  All NEF populations precede all MLP populations, so after
    partitioning most channels span chips — the traffic-heavy layout for
    the chip-to-chip tier.  ``kw`` as ``hybrid_farm_graph``'s."""
    return hybrid_farm_graph(n_pairs=max(1, board.n_pes // 2),
                             n_neurons=n_neurons, hidden=hidden,
                             n_ticks=n_ticks, seed=seed, **kw)


def board_workload(graph: NetGraph, board, n_ticks: int = 64,
                   refine: bool = True, **sim_kw) -> dict:
    """Partition + compile ``graph`` across ``board``, run it on the
    unchanged engine (``sim_kw`` to ``ChipSim``, e.g. ``device``), and
    report the per-tier traffic split."""
    from repro_torch.board import compile_board
    prog = compile_board(graph, board, refine=refine)
    sim = ChipSim(prog, **sim_kw)
    recs = sim.run(n_ticks)
    x_flits = float(recs["flits_xchip"].sum()) if "flits_xchip" in recs \
        else 0.0
    tot = float(recs["link_flits"].sum())
    return {
        "sim": sim, "recs": recs, "table": chip_power_table(sim, recs),
        "program": prog,
        "n_chips_used": int((prog.part.chips_of_graph() > 0).sum()),
        "cut_flits": prog.part.cut_flits,
        "flits_total": tot,
        "flits_xchip": x_flits,
        "xchip_frac": x_flits / tot if tot else 0.0,
        "energy_noc_j": float(recs["e_noc"].sum()),
        "energy_xchip_j": float(recs["e_noc_xchip"].sum())
        if "e_noc_xchip" in recs else 0.0,
        "worst_path_latency_s": prog.worst_path_latency_s,
    }


def adaptive_control_workload(**kw) -> dict:
    """Closed-loop adaptive control with on-mesh PES learning (Yan et
    al., arXiv:2009.08921).  Lives in ``learn.adaptive``; re-exported here
    (lazily: the learn package imports this module's neighbours) so the
    workload catalog has one front door."""
    from repro_torch.learn.adaptive import adaptive_control_workload as f
    return f(**kw)


def stdp_pair_workload(**kw) -> dict:
    """Poisson -> LIF pair with an on-mesh STDP projection (see
    ``learn.adaptive.stdp_pair_workload``)."""
    from repro_torch.learn.adaptive import stdp_pair_workload as f
    return f(**kw)


def hybrid_workload(n_neurons: int = 256, hidden: int = 64,
                    n_ticks: int = 600, mesh: MeshSpec | None = None,
                    seed: int = 0, *, ens: Ensemble | None = None, wq=None,
                    w_scale=None, device=None) -> dict:
    """Compile and run the hybrid NEF -> event-MAC pipeline on the mesh,
    on ``device`` (the CUDA device by default)."""
    graph = hybrid_graph(n_neurons, hidden, n_ticks=n_ticks, seed=seed,
                         ens=ens, wq=wq, w_scale=w_scale, device=device)
    sim = ChipSim(compile_graph(graph, mesh), device=device)
    recs = sim.run(n_ticks)

    x = graph.populations[0].meta["x"]
    xhat = recs["xhat"].cpu().numpy()
    spikes_per_tick = recs["n_spk"].cpu().numpy().astype(np.float64)
    total_spikes = float(spikes_per_tick.sum())
    e_mac = event_mac_energy_j(total_spikes, 1, hidden)
    e_frame = event_mac_energy_j(n_ticks, n_neurons, hidden)
    e_tick = (n_neurons * paper.NEF_E_NEURON_J
              + spikes_per_tick * 1 * 0.2e-9)
    return {
        "sim": sim, "recs": recs, "table": chip_power_table(sim, recs),
        "xhat": xhat,
        "x": x,
        "rmse": float(np.sqrt(np.mean(
            (xhat[n_ticks // 4:, 0] - x[n_ticks // 4:, 0]) ** 2))),
        "n_dispatched": int(recs["n_dispatched"].sum()),
        "total_spikes": total_spikes,
        "duty_cycle": float((spikes_per_tick > 0).mean()),
        "energy_mac_j": e_mac,
        "energy_mac_frame_j": e_frame,
        "event_vs_frame": e_mac / e_frame,
        "energy_noc_j": float(recs["e_noc"].double().sum()),
        "link_loads": recs["link_flits"].cpu().numpy(),
        "graded_bits_out": recs["graded_bits_out"].sum(1).cpu().numpy(),
        "graded_bits_in": recs["graded_bits_in"].sum(1).cpu().numpy(),
        "synops": synop_metrics(graph.semantics.ens, spikes_per_tick,
                                e_tick),
        "hidden_out": recs["hidden_out"].cpu().numpy(),
    }
