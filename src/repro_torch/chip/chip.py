"""``ChipSim`` — the workload-agnostic chip engine, on one CUDA device.

A virtual SpiNNaker2 chip: a W x H QPE mesh of PEs running a compiled
``ChipProgram`` (SNN, DNN or hybrid) tick by tick, or, for a
``board.BoardProgram``, a whole multi-chip board: the engine is the
same, only the incidence and the NoC's pricing differ.  The program's
``TickSemantics`` advances all PEs as batched axes of the same tensors
and reports per-PE activity; the engine adds the NoC: each source's
packet count hits its multicast tree incidence — the dense product over
the (P, n_links) tensor, the segmented sum over each link's sources
(``kernels/link_load``), or in event mode the gather of the active
sources' rows (``kernels/event_gather``) — giving per-link loads in
packets and DNoC flits, plus NoC energy.  ``noc_mode`` and ``exec_mode``
"auto" pick the representation and the execution mode from the
incidence shape as the reference does; every choice gives the same
records bit for bit.

A program with plastic projections (``learn_slots``) also advances its
weights and traces each tick, right after the semantics' tick
(``learn.engine``), and prices the work into a per-PE ``e_learn``
record; a frozen program runs exactly the frozen tick.

``run`` is a Python loop over host integer ticks that writes into
(T, ...) record tensors on the device: no host synchronisation and no
data-dependent branch inside the loop.  ``run(probes=...)`` folds
windowed telemetry (``obs.probes``) over the same records.
``make_batched_stepper`` advances a fleet of independent instances of
one program at once (the serving tier, ``serve.fleet``), each at its own
local tick held in a device tensor; the body after the semantics' tick
is the same code over a leading instance axis.

``chip_power_table`` gives the per-PE Table III split, chip totals, NoC
power and the peak-link-load bottleneck check.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.chip.compile import ChipProgram
from repro_torch.chip.mesh_noc import (DENSE_DENSITY, MAX_SPARSE_COLS,
                                       MIN_SPARSE_LINKS, NocAccounting,
                                       SPIKE_PACKET_BITS)
from repro_torch.core.dvfs import DVFSController
from repro_torch.core.energy import PEEnergyModel
from repro_torch.core.snn import run_ticks, synfire_power_table

EVENT_IMPLS = ("auto", "gather", "pallas")


@dataclass
class ChipSim:
    """A compiled workload program on a full PE mesh, on ``device`` (the
    CUDA device unless the caller asks for the CPU).

    ``noc_mode``: "auto" picks sparse vs dense NoC accounting from the
    incidence (mesh size, density, per-link fan-in); "sparse"/"dense"
    force it.  ``exec_mode``: "dense" runs every PE's work each tick;
    "event" runs the workload's activity-compressed tick (when its
    semantics has one, ``make_event_tick``) and, on a sparse NoC, the
    event-mode accounting over the active sources; "auto" picks event
    exactly when the NoC auto-select goes sparse, as the reference does.
    ``event_impl`` is the reference's event-kernel knob, accepted for its
    values ("auto", "gather", "pallas"): the port has one event-mode
    accounting, the compacted-index gather of ``kernels/event_gather``
    (plain version on the CPU, hand kernel on the card), which is what
    the reference's "gather" and "pallas" compute.
    """
    program: ChipProgram
    dvfs: Optional[DVFSController] = None
    em: PEEnergyModel = field(default_factory=PEEnergyModel)
    noc_mode: str = "auto"
    exec_mode: str = "auto"
    event_impl: Optional[str] = None
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.use_event_mode()                       # validates exec_mode
        if self.event_impl not in (None,) + EVENT_IMPLS:
            raise ValueError(f"unknown event_gather impl "
                             f"{self.event_impl!r}; expected one of "
                             f"{EVENT_IMPLS}")
        # float32 products count packets: keep them exact, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        if self.dvfs is None:
            sem = self.program.graph.semantics
            make = getattr(sem, "dvfs_controller", None)
            self.dvfs = make() if make else DVFSController()

    @property
    def noc(self) -> NocAccounting:
        return self.program.noc

    def use_sparse_noc(self, noc_mode: str | None = None) -> bool:
        """Resolve the accounting representation for this program."""
        mode = noc_mode or self.noc_mode
        if mode not in ("auto", "sparse", "dense"):
            raise ValueError(f"unknown noc_mode {mode!r}")
        if mode == "auto":
            sinc = self.program.sinc
            return (sinc.n_links >= MIN_SPARSE_LINKS
                    and sinc.density <= DENSE_DENSITY
                    and sinc.max_fan_in <= MAX_SPARSE_COLS)
        return mode == "sparse"

    def use_event_mode(self, exec_mode: str | None = None) -> bool:
        """Resolve the execution mode for this program: "auto" picks the
        activity-compressed mode exactly when the NoC auto-select goes
        sparse (the board-scale regime where activity is sparse relative
        to the mesh)."""
        mode = exec_mode or self.exec_mode
        if mode not in ("auto", "event", "dense"):
            raise ValueError(f"unknown exec_mode {mode!r}")
        if mode == "auto":
            return self.use_sparse_noc("auto")
        return mode == "event"

    def make_stepper(self, seed: int = 1, noc_mode: str | None = None,
                     noise=None, exec_mode: str | None = None):
        """``(init_state, step)`` where ``step(state, t) -> (state, rec)``
        is the engine's full per-tick body: the semantics' tick, on-mesh
        learning, then the NoC accounting.  ``noise`` is passed to the
        semantics (see ``core.snn.make_synfire_tick``)."""
        prog = self.program
        event = self.use_event_mode(exec_mode)
        kw = dict(dvfs=self.dvfs, em=self.em, seed=seed, noise=noise,
                  device=self.device)
        # semantics without a compressed tick run their dense tick under
        # event-mode NoC accounting (the same records either way)
        tick = (prog.make_event_tick(**kw) if event else None) \
            or prog.make_tick(**kw)
        return self._engine_step(tick, event, noc_mode)

    def make_batched_stepper(self, seed: int = 1,
                             noc_mode: str | None = None, noise=None,
                             exec_mode: str | None = None):
        """``(init_state, step)`` for a fleet of independent instances of
        this program: ``step(state_b, t_b) -> (state_b, rec_b)`` advances
        w instances at once, ``t_b`` a (w,) int32 tensor of each
        instance's own local tick on the sim's device, every state and
        record tensor with a leading (w,) axis.  ``init_state`` is one
        instance's (the caller broadcasts it).  The per-tick body after
        the semantics' tick, learning and the NoC accounting, is
        ``make_stepper``'s, over the leading axis; the semantics must
        have a batched tick (``make_batched_tick``), which the served
        workloads of ``repro_torch.serve.fleet`` have."""
        sem = self.program.graph.semantics
        make = getattr(sem, "make_batched_tick", None)
        if make is None:
            raise ValueError(
                f"{type(sem).__name__} (graph "
                f"{self.program.graph.name!r}) has no batched tick "
                "(make_batched_tick); the fleet serves the served "
                "semantics of repro_torch.serve.fleet.scenarios")
        tick = make(self.program, dvfs=self.dvfs, em=self.em, seed=seed,
                    noise=noise, device=self.device)
        return self._engine_step(tick, self.use_event_mode(exec_mode),
                                 noc_mode)

    def _engine_step(self, tick, event: bool, noc_mode: str | None):
        """``tick`` (one instance's, or a fleet's) followed by the
        engine's learning and NoC accounting, written once over any
        leading instance axes: (init_state, step)."""
        prog, noc, dev = self.program, self.noc, self.device
        init = prog.init_state(dev)
        # on-mesh learning: a plastic program's state carries per-slot
        # weights and traces, advanced right after the semantics' tick;
        # a frozen program (learn_slots == ()) never reaches the engine
        # (imported here: learn reaches back into chip)
        learn = None
        if prog.learn_slots:
            from repro_torch.learn.engine import make_learn_step
            if not isinstance(init, dict) or "learn" not in init:
                raise ValueError(
                    f"graph {prog.graph.name!r} has plastic projections "
                    "but its semantics' init_state does not carry a "
                    "'learn' subtree; include "
                    "repro_torch.learn.init_learn_state(program, device)")
            learn = make_learn_step(prog, dev)
        sparse = self.use_sparse_noc(noc_mode)
        if sparse and event:
            rows = noc.event_plan(prog.sinc, dev)
        elif sparse:
            plan = noc.device_plan(prog.sinc, dev)
        else:
            inc = torch.as_tensor(prog.inc, device=dev)
        # the reference's jitted ``active / n_src`` is a multiply by the
        # float32 reciprocal (XLA rewrites division by a constant)
        inv_src = torch.tensor(np.float32(1) / np.float32(
            max(prog.sinc.n_sources, 1)), device=dev)
        tier_masks = {tier: torch.as_tensor(m, device=dev)
                      for tier, m in noc.tier_masks().items()
                      if np.asarray(m).any()}
        # (P,) link counts on a chip; on a board (P, 2) [on-chip,
        # chip-to-chip], priced by its tiered traffic_energy_j
        tree_links = torch.as_tensor(prog.energy_tree_links,
                                     dtype=torch.float32, device=dev)
        # a board's chip-to-chip tier: its link mask and each source's
        # chip-to-chip link count.  A 1x1 board has no such tier, and its
        # records stay exactly the single chip's
        tiered = getattr(noc, "n_xchip_links", 0) > 0
        if tiered:
            xmask = torch.as_tensor(noc.xlink_mask, device=dev)
            tree_links_x = torch.as_tensor(prog.tree_links_x,
                                           dtype=torch.float32, device=dev)
        # each source's flits and bits a packet, once per run; graded
        # payloads that vary by tick (the hybrid's spike vector) are priced
        # in the tick instead
        static_costs = noc.packet_costs(torch.as_tensor(prog.payload_bits,
                                                        device=dev))

        def chip_tick(state, t):
            # t: a host int, or a fleet's (w,) tick tensor
            state, rec = tick(state, t)
            if learn is not None:
                lstate, lrec = learn(state["learn"], rec)
                state = {**state, "learn": lstate}
                rec.update(lrec)
            packets = rec["packets"].to(torch.float32)   # (..., P)
            flits, bits = (noc.packet_costs(rec["payload_bits"])
                           if "payload_bits" in rec else static_costs)
            if sparse and event:
                rec["link_load"], rec["link_flits"] = noc.event_noc_loads(
                    packets, rows, flits)
            elif sparse:
                rec["link_load"], rec["link_flits"] = noc.noc_loads(
                    packets, plan, flits)
            else:
                rec["link_load"] = noc.link_loads(packets, inc)
                rec["link_flits"] = noc.flit_loads(packets, inc, flits)
            rec["e_noc"] = noc.traffic_energy_j(packets, tree_links, bits)
            active = (rec["packets"] > 0).sum(-1, dtype=torch.int32)
            rec["active_sources"] = active
            rec["active_frac"] = active.to(torch.float32) * inv_src
            hit = (rec["link_load"] > 0).to(torch.float32)
            rec["touched_links"] = hit.sum(-1)
            for tier, m in tier_masks.items():
                rec[f"touched_links_{tier}"] = hit @ m
            if tiered:
                rec["load_xchip"] = (rec["link_load"] * xmask).sum(-1)
                rec["flits_xchip"] = (rec["link_flits"] * xmask).sum(-1)
                rec["e_noc_xchip"] = noc.xchip_energy_j(packets,
                                                        tree_links_x, bits)
            return state, rec

        return init, chip_tick

    def run(self, n_ticks: int, seed: int = 1, noc_mode: str | None = None,
            noise=None, exec_mode: str | None = None, probes=(),
            keep_records: bool = True, state=None, start: int = 0) -> dict:
        """Per-tick records on the sim's device: everything the program's
        semantics reports (spike rasters, PLs, Eq. (1) energies) plus

        link_load  (T, n_links) — packets per link per tick
        link_flits (T, n_links) — DNoC flits per link per tick
        e_noc      (T,)         — NoC traffic energy per tick [J]
        active_sources, active_frac (T,) — sources emitting >= 1 packet
        touched_links, touched_links_<tier> (T,) — links carrying traffic

        and, when the program has plastic projections, the learning tier:

        e_learn    (T, P)       — per-PE learning energy [J]
        learn/<slot>/dw (T,)    — mean |weight change| of each slot

        and, on a board with chip-to-chip links, the tier's share:

        load_xchip / flits_xchip (T,) — packet / flit traversals of
                                        chip-to-chip links
        e_noc_xchip (T,)        — chip-to-chip share of e_noc [J]

        ``noc_mode`` and ``exec_mode`` override the sim's choices for this
        run; every choice gives bit-identical records.

        ``probes`` (``obs.probes``: ProbeSpec instances or registry names)
        folds windowed telemetry over the records, returned under
        ``recs["probes"]``.  The probes read records, never state, so a
        probed run's records are the bare run's; ``probes=()`` is exactly
        the bare path.  ``keep_records=False`` (probed runs only) keeps no
        (T, ...) records and returns the probe output alone.

        ``state`` (a ``make_stepper`` state on this sim's device, e.g.
        another sim's at tick ``start``) continues a run: ticks ``start``
        .. ``start + n_ticks - 1`` from it, in place of the program's
        initial state at tick 0.
        """
        if not probes and not keep_records:
            raise ValueError("keep_records=False without probes would "
                             "record nothing; pass probes=...")
        init, step = self.make_stepper(seed=seed, noc_mode=noc_mode,
                                       noise=noise, exec_mode=exec_mode)
        if state is not None:
            init = state
        chip_tick = step if not start else (
            lambda s, t: step(s, start + t))
        # a plastic run records each slot group's signals stacked
        # (learn.engine); probes read its per-slot keys as rows of them,
        # and the run hands them out as the reference's per-slot records
        groups, views = (), {}
        if self.program.learn_slots:
            from repro_torch.learn.engine import (expand_learn_records,
                                                  group_slots,
                                                  learn_record_views)
            groups = group_slots(self.program.learn_slots)
            views = learn_record_views(groups)
        if not probes:
            recs = run_ticks(chip_tick, init, n_ticks)
        else:
            # the probes compile against the first tick's records and
            # fold every tick's after it (imported here: obs reaches back
            # into chip)
            from repro_torch.obs.probes import make_probe_step, resolve_probes
            specs = resolve_probes(self.program, probes)
            done = []

            def observe(rec):
                obs, fold, finalize = make_probe_step(specs, rec, n_ticks,
                                                      row_views=views)
                done.append(lambda: finalize(obs))
                return lambda r, t: fold(obs, r, t)

            recs = run_ticks(chip_tick, init, n_ticks, observe=observe,
                             keep_records=keep_records)
        if groups:
            recs = expand_learn_records(recs, groups)
        if probes:
            recs["probes"] = done[0]() if done else {}
        return recs


def chip_power_table(sim: ChipSim, recs: dict,
                     t_sys_s: float = 1e-3) -> dict:
    """Chip-level Table III: ``per_pe`` (averaged over all PEs), ``chip``
    (summed over the mesh) [mW], and ``noc``: average NoC power, peak
    link load in packets and flits per tick, utilization against link
    capacity, worst multicast hop depth; on a board with chip-to-chip
    links also ``noc["xchip"]``, the tier's share, with utilization and
    worst latency taken over both tiers at their own rates; for a plastic
    program ``learn``, the learning energy and its share of the total."""
    per_pe = synfire_power_table(recs, t_sys_s=t_sys_s)
    P = sim.program.n_pes
    chip = {mode: {k: v * P for k, v in per_pe[mode].items()}
            for mode in ("dvfs", "pl3")}

    loads = recs["link_load"].cpu().numpy()                 # (T, L)
    flits = recs["link_flits"].cpu().numpy()
    e_noc = recs["e_noc"].cpu().numpy()
    peak = float(loads.max(axis=-1).max()) if loads.size else 0.0
    peak_flits = float(flits.max(axis=-1).max()) if flits.size else 0.0
    cap = sim.noc.link_capacity_packets(t_sys_s, SPIKE_PACKET_BITS)
    cap_flits = t_sys_s * sim.noc.spec.freq_hz / sim.noc.spec.hop_cycles
    noc = {
        "power_mw": float(e_noc.mean() / t_sys_s * 1e3),
        "peak_link_load": peak,
        "mean_link_load": float(loads.mean()) if loads.size else 0.0,
        "peak_link_flits": peak_flits,
        "link_capacity": cap,                 # spike packets / tick
        "link_capacity_flits": cap_flits,     # basis of peak_utilization
        "peak_utilization": peak_flits / cap_flits,
        "worst_tree_hops": sim.program.worst_tree_hops,
        "worst_hop_latency_s": sim.noc.hop_latency_s(
            sim.program.worst_tree_hops),
        "n_links": sim.noc.n_links,
    }
    if "flits_xchip" in recs:
        xmask = np.asarray(sim.noc.xlink_mask) > 0
        x_flits = float(recs["flits_xchip"].sum())
        tot_flits = float(flits.sum())
        e_xchip = recs["e_noc_xchip"].cpu().numpy()
        e_x, e_tot = float(e_xchip.sum()), float(e_noc.sum())
        peak_x = (float(flits[:, xmask].max())
                  if xmask.any() and flits.size else 0.0)
        # the chip-to-chip tier has its own, slower flit clock
        xspec = sim.noc.xspec
        cap_x = t_sys_s * xspec.freq_hz / xspec.hop_cycles
        noc["xchip"] = {
            "n_links": int(xmask.sum()),
            "flits": x_flits,
            "flits_frac": x_flits / tot_flits if tot_flits else 0.0,
            "energy_frac": e_x / e_tot if e_tot else 0.0,
            "power_mw": float(e_xchip.mean() / t_sys_s * 1e3),
            "peak_xlink_flits": peak_x,
            "link_capacity_flits": cap_x,
            "peak_utilization": peak_x / cap_x,
        }
        # tier-aware roll-ups: the worse tier against its own capacity,
        # and the worst latency with each tier at its own hop cost
        peak_on = (float(flits[:, ~xmask].max())
                   if (~xmask).any() and flits.size else 0.0)
        noc["peak_utilization"] = max(peak_on / cap_flits, peak_x / cap_x)
        noc["worst_hop_latency_s"] = sim.program.worst_path_latency_s
    out = {"per_pe": per_pe, "chip": chip, "noc": noc, "n_pes": P,
           "mesh": (sim.program.mesh.width, sim.program.mesh.height)}
    # on-mesh learning: e_learn's share of the total energy (Eq. (1)
    # terms + NoC traffic + learning)
    if "e_learn" in recs:
        e_l = recs["e_learn"].cpu().numpy()
        e_pe = sum(float(recs[k].cpu().numpy().sum())
                   for k in ("e_dvfs_baseline", "e_dvfs_neuron",
                             "e_dvfs_synapse"))
        tot = e_pe + float(e_noc.sum()) + float(e_l.sum())
        out["learn"] = {
            "power_mw": float(e_l.sum(axis=-1).mean() / t_sys_s * 1e3),
            "energy_j": float(e_l.sum()),
            "energy_frac": float(e_l.sum()) / tot if tot else 0.0,
        }
    board = getattr(sim.program, "board", None)
    if board is not None:
        out["board"] = (board.chips_x, board.chips_y)
    return out
