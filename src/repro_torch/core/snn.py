"""The synfire-chain benchmark (paper Sec. VI-B) on PyTorch.

Each PE simulates its neurons once per 1 ms timer tick; inbound spikes
sit in a FIFO (a bit-packed delay line) until they arrive; the FIFO
occupancy picks the performance level (``core/dvfs.py``) before
processing.  Arithmetic is SpiNNaker-style s16.15 fixed point: the
synaptic accumulation (``kernels/syn_accum``), the LIF update
(``kernels/lif``) and the decay constant (``kernels/explog``) run as
hand-written kernels on a CUDA device and as their plain versions on the
CPU, bit-identical either way.

The synfire chain (Fig. 16, Table II): PEs in a ring; per PE one
excitatory population (200) and one inhibitory population (50); exc of
PE i projects to exc+inh of PE i+1 with 10 ms delay (fan-in 60); inh
projects to exc of the same PE with 8 ms delay (fan-in 25); background
noise current; a stimulus pulse kick-starts PE 0.

``make_synfire_tick(..., event=True)`` builds the activity-compressed
tick of the reference's event execution mode: the tick's input set (PEs
with spike arrivals, noise kicks or stimulus) is compacted into a bounded
index buffer, as by the reference's two-level tag sort (``compact``, one
kernel on the card), and the synaptic accumulation runs on the listed PEs
only.  When the set overflows the buffer the kernel covers every PE
instead, which is the dense result, decided on the device with no host
branch.  Either mode's records are the reference's bit for bit, given the
same background noise (see ``make_synfire_tick``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import paper
from repro_torch.core.dvfs import DVFSController
from repro_torch.core.energy import PEEnergyModel
from repro_torch.core.router import ring_exchange
from repro_torch.kernels.event_gather.ops import compact_lanes
from repro_torch.kernels.event_gather.ref import CHUNK
from repro_torch.kernels.explog.ops import to_fx
from repro_torch.kernels.lif.ops import lif_params_fx, lif_step
from repro_torch.kernels.syn_accum.ops import syn_accum
from repro_torch.kernels.syn_accum.ref import (pack_spikes, popcount_words,
                                               spike_words, unpack_spikes)

FX_ONE = 1 << 15
MASK32 = 0xFFFFFFFF

# Default bound on the event tick's input buffer: PEs with spike arrivals,
# noise kicks or stimulus this tick.  A synfire wave lights O(1) PEs per
# tick and shot noise adds kicks_per_tick more, so 64 covers 4096-PE rings
# with a wide margin; overflow computes every PE (still bitwise).
EVENT_SRC_CAP = 64

# Two-level compaction of the input set: PEs group into chunks of
# EVENT_CHUNK; the set PEs of the first EVENT_MAX_CHUNKS active chunks are
# listed (the reference selects those chunks by a chunk-tag sort before
# its per-PE tag sort runs on their lanes only).
EVENT_CHUNK = CHUNK
EVENT_MAX_CHUNKS = 16


# ------------------------------------------------------------------ shot noise
# Deterministic per-(seed, tick) background kicks: a fixed number of
# subthreshold current kicks lands on hash-picked neurons each tick.  The
# hash is the murmur3 finalizer on uint32 values, computed here in int64
# with the 32-bit wrap made explicit.

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) without int64 overflow:
    c is split into 16-bit halves so no partial product reaches 2**49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def shot_seed32(seed: int) -> int:
    """The reference's ``_shot_seed32(PRNGKey(seed))``.  A threefry key
    made from a seed below 2**32 has the words [0, seed], and
    fmix32(0) = 0, so this is fmix32(seed)."""
    kd = torch.tensor([(seed >> 32) & MASK32, seed & MASK32])
    return int(fmix32(kd[1:] ^ fmix32(kd[:1]))[0])


def shot_noise_lanes(seed32: int, t: int, n_kicks: int, n_lanes: int,
                     device=None) -> torch.Tensor:
    """Flat lane index (< n_lanes) of each of tick t's ``n_kicks`` kicks,
    on ``device`` (the CUDA device unless the caller asks for the CPU)."""
    c = (t * n_kicks + torch.arange(n_kicks, dtype=torch.int64,
                                    device=resolve_device(device))) & MASK32
    return fmix32(c ^ seed32) % n_lanes


def compact(src: torch.Tensor, cap: int):
    """The reference's two-level compaction of the (P,) bool input set.

    Returns ``(idx, fits)``: ``idx`` (cap_eff,) int32 holds up to
    ``cap_eff = min(cap, P, EVENT_MAX_CHUNKS * EVENT_CHUNK)`` set PE ids
    in ascending order, sentinel P after; ``fits`` (0-d bool) says the
    whole set is listed (no more than ``cap_eff`` PEs in no more than
    ``EVENT_MAX_CHUNKS`` chunks).  One kernel launch on a CUDA device
    (``compact_lanes``; the plain version is the reference's two tag
    sorts), no host synchronisation."""
    idx, fits, _ = compact_lanes(src, cap, EVENT_MAX_CHUNKS)
    return idx, fits


def generator_noise(seed: int, shape: tuple, device):
    """Default Gaussian background: ``t -> (P, N)`` float32 standard-normal
    draws from a ``torch.Generator`` seeded with ``seed``, one draw per
    tick in tick order.  Statistically equivalent to the reference's
    ``jax.random.normal(fold_in(key, t))`` draws, not bitwise equal."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def noise(t: int) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=device)
    return noise


@dataclass
class SynfireNet:
    params: paper.SynfireParams
    w_ff: torch.Tensor       # (P, 200, 250) int32 s16.15: prev-exc -> [exc|inh]
    w_inh: torch.Tensor      # (P, 50, 200) int32 s16.15 (negative)
    deg_ff: torch.Tensor     # (P, 200) int32: out-degree of each prev-exc source
    deg_inh: torch.Tensor    # (P, 50) int32
    lif: dict
    noise_sigma_fx: int
    stim_ticks: int
    stim_current_fx: int
    noise_model: str = "gauss"   # "gauss" (dense draws) | "shot" (kicks)
    kicks_per_tick: int = 0
    kick_fx: int = 0

    @property
    def device(self) -> torch.device:
        return self.w_ff.device

    def to(self, device) -> "SynfireNet":
        """This net with its tensors on ``device`` (itself if already
        there)."""
        device = torch.device(device)
        if self.device == device:
            return self
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device)
                     for k in ("w_ff", "w_inh", "deg_ff", "deg_inh")})


def net_from_numpy(arrays: dict, params, lif: dict, *, device=None,
                   **scalars) -> SynfireNet:
    """A ``SynfireNet`` on ``device`` from numpy arrays ``w_ff``,
    ``w_inh``, ``deg_ff``, ``deg_inh`` and the scalar fields (e.g. a
    reference net's, carried across).  ``params`` may be any object with
    the ``SynfireParams`` fields."""
    device = resolve_device(device)
    sp = paper.SynfireParams(**{f.name: getattr(params, f.name)
                                for f in fields(paper.SynfireParams)})
    tensors = {k: torch.as_tensor(np.array(arrays[k], np.int32),
                                  device=device)
               for k in ("w_ff", "w_inh", "deg_ff", "deg_inh")}
    return SynfireNet(params=sp, lif=dict(lif), **tensors, **scalars)


def build_synfire(seed: int = 0, *, w_exc: float = 0.075,
                  w_inh: float = -0.30, noise_sigma: float = 0.30,
                  tau_ms: float = 10.0, v_th: float = 1.0,
                  ref_ticks: int = 2,
                  sp: paper.SynfireParams = paper.SYNFIRE,
                  n_pes: int | None = None,
                  v_min: float | None = -1.0,
                  noise_model: str = "gauss",
                  kicks_per_tick: int = 4,
                  kick: float = 0.5, device=None) -> SynfireNet:
    """Build the synfire ring on ``device`` (the CUDA device by default).

    The connectivity is drawn with numpy's ``default_rng(seed)`` in the
    reference's order, so the weights equal ``repro.core.snn.
    build_synfire``'s exactly.  Every nonzero weight of a matrix has the
    same value, so the s16.15 matrices are written directly as int32.

    ``noise_model="shot"`` replaces the dense Gaussian background current
    with ``kicks_per_tick`` subthreshold kicks (``kick`` in units of v_th)
    on hash-picked neurons.
    """
    if noise_model not in ("gauss", "shot"):
        raise ValueError(f"unknown noise_model {noise_model!r}")
    if sp.neurons_per_core != sp.n_exc + sp.n_inh:
        raise ValueError(
            f"neurons_per_core ({sp.neurons_per_core}) must equal "
            f"n_exc + n_inh ({sp.n_exc} + {sp.n_inh}): the membrane array "
            f"is split [:n_exc]/[n_exc:] per PE")
    device = resolve_device(device)
    if n_pes is not None and n_pes != sp.n_pes:
        sp = dataclasses.replace(sp, n_pes=n_pes)
    rng = np.random.default_rng(seed)
    P_, NE, NI = sp.n_pes, sp.n_exc, sp.n_inh
    N = sp.neurons_per_core
    q_exc, q_inh = to_fx(w_exc), to_fx(w_inh)
    w_ff = np.zeros((P_, NE, N), np.int32)
    w_inh_m = np.zeros((P_, NI, NE), np.int32)
    for p in range(P_):
        # each target neuron draws fan_in_exc sources from prev layer's exc
        for tgt in range(N):
            src = rng.choice(NE, sp.fan_in_exc, replace=False)
            w_ff[p, src, tgt] = q_exc
        for tgt in range(NE):
            src = rng.choice(NI, sp.fan_in_inh, replace=False)
            w_inh_m[p, src, tgt] = q_inh
    lif = lif_params_fx(tau_ms=tau_ms, v_th=v_th, v_reset=0.0,
                        ref_ticks=ref_ticks, v_min=v_min, device=device)
    shot = noise_model == "shot"
    return net_from_numpy(
        {"w_ff": w_ff, "w_inh": w_inh_m,
         "deg_ff": (w_ff != 0).sum(axis=2), "deg_inh": (w_inh_m != 0).sum(
             axis=2)},
        sp, lif, device=device,
        noise_sigma_fx=int(round(noise_sigma * FX_ONE)),
        stim_ticks=2,
        stim_current_fx=int(round(2.0 * FX_ONE)),
        noise_model=noise_model,
        kicks_per_tick=kicks_per_tick if shot else 0,
        kick_fx=int(round(kick * FX_ONE)) if shot else 0)


def synfire_init_state(net: SynfireNet, device=None) -> dict:
    """Zeroed membrane/refractory state and bit-packed delay lines (int32
    words holding the reference's uint32 bit patterns), on ``device``
    (default: the net's)."""
    sp = net.params
    P_, N = sp.n_pes, sp.neurons_per_core
    device = net.device if device is None else device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return {
        "v": zeros(P_, N),
        "ref": zeros(P_, N),
        "exc_buf": zeros(int(sp.delay_exc_ms), P_, spike_words(sp.n_exc)),
        "inh_buf": zeros(int(sp.delay_inh_ms), P_, spike_words(sp.n_inh)),
    }


def make_synfire_tick(net: SynfireNet, *, dvfs: DVFSController,
                      em: PEEnergyModel, seed: int = 1, noise=None,
                      exchange=ring_exchange, event: bool = False,
                      src_cap: int | None = None):
    """Build the per-tick step ``tick(state, t) -> (state, rec)`` for host
    integer ``t``, on the net's device.

    ``event=True`` builds the activity-compressed tick: this tick's input
    set (spike arrivals, shot-noise kicks, the stimulus target) is
    compacted into ``src_cap`` (default ``EVENT_SRC_CAP``) lanes by
    ``compact``, and ``syn_accum`` walks the listed PEs only, or every PE
    when the set overflowed.  The kernel writes each listed PE's row of
    the (P, N) current directly, so the kicks and the stimulus land on the
    same cells through the same formula as in the dense tick; the records
    are the dense tick's bit for bit.

    Unlike the reference's functional tick, the step updates the delay
    lines of ``state`` in place (``exc_buf[t % d] = ...``) after reading
    the slot that arrives this tick, and returns the same dict.  It does
    no host synchronisation and branches only on ``t``.

    Background noise: shot noise is a hash of (seed, t) and equals the
    reference's bit for bit.  Gaussian noise comes from ``noise``, a
    callable ``t -> (P, N)`` float32 of standard-normal draws; None draws
    from a generator seeded with ``seed`` (``generator_noise``).  Passing
    the reference's draws reproduces its records exactly.
    """
    sp = net.params
    P_, NE = sp.n_pes, sp.n_exc
    N = sp.neurons_per_core
    d_exc, d_inh = int(sp.delay_exc_ms), int(sp.delay_inh_ms)
    dev = net.device
    shot = net.noise_model == "shot" and net.kicks_per_tick > 0
    if shot:
        seed32 = shot_seed32(seed)
        kicks = torch.full((net.kicks_per_tick,), net.kick_fx,
                           dtype=torch.int32, device=dev)
    elif noise is None:
        noise = generator_noise(seed, (P_, N), dev)

    cap = EVENT_SRC_CAP if src_cap is None else src_cap

    def tick(state, t: int):
        # 1. drain FIFOs (spikes that arrive this tick)
        we = state["exc_buf"][t % d_exc]               # (P, WE) packed
        wi = state["inh_buf"][t % d_inh]               # (P, WI) packed
        n_fifo = popcount_words(we) + popcount_words(wi)
        arr_exc = unpack_spikes(we, NE)
        arr_inh = unpack_spikes(wi, sp.n_inh)

        # 2. DVFS: FIFO occupancy picks the PL before processing
        pl = dvfs.select_pl(n_fifo)

        # 3. synaptic accumulation (event-driven integer MAC) + background
        if shot:
            lanes = shot_noise_lanes(seed32, t, net.kicks_per_tick, P_ * N,
                                     dev)
        if event:
            # the input set: every PE receiving anything this tick
            src = n_fifo > 0
            if shot:
                src[lanes // N] = True
            if t < net.stim_ticks:
                src[0] = True
            i_syn = syn_accum(we, wi, net.w_ff, net.w_inh, *compact(src, cap))
        else:
            i_syn = syn_accum(we, wi, net.w_ff, net.w_inh)
        if shot:
            i_syn.view(-1).index_add_(0, lanes, kicks)
        else:
            i_syn += torch.round(noise(t) * net.noise_sigma_fx).to(
                torch.int32)
        if t < net.stim_ticks:
            i_syn[0, :NE] += net.stim_current_fx

        # 4. LIF update + accounting
        v, ref, spk = lif_step(state["v"], state["ref"], i_syn, **net.lif)
        syn_events = ((arr_exc * net.deg_ff).sum(1)
                      + (arr_inh * net.deg_inh).sum(1)).to(torch.int32)
        e_dvfs = em.tick_energy(pl, N, syn_events, dvfs=True)
        e_pl3 = em.tick_energy(torch.full_like(pl, 2), N, syn_events,
                               dvfs=False)

        # 5. route spikes (multicast ring -> next PE FIFO; inh -> own FIFO)
        spk_exc, spk_inh = spk[:, :NE], spk[:, NE:]
        state["exc_buf"][t % d_exc] = pack_spikes(exchange(spk_exc), NE)
        state["inh_buf"][t % d_inh] = pack_spikes(spk_inh, sp.n_inh)
        state["v"], state["ref"] = v, ref
        rec = {
            "pl": pl, "n_fifo": n_fifo, "syn_events": syn_events,
            # one multicast packet per spiking exc neuron: the NoC source
            # counts the chip engine prices against the incidence
            "packets": spk_exc.sum(1, dtype=torch.int32),
            "spikes_exc": spk_exc.to(torch.int8),
            "spikes_inh": spk_inh.to(torch.int8),
            "e_dvfs_baseline": e_dvfs["baseline"],
            "e_dvfs_neuron": e_dvfs["neuron"],
            "e_dvfs_synapse": e_dvfs["synapse"],
            "t_sp": e_dvfs["t_sp"],
            "e_pl3_baseline": e_pl3["baseline"],
            "e_pl3_neuron": e_pl3["neuron"],
            "e_pl3_synapse": e_pl3["synapse"],
        }
        return state, rec

    return tick


def run_ticks(step, state, n_ticks: int, observe=None,
              keep_records: bool = True) -> dict:
    """Drive ``step(state, t)`` for t = 0..n_ticks-1 and stack its records
    into (T, ...) tensors allocated once, after the first tick shows the
    record shapes.  ``observe(rec)``, called with the first tick's
    records, returns ``fold(rec, t)``, which then sees every tick's
    records (the probes' accumulators, allocated once the same way);
    ``keep_records=False`` stacks none of them."""
    recs, fold = None, None
    for t in range(n_ticks):
        state, rec = step(state, t)
        if recs is None:
            recs = {k: torch.empty((n_ticks,) + tuple(v.shape),
                                   dtype=v.dtype, device=v.device)
                    for k, v in rec.items()} if keep_records else {}
            fold = observe(rec) if observe is not None else None
        if keep_records:
            for k, v in rec.items():
                recs[k][t] = v
        if fold is not None:
            fold(rec, t)
    return recs or {}


def simulate_synfire(net: SynfireNet, n_ticks: int, seed: int = 1,
                     noise=None, event: bool = False) -> dict:
    """Per-tick records (all (T, P) unless noted): pl, n_fifo,
    syn_events, packets, spikes_exc (T, P, 200), spikes_inh (T, P, 50),
    t_sp and both energy accountings (dvfs / only-PL3).  ``event=True``
    runs the activity-compressed tick; the records are bitwise the
    same."""
    sp = net.params
    tick = make_synfire_tick(net, dvfs=DVFSController(sp.l_th1, sp.l_th2),
                             em=PEEnergyModel(), seed=seed, noise=noise,
                             event=event)
    return run_ticks(tick, synfire_init_state(net), n_ticks)


def synfire_power_table(recs: dict, t_sys_s: float = 1e-3) -> dict:
    """Average per-PE power [mW], DVFS vs only-PL3: the paper's Table III."""
    def avg_mw(x):
        return float(x.mean() / t_sys_s * 1e3)

    out = {}
    for mode in ("dvfs", "pl3"):
        base = avg_mw(recs[f"e_{mode}_baseline"])
        neur = avg_mw(recs[f"e_{mode}_neuron"])
        syn = avg_mw(recs[f"e_{mode}_synapse"])
        out[mode] = {"baseline": base, "neuron": neur, "synapse": syn,
                     "total": base + neur + syn}
    out["reduction"] = {
        k: (1.0 - out["dvfs"][k] / out["pl3"][k]) if out["pl3"][k] else 0.0
        for k in ("baseline", "neuron", "synapse", "total")
    }
    return out
