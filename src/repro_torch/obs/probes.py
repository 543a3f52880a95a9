"""Declarative probes over the engine's per-tick records.

A ``ProbeSpec`` names a per-tick record signal (any key the program's
semantics or the engine reports: ``link_flits``, ``packets``, ``pl``,
``e_learn``, ``learn/<slot>/dw``, ...) and how to record it:

* ``stride``: one sample every ``stride`` ticks (``None``: one sample
  for the whole run), so a long board run keeps a few strided samples of
  a (n_links,) signal instead of the (T, n_links) timeline;
* ``op``: the reduction folded tick by tick over each tumbling window,
  ``peak`` / ``mean`` / ``sum``, ``last`` (the sample at the window's
  end), or ``ema`` (one exponential moving average over the whole run,
  sampled at window ends).

``ChipSim.run(probes=...)`` allocates the accumulators once, from the
first tick's records, and folds every tick's records into them on the
device: no host round trip a tick, no (T, ...) allocation.  The window
bookkeeping (first tick of a window, window end, tick count) is host
arithmetic on the integer tick.  With ``probes=()`` (the default) the
run is exactly the bare engine's.

The probe buffers come back under ``recs["probes"][name]`` with shape
``(n_samples, *signal_shape)``, float32; ``keep_records=False`` drops
the per-tick records and returns only the probe output.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

PROBE_OPS = ("peak", "mean", "sum", "ema", "last")


@dataclass(frozen=True)
class ProbeSpec:
    """One recorded signal: ``key`` into the per-tick rec, windowed
    ``op``, sampling ``stride`` in ticks (None = whole run), EMA decay
    ``alpha`` (only for ``op="ema"``)."""
    name: str
    key: str
    op: str = "last"
    stride: Optional[int] = None
    alpha: float = 0.1

    def __post_init__(self):
        if self.op not in PROBE_OPS:
            raise ValueError(f"probe {self.name!r}: unknown op {self.op!r};"
                             f" expected one of {PROBE_OPS}")
        if self.stride is not None and self.stride < 1:
            raise ValueError(f"probe {self.name!r}: stride must be >= 1, "
                             f"got {self.stride}")
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"probe {self.name!r}: ema alpha must be in "
                             f"(0, 1], got {self.alpha}")


# ---------------------------------------------------------------------------
# Registry: named probe sets over the signals every program guarantees
# ---------------------------------------------------------------------------

def _link_flit_probes(program, stride=None):
    """Per-link DNoC flit loads: the congestion signal."""
    return (ProbeSpec("link_flits_peak", "link_flits", "peak", stride),
            ProbeSpec("link_flits_mean", "link_flits", "mean", stride))


def _pe_activity_probes(program, stride=None):
    """Per-PE NoC source activity (multicast packets emitted)."""
    return (ProbeSpec("pe_packets_sum", "packets", "sum", stride),)


def _dvfs_probes(program, stride=None):
    """Per-PE performance level: the DVFS trajectory (mean level plus a
    continuously averaged hardware-counter view)."""
    return (ProbeSpec("pe_pl_mean", "pl", "mean", stride),
            ProbeSpec("pe_pl_ema", "pl", "ema", stride, alpha=0.05))


def _energy_probes(program, stride=None):
    """Per-PE Eq. (1) energy under DVFS plus the NoC traffic energy."""
    return (ProbeSpec("pe_e_dvfs_baseline_sum", "e_dvfs_baseline", "sum",
                      stride),
            ProbeSpec("pe_e_dvfs_synapse_sum", "e_dvfs_synapse", "sum",
                      stride),
            ProbeSpec("e_noc_sum", "e_noc", "sum", stride))


def _activity_probes(program, stride=None):
    """Event-sparsity telemetry: active sources, their fraction and the
    touched links, in total and per tier (both exec modes record them
    alike)."""
    out = [ProbeSpec("active_pe_mean", "active_sources", "mean", stride),
           ProbeSpec("active_frac_mean", "active_frac", "mean", stride),
           ProbeSpec("touched_links_mean", "touched_links", "mean", stride)]
    # per-tier keys mirror the engine: empty tiers (1x1 board) emit none
    for tier, m in program.noc.tier_masks().items():
        if np.asarray(m).any():
            out.append(ProbeSpec(f"touched_links_{tier}_mean",
                                 f"touched_links_{tier}", "mean", stride))
    return tuple(out)


def _learn_probes(program, stride=None):
    """Per-PE learning energy and each slot's mean |dw| (a plastic
    program records both)."""
    if not getattr(program, "learn_slots", ()):
        return ()
    out = [ProbeSpec("pe_e_learn_sum", "e_learn", "sum", stride)]
    out += [ProbeSpec(f"learn_dw_{s.name}", f"learn/{s.name}/dw", "mean",
                      stride) for s in program.learn_slots]
    return tuple(out)


PROBE_REGISTRY = {
    "link_flits": _link_flit_probes,
    "pe_packets": _pe_activity_probes,
    "activity": _activity_probes,
    "dvfs": _dvfs_probes,
    "energy": _energy_probes,
    "learn": _learn_probes,
}


def default_probes(program, stride: Optional[int] = None) -> tuple:
    """The standard probe set: congestion, activity, DVFS, energy, and
    the learn tier when the program is plastic."""
    specs: list = []
    for build in PROBE_REGISTRY.values():
        specs.extend(build(program, stride))
    return tuple(specs)


def resolve_probes(program, probes) -> tuple:
    """``probes`` as a tuple of ``ProbeSpec``: specs, registry names
    ("link_flits", "dvfs", ...) or both.  Duplicate probe names are
    refused (one would shadow the other in the output)."""
    specs: list = []
    for p in probes:
        if isinstance(p, ProbeSpec):
            specs.append(p)
        elif isinstance(p, str):
            try:
                specs.extend(PROBE_REGISTRY[p](program))
            except KeyError:
                raise ValueError(
                    f"unknown probe set {p!r}; registry has "
                    f"{sorted(PROBE_REGISTRY)}") from None
        else:
            raise TypeError(f"probe {p!r} is neither a ProbeSpec nor a "
                            "registry name")
    names = [s.name for s in specs]
    dup = {n for n in names if names.count(n) > 1}
    if dup:
        raise ValueError(f"duplicate probe names: {sorted(dup)}")
    return tuple(specs)


# ---------------------------------------------------------------------------
# The fold over a run's ticks
# ---------------------------------------------------------------------------

def n_probe_samples(n_ticks: int, stride: Optional[int]) -> int:
    """Samples a probe emits over ``n_ticks``: one per tumbling window,
    the final partial window included."""
    s = n_ticks if stride is None else min(stride, n_ticks)
    return -(-n_ticks // s) if n_ticks else 0


def make_probe_step(probes: tuple, rec_shapes: dict, n_ticks: int,
                    row_views: Optional[dict] = None):
    """Compile ``probes`` against the per-tick record layout.

    ``rec_shapes`` maps rec keys to tensors of the tick's shapes (the
    first tick's records: the accumulators go on their devices);
    ``row_views`` maps a key that the tick records only as a row of a
    stacked record to (stacked key, row) (``ChipSim.run`` passes its
    learn groups' per-slot keys).  Returns
    ``(obs, step, finalize)``:

    * ``obs``: per fold (a probe, or a slot group's rows under one op,
      stride and alpha) a float32 window accumulator and the
      (n_samples, ...) output buffer;
    * ``step(obs, rec, t)``: folds tick ``t``'s signal into the
      accumulator and, at a window's end, writes the reduced sample;
    * ``finalize(obs) -> {name: (n_samples, ...)}``.

    Windows are tumbling: sample s covers ticks [s*stride, (s+1)*stride),
    the last one possibly shorter (``mean`` divides by its true tick
    count).  ``ema`` never resets: one average over the run, seeded with
    the first tick's value, sampled at window ends.
    """
    row_views = row_views or {}
    # probes of rows of one stacked record (see ``row_views``) with one
    # op, stride and alpha fold as one batched
    # accumulator: the same elementwise arithmetic, one set of launches
    # for the group however many slots it has
    folds: dict = {}
    for p in probes:
        if p.key in rec_shapes:
            key, row = p.key, None
        elif row_views.get(p.key, (None,))[0] in rec_shapes:
            key, row = row_views[p.key]
        else:
            raise KeyError(
                f"probe {p.name!r} reads rec key {p.key!r} which this "
                f"program's tick does not report; available keys: "
                f"{sorted(set(rec_shapes) | set(row_views))}")
        stride = n_ticks if p.stride is None else min(p.stride, n_ticks)
        fold = folds.setdefault(
            (p.name,) if row is None else (key, p.op, stride, p.alpha),
            (p, key, stride, [], []))
        fold[3].append(row)
        fold[4].append(p.name)

    compiled, obs = [], []
    for p, key, stride, rows, names in folds.values():
        like = rec_shapes[key]
        shape, pick = tuple(like.shape), None
        if rows != [None]:
            shape = (len(rows),) + shape[1:]
            if rows != list(range(like.shape[0])):
                pick = torch.as_tensor(rows, device=like.device)
        n_samples = n_probe_samples(n_ticks, stride)
        obs.append({
            "acc": torch.zeros(shape, dtype=torch.float32,
                               device=like.device),
            "buf": torch.zeros((max(n_samples, 1),) + shape,
                               dtype=torch.float32, device=like.device)})
        compiled.append((p.op, p.alpha, key, pick, stride, n_samples,
                         names, rows != [None]))
    order = [p.name for p in probes]

    def step(obs, rec, t: int):
        for st, (op, alpha, key, pick, stride, n_samples, *_) in zip(
                obs, compiled):
            acc = st["acc"]
            v = rec[key] if pick is None else rec[key][pick]
            v = v.to(torch.float32)
            first = t % stride == 0            # first tick of this window
            if op == "ema":
                if t == 0:
                    acc.copy_(v)
                else:
                    acc.mul_(1.0 - alpha).add_(alpha * v)
            elif first or op == "last":
                acc.copy_(v)
            elif op == "peak":
                torch.maximum(acc, v, out=acc)
            else:                              # mean, sum
                acc.add_(v)
            # window end: the stride boundary or the run's final tick
            if (t + 1) % stride == 0 or t == n_ticks - 1:
                slot = min(t // stride, n_samples - 1)
                if op == "mean":
                    cnt = torch.tensor(float(t % stride + 1),
                                       device=acc.device)
                    st["buf"][slot] = acc / cnt
                else:
                    st["buf"][slot] = acc
        return obs

    def finalize(obs) -> dict:
        out = {}
        for st, (*_, names, batched) in zip(obs, compiled):
            if batched:
                out.update((n, st["buf"][:, i]) for i, n in enumerate(names))
            else:
                out[names[0]] = st["buf"]
        return {name: out[name] for name in order}

    return obs, step, finalize


def make_batched_probe_step(probes: tuple, rec_shapes: dict, n_ticks: int,
                            batch: int, device=None):
    """``make_probe_step`` over a leading fleet axis of ``batch``
    independent instances, each with its own local tick counter.

    ``rec_shapes`` maps rec keys to one instance's record shapes
    (tuples); the accumulators go on ``device`` (the CUDA device
    unless the caller asks for the CPU).  Returns ``(init, step,
    finalize)``:

    * ``init``: per probe ``acc`` (batch, *shape), ``cnt`` (batch,) ticks
      folded into the open window, ``buf`` (batch, n_samples, *shape),
      and for ``ema`` ``acc_seen`` (batch,), each float32: the
      reference's layout, so a fleet checkpoint reads across;
    * ``step(obs, rec, t)``: ``rec`` leaves (batch, ...), ``t`` (batch,)
      int tensor of each instance's local tick; returns the new obs.
      Every window decision is a mask on ``t`` and the counts, and each
      instance writes its sample at its own index, so there is no host
      branch and no host synchronisation;
    * ``finalize(obs) -> {name: (batch, n_samples, ...)}``.

    A window opens at an instance's first folded tick (``cnt == 0``), as
    in the reference's fold, so an instance that joins mid-window folds
    only the ticks it ran, and ``ema`` seeds with the first tick it saw
    (``acc_seen``).  Per instance the arithmetic is the unbatched fold's.
    """
    from repro_torch import resolve_device
    device = resolve_device(device)
    for p in probes:
        if p.key not in rec_shapes:
            raise KeyError(
                f"probe {p.name!r} reads rec key {p.key!r} which this "
                f"program's tick does not report; available keys: "
                f"{sorted(rec_shapes)}")
    rows = torch.arange(batch, device=device)
    compiled, init = [], {}
    for p in probes:
        shape = tuple(rec_shapes[p.key])
        stride = n_ticks if p.stride is None else min(p.stride, n_ticks)
        n_samples = n_probe_samples(n_ticks, p.stride)

        def zeros(*s):
            return torch.zeros((batch,) + s, dtype=torch.float32,
                               device=device)

        init[p.name] = {"acc": zeros(*shape), "cnt": zeros(),
                        "buf": zeros(max(n_samples, 1), *shape)}
        if p.op == "ema":
            init[p.name]["acc_seen"] = zeros()
        compiled.append((p, stride, n_samples, (batch,) + (1,) * len(shape)))

    def step(obs, rec, t):
        new = dict(obs)
        for p, stride, n_samples, col in compiled:
            st = obs[p.name]
            v = rec[p.key].to(torch.float32)
            cnt = st["cnt"] + 1.0
            if p.op == "ema":
                seen = st["acc_seen"].reshape(col) != 0.0
                acc = torch.where(seen, st["acc"] * (1.0 - p.alpha)
                                  + p.alpha * v, v)
            elif p.op == "last":
                acc = v
            else:
                first = st["cnt"].reshape(col) == 0.0
                acc = torch.where(first, v, torch.maximum(st["acc"], v)
                                  if p.op == "peak" else st["acc"] + v)
            emit = acc / cnt.reshape(col) if p.op == "mean" else acc
            # window end: the stride boundary or the run's final tick
            is_emit = ((t + 1) % stride == 0) | (t == n_ticks - 1)
            slot = torch.clamp(t // stride, max=n_samples - 1).long()
            buf = st["buf"].clone()
            buf[rows, slot] = torch.where(is_emit.reshape(col), emit,
                                          st["buf"][rows, slot])
            if p.op == "ema":
                new[p.name] = {"acc": acc, "cnt": cnt, "buf": buf,
                               "acc_seen": torch.ones_like(cnt)}
            else:
                new[p.name] = {
                    "acc": torch.where(is_emit.reshape(col),
                                       torch.zeros_like(acc), acc),
                    "cnt": torch.where(is_emit, 0.0, cnt), "buf": buf}
        return new

    def finalize(obs) -> dict:
        return {p.name: obs[p.name]["buf"] for p, *_ in compiled}

    return init, step, finalize


# ---------------------------------------------------------------------------
# The link-profile probe set
# ---------------------------------------------------------------------------

def link_profile_probes() -> tuple:
    """Whole-run per-link peak/mean flit loads."""
    return (ProbeSpec("link_flits_peak", "link_flits", "peak", stride=None),
            ProbeSpec("link_flits_mean", "link_flits", "mean", stride=None))


def link_profile(program, probe_out: dict) -> dict:
    """Whole-run link probes as the benchmarks' link-profile schema:
    per-link peak and mean flits and the on-chip/chip-to-chip tier
    boundary."""
    noc = program.noc
    peak = probe_out["link_flits_peak"][-1].cpu().numpy()
    mean = probe_out["link_flits_mean"][-1].cpu().numpy()
    return {
        "n_onchip_links": int(getattr(noc, "n_onchip_links", noc.n_links)),
        "peak": np.round(peak, 2).tolist(),
        "mean": np.round(mean, 4).tolist(),
    }


def record_link_profile(sim, n_ticks: int, **run_kw) -> dict:
    """Run ``sim`` with only the link-profile probes (no per-tick
    records: O(n_links) memory however long the run) and return the
    link profile."""
    recs = sim.run(n_ticks, probes=link_profile_probes(),
                   keep_records=False, **run_kw)
    return link_profile(sim.program, recs["probes"])
