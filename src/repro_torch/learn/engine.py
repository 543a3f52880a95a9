"""The engine side of on-mesh learning: learn state + per-tick update.

``ChipSim`` calls ``make_learn_step`` once per run; the returned function
runs right after the semantics' tick and is the only place weights
change.  The contract with a learnable ``TickSemantics``:

* its ``init_state`` holds ``state["learn"] = init_learn_state(program,
  device)`` (or ``learn_state_from_numpy`` of given arrays, e.g.
  pre-trained decoders);
* its tick reads weights from ``state["learn"][slot.name]["w"]`` (or a
  whole group's at once, ``LearnState.stacked``) and passes the
  ``"learn"`` state through unchanged;
* its per-tick ``rec`` reports, for each group of slots (``group_slots``,
  ``LearnState.groups``), one (G, ...) tensor a signal under
  ``state["learn"].signal_key(names, signal)``:

      pre   (G, n_pre)  pre-synaptic spikes this tick
      post  (G, n_post) post spikes        (STDP only)
      err   (G, n_post) arrived error      (PES only)

  so that a tick at hundreds of slots writes one record a signal, not
  one a slot.

The engine advances the eligibility traces, applies the rule
(``learn.rules``) and prices the tick's learning work (MAC-class weight
updates + exp-accelerator trace decays) into a per-PE ``e_learn`` record
charged to each slot's tiles, and reports each group's mean |weight
change| under its ``dw`` key.  This module alone knows the group keys:
``ChipSim.run`` hands out the reference's per-slot record keys
(``learn/<slot>/{pre,post,err,dw}``) at the end of a run through
``expand_learn_records``, and lets probes read them through
``learn_record_views``.  A program without plastic projections never
reaches this module.

Slots of one kind, rule and shape form a group (``group_slots``), held as
one stacked tensor a state key, and advance together: the reference's
``jax.vmap`` over a group is the leading group axis here.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.chip.graph import mac_dynamic_energy_j
from repro_torch.kernels.explog.ref import FX_ONE
from repro_torch.learn.rules import (exp_op_energy_j, pes_step,
                                     stdp_step_fx, trace_decays_fx,
                                     trace_step_fx, trace_to_hz)

STATE_KEYS = {"pes": ("w", "tr"), "stdp": ("w", "pre_tr", "post_tr")}
SIGNALS = {"pes": ("pre", "err"), "stdp": ("pre", "post")}


def group_slots(slots) -> list:
    """Batchable groups of learn slots: same kind, same (frozen, hashable)
    rule, same weight shape.  Slot order inside a group, and group order,
    follow program order."""
    groups: dict = {}
    for s in slots:
        groups.setdefault((s.kind, s.rule, s.n_pre, s.n_post),
                          []).append(s)
    return [tuple(g) for g in groups.values()]


def _group_key(names, signal: str) -> str:
    """Record key of a whole group's (G, ...) ``signal``."""
    return f"learn/{names[0]}..{names[-1]}/{signal}"


class LearnState(Mapping):
    """Per-slot weights and traces: ``state[slot]`` is a dict of views
    (``w`` and ``tr`` for PES, ``w``, ``pre_tr``, ``post_tr`` for STDP)
    into one stacked (G, ...) tensor per group and key, ``stacks``.

    The stacks may carry leading instance axes before the group axis,
    (w, G, ...) for a fleet of w instances of one program (``lead``);
    views and ``stacked`` then keep those axes in front."""

    def __init__(self, groups, stacks, _index=None):
        self.groups = groups
        self.stacks = stacks
        self._index = _index if _index is not None else (
            {s.name: (gi, i) for gi, g in enumerate(groups)
             for i, s in enumerate(g)}, {}, set())

    @property
    def lead(self) -> int:
        """Number of instance axes before the group axis: every weight
        stack is (..., G, n_pre, n_post)."""
        return self.stacks[0]["w"].dim() - 3 if self.stacks else 0

    def __getitem__(self, name):
        gi, i = self._index[0][name]
        lead = self.lead
        return {k: v.select(lead, i) for k, v in self.stacks[gi].items()}

    def __iter__(self):
        return iter(self._index[0])

    def __len__(self):
        return len(self._index[0])

    def replace(self, stacks) -> "LearnState":
        """The same slots over new ``stacks``."""
        return LearnState(self.groups, stacks, self._index)

    def stacked(self, names: tuple, key: str) -> torch.Tensor:
        """(len(names), ...) ``key`` of the named slots, consecutive slots
        of one group in order: a view of the group's stack."""
        runs = self._index[1]
        if names not in runs:
            gi, i0 = self._index[0][names[0]]
            run = tuple(s.name for s in self.groups[gi][i0:i0 + len(names)])
            if run != names:
                raise ValueError(f"slots {names[0]!r}..{names[-1]!r} are "
                                 f"not consecutive slots of one group")
            runs[names] = (gi, i0)
        gi, i0 = runs[names]
        return self.stacks[gi][key].narrow(self.lead, i0, len(names))

    def signal_key(self, names, signal: str) -> str:
        """Record key under which a tick reports ``signal`` (``pre``,
        ``post`` or ``err``) of the group whose slots are ``names``, in
        group order, as one (G, ...) tensor."""
        names = tuple(names)
        whole = self._index[2]
        if names not in whole:
            gi, _ = self._index[0][names[0]]
            if tuple(s.name for s in self.groups[gi]) != names:
                raise ValueError(f"slots {names[0]!r}..{names[-1]!r} are "
                                 f"not one whole learn group (group_slots)")
            whole.add(names)
        return _group_key(names, signal)

    def to(self, device) -> "LearnState":
        return self.replace([{k: v.to(device) for k, v in st.items()}
                             for st in self.stacks])

    def clone(self) -> "LearnState":
        return self.replace([{k: v.clone() for k, v in st.items()}
                             for st in self.stacks])

    def cpu(self) -> "LearnState":
        return self.to("cpu")

    def numpy(self) -> dict:
        """{slot: {key: ndarray}}, the reference's ``state["learn"]``."""
        return {n: {k: v.cpu().numpy() for k, v in self[n].items()}
                for n in self}


def _slot_init(s) -> dict:
    """Fresh numpy arrays of one slot: PES decoders float32 (Arm-core
    arithmetic); STDP weights and every trace int32 s16.15."""
    if s.kind == "pes":
        return {"w": np.full((s.n_pre, s.n_post), s.rule.w_init,
                             np.float32),
                "tr": np.zeros(s.n_pre, np.int32)}
    return {"w": np.full((s.n_pre, s.n_post),
                         int(round(s.rule.w_init * FX_ONE)), np.int32),
            "pre_tr": np.zeros(s.n_pre, np.int32),
            "post_tr": np.zeros(s.n_post, np.int32)}


def learn_state_from_numpy(arrays: dict, program, device=None) -> LearnState:
    """``arrays`` ({slot: {key: array}}, the reference's ``state["learn"]``
    as numpy) as the port's ``LearnState`` on ``device`` (the CUDA device
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    groups = group_slots(program.learn_slots)
    stacks = [{k: torch.as_tensor(np.stack([np.asarray(arrays[s.name][k])
                                            for s in g]), device=device)
               for k in STATE_KEYS[g[0].kind]} for g in groups]
    return LearnState(groups, stacks)


def init_learn_state(program, device=None) -> LearnState:
    """Fresh weight/trace state for every learn slot of ``program``."""
    return learn_state_from_numpy(
        {s.name: _slot_init(s) for s in program.learn_slots}, program,
        device)


def _signal(rec: dict, names: list, signal: str) -> torch.Tensor:
    """A group's (G, ...) ``signal`` from the tick's records."""
    key = _group_key(names, signal)
    if key not in rec:
        raise KeyError(
            f"plastic projections {names[0]!r}..{names[-1]!r} need the "
            f"semantics to report {signal!r} under "
            f"state['learn'].signal_key(names, {signal!r}) in its per-tick "
            f"rec (see repro_torch.learn.engine docstring)")
    return rec[key]


def mean_scale(n: int) -> float:
    """float32(1/n): the reference's jitted mean multiplies its sum by the
    float32 reciprocal of the count (XLA rewrites division by a
    constant)."""
    return float(np.float32(1) / np.float32(n))


def make_learn_step(program, device=None):
    """Per-tick learning update for ``program`` on ``device``.

    Returns ``step(learn_state, rec) -> (learn_state, rec_updates)``;
    ``rec_updates`` carries ``e_learn``, the (P,) per-PE learning energy
    of this tick, and each group's (G,) ``dw``.  The trace decay factors are
    constants of the rules: one ``fx_exp`` launch here evaluates every
    distinct tau of the program, once a run."""
    device = resolve_device(device)
    P = program.n_pes
    groups = group_slots(program.learn_slots)
    taus = [t for g in groups for t in (
        (g[0].rule.tau_ticks,) if g[0].kind == "pes"
        else (g[0].rule.tau_plus_ticks, g[0].rule.tau_minus_ticks))]
    decays = trace_decays_fx(taus, device)
    # per group: its slots' names, every slot's owning PEs concatenated
    # into one index_add_, and each slot's share (1 / its tile count)
    meta = []
    for g in groups:
        names = [s.name for s in g]
        counts = np.array([len(s.pe_ids) for s in g])
        ids = np.concatenate([np.asarray(s.pe_ids, np.int64) for s in g])
        rep = None if (counts == 1).all() else torch.as_tensor(
            np.repeat(np.arange(len(g)), counts), device=device)
        inv = torch.as_tensor(np.float32(1) / counts.astype(np.float32),
                              device=device)
        meta.append((names, torch.as_tensor(ids, device=device), rep, inv,
                     mean_scale(g[0].n_pre * g[0].n_post)))

    def step(lstate: LearnState, rec: dict):
        # a fleet's state carries leading instance axes: every op below
        # works on them as they come, one op a group whatever the width
        lead = lstate.stacks[0]["w"].shape[:lstate.lead]
        e = torch.zeros(lead + (P,), dtype=torch.float32, device=device)
        updates = {}
        stacks = []
        for g, st, (names, ids, rep, inv, mean_n) in zip(
                groups, lstate.stacks, meta):
            s0 = g[0]
            rule = s0.rule
            pre = _signal(rec, names, "pre")
            w_old = st["w"]
            if s0.kind == "pes":
                err = _signal(rec, names, "err")
                tr = trace_step_fx(st["tr"], pre, decays[rule.tau_ticks])
                act_hz = trace_to_hz(tr, rule.tau_ticks)
                w = pes_step(w_old, act_hz, err, rule, s0.n_pre)
                stacks.append({"w": w, "tr": tr})
                # event-driven: a zero-error tick dispatches no updates
                active = (err != 0).any(-1).to(torch.float32)
                macs = active * float(s0.n_pre * s0.n_post)  # (..., G)
                n_exp = float(s0.n_pre)
                dw = (w - w_old).abs().sum((-2, -1)) * mean_n
            else:
                post = _signal(rec, names, "post")
                w, ptr, qtr = stdp_step_fx(w_old, st["pre_tr"],
                                           st["post_tr"], pre, post, rule,
                                           decays)
                stacks.append({"w": w, "pre_tr": ptr, "post_tr": qtr})
                macs = (pre.to(torch.float32).sum(-1) * s0.n_post
                        + post.to(torch.float32).sum(-1) * s0.n_pre)
                n_exp = float(s0.n_pre + s0.n_post)
                dw = ((w - w_old).abs().to(torch.float32).sum((-2, -1))
                      * mean_n / FX_ONE)
            updates[_group_key(names, "dw")] = dw
            e_slot = (mac_dynamic_energy_j(macs) + exp_op_energy_j(n_exp)) \
                * inv
            e.index_add_(-1, ids,
                         e_slot if rep is None else e_slot[..., rep])
        updates["e_learn"] = e
        return lstate.replace(stacks), updates

    return step


def learn_record_views(groups) -> dict:
    """{per-slot record key: (group record key, row)} of every signal a
    run of these groups records."""
    out = {}
    for g in groups:
        names = [s.name for s in g]
        for sig in SIGNALS[g[0].kind] + ("dw",):
            for i, name in enumerate(names):
                out[f"learn/{name}/{sig}"] = (_group_key(names, sig), i)
    return out


def expand_learn_records(recs: dict, groups) -> dict:
    """Replace each (T, G, ...) group record of ``recs`` by the
    reference's per-slot keys, (T, ...) views of it."""
    views = learn_record_views(groups)
    for key, (gkey, i) in views.items():
        if gkey in recs:
            recs[key] = recs[gkey][:, i]
    for gkey, _ in views.values():
        recs.pop(gkey, None)
    return recs
