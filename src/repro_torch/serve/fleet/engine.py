"""The fleet engine: batched chip and board instances under user traffic.

One compiled ``ChipProgram`` (or board program: the engine never looks
inside), N resident user sessions, one batched step
(``ChipSim.make_batched_stepper``): the fleet's state holds every
session's full state (membrane, learn, stimulus) along a leading
instance axis, and a scheduling round advances all resident sessions
``round_ticks`` ticks, each at its own local tick (a (w,) device
tensor).  Between rounds the host does admission control:

* arrivals from the load generator land in the ``RequestQueue``
  (``repro_torch.serve.queue``);
* the queue's offered load (waiting + resident) runs through
  ``QueueDVFS``, the paper's spike-FIFO -> performance-level loop, to
  pick the target fleet width.  Bursts widen the batch; a draining queue
  narrows it, preempting tail sessions: their state slice is
  checkpointed (in memory, or through ``repro_torch.ckpt``) and they
  re-queue at the head, resuming later, possibly in another slot or in
  another engine;
* admitted sessions stream their input in each round: every resident
  session's next stimulus window, encoded at once (``stim_windows``: one
  host-to-device copy, one ``mac_gemm`` launch), replaces
  ``state["stim"]``; their per-tick outputs and joules stream out.

A round is a host loop of ``round_ticks`` batched steps with no host
synchronisation: each step writes the round's streamed records (the
scenario's outputs and the energy terms) into one (round_ticks, w, F)
buffer allocated once for each width, and the host copies it back once
a round.  A fleet of width 1 runs the unbatched engine's arithmetic, so
its outputs equal ``ChipSim.run``'s bit for bit.

``device`` is the CUDA device unless the caller asks for the CPU; the
scenario must live on the same device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.chip.chip import ChipSim
from repro_torch.chip.compile import compile as compile_graph
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core.dvfs import QueueDVFS
from repro_torch.learn.engine import LearnState
from repro_torch.obs.health import SloMonitor, default_fleet_slos
from repro_torch.obs.metrics import (MetricsRegistry, device_metrics_for,
                                     make_device_metrics)
from repro_torch.obs.probes import make_batched_probe_step, resolve_probes
from repro_torch.obs.spans import SpanLog, validate_spans
from repro_torch.serve.fleet.scenarios import ServedScenario, stim_windows
from repro_torch.serve.fleet.sessions import Session, SessionTable
from repro_torch.serve.queue import RequestQueue, percentiles

# the engine's simulated-energy tiers, summed per instance per tick
# (DVFS datapath + NoC traffic + learning engine when plastic)
ENERGY_KEYS = ("e_dvfs_baseline", "e_dvfs_neuron", "e_dvfs_synapse",
               "e_noc", "e_learn")


def _tmap(f, *trees):
    """``f`` over the tensor leaves of structurally equal trees of dicts,
    ``LearnState``s and tensors."""
    t0 = trees[0]
    if isinstance(t0, LearnState):
        return t0.replace([{k: f(*(t.stacks[gi][k] for t in trees))
                            for k in st} for gi, st in enumerate(t0.stacks)])
    if isinstance(t0, dict):
        return {k: _tmap(f, *(t[k] for t in trees)) for k in t0}
    return f(*trees)


def _numpy(tree):
    """A tree as plain nested dicts of numpy arrays that own their memory
    (never views of the device state): a ``LearnState`` as {slot: {key:
    array}}, the reference's layout."""
    if isinstance(tree, (dict, LearnState)):
        return {k: _numpy(tree[k]) for k in tree}
    return tree.to("cpu", copy=True).numpy()


def _put(dst, slot: int, src):
    """``dst`` (a batched tree) with instance ``slot`` replaced by
    ``src``: one instance's tree, of tensors or numpy arrays, whose learn
    state is a ``LearnState`` or {slot: {key: array}}.  New tensors: the
    old ones may be shared with other state entries."""
    def put(x, v):
        y = x.clone()
        y[slot] = torch.as_tensor(v, device=y.device)
        return y

    if isinstance(dst, LearnState):
        if isinstance(src, LearnState):
            stacks = src.stacks
        else:
            stacks = [{k: torch.stack([torch.as_tensor(src[s.name][k])
                                       for s in g]) for k in st}
                      for g, st in zip(dst.groups, dst.stacks)]
        return dst.replace([{k: put(st[k], new[k]) for k in st}
                            for st, new in zip(dst.stacks, stacks)])
    if isinstance(dst, dict):
        return {k: _put(dst[k], slot, src[k]) for k in dst}
    return put(dst, src)


def _same_device(a: torch.device, b: torch.device) -> bool:
    def index(d):
        return (d.index if d.index is not None
                else torch.cuda.current_device()) if d.type == "cuda" else 0
    return a.type == b.type and index(a) == index(b)


def broadcast_state(tree, w: int):
    """``w`` copies of one instance's tree along a new leading axis."""
    return _tmap(lambda x: x.expand((w,) + x.shape).clone(), tree)


@dataclass
class FleetObs:
    """The serving tier's observability bundle: one span log (request
    lifecycles + per-round fleet counters), one metrics registry
    (host-side scheduler/queue numbers + device-side round accumulators),
    and one SLO monitor evaluated per scheduling round.  ``FleetEngine``
    accepts ``obs=FleetObs()`` (or ``obs=True`` for this default
    configuration); with ``obs=None``, the default, NO observability code
    runs and the serve's outputs are bitwise those of an observed one."""
    spans: SpanLog = field(default_factory=SpanLog)
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    slos: tuple = field(default_factory=default_fleet_slos)
    device_metrics: tuple = None          # None = standard fleet set
    monitor: SloMonitor = None

    def __post_init__(self):
        if self.monitor is None:
            self.monitor = SloMonitor(self.slos, spans=self.spans)


class FleetEngine:
    """Serve a ``ServedScenario`` with a width-elastic batched fleet.

    ``exec_mode`` and ``noc_mode`` reach ``ChipSim`` unchanged: the
    records, and so the serve, do not depend on them."""

    def __init__(self, scenario: ServedScenario, *, round_ticks: int = 64,
                 dvfs: Optional[QueueDVFS] = None,
                 capacity: Optional[int] = None, probes=(),
                 probe_ticks: int = 1024, board=None, refine: bool = True,
                 ckpt_dir=None, seed: int = 1, keep_outputs: bool = True,
                 max_rounds: int = 100_000, exec_mode: str = "auto",
                 noc_mode: str = "auto",
                 obs: "FleetObs | bool | None" = None, device=None):
        self.device = resolve_device(device)
        if not _same_device(scenario.device, self.device):
            raise ValueError(f"scenario {scenario.name!r} lives on "
                             f"{scenario.device}, the engine on "
                             f"{self.device}; build both on one device")
        self.scenario = scenario
        self.Tc = int(round_ticks)
        self.dvfs = dvfs or QueueDVFS()
        self.ckpt_dir = None if ckpt_dir is None else Path(ckpt_dir)
        self.keep_outputs = keep_outputs
        self.max_rounds = max_rounds
        self.obs = FleetObs() if obs is True else (obs or None)

        graph = scenario.graph(self.Tc)
        if board is not None:
            from repro_torch.board import compile_board
            self.program = compile_board(graph, board, refine=refine)
        else:
            self.program = compile_graph(graph)
        self.sim = ChipSim(self.program, exec_mode=exec_mode,
                           noc_mode=noc_mode, device=self.device)
        self._template, self._step = self.sim.make_batched_stepper(
            seed=seed)

        self.capacity = int(capacity or max(self.dvfs.batch_levels))
        self.levels = sorted({min(int(l), self.capacity)
                              for l in self.dvfs.batch_levels})

        # one step of one instance shows the record layout
        _, rec = self._step(broadcast_state(self._template, 1),
                            torch.zeros(1, dtype=torch.int32,
                                        device=self.device))
        self._rec_shapes = {k: tuple(v.shape[1:]) for k, v in rec.items()}
        self._rec_dtypes = {k: v.dtype for k, v in rec.items()}
        del rec
        self.energy_keys = tuple(k for k in ENERGY_KEYS
                                 if k in self._rec_shapes)
        self.output_keys = tuple(scenario.output_keys)
        missing = [k for k in self.output_keys
                   if k not in self._rec_shapes]
        if missing:
            raise KeyError(f"scenario output keys {missing} not in this "
                           f"program's rec; have {sorted(self._rec_shapes)}")

        self.probe_specs = resolve_probes(self.program, probes)
        self.probe_ticks = int(probe_ticks)
        if self.probe_specs:
            binit1, _, fin = make_batched_probe_step(
                self.probe_specs, self._rec_shapes, self.probe_ticks, 1,
                device=self.device)
            self._obs_template = _tmap(lambda x: x[0], binit1)
            self._obs_fin = fin
        else:
            self._obs_template, self._obs_fin = {}, None
        self._probe_steps: dict = {}

        # the streamed records of a round, grouped by dtype: outputs (when
        # kept) and energy terms, (key, columns, shape) each
        streamed = (self.output_keys if keep_outputs else ()) \
            + tuple(k for k in self.energy_keys
                    if k not in self.output_keys)
        self._streams: dict = {}
        for k in streamed:
            shape = self._rec_shapes[k]
            cols = self._streams.setdefault(self._rec_dtypes[k], [])
            lo = cols[-1][1].stop if cols else 0
            cols.append((k, slice(lo, lo + int(np.prod(shape))), shape))
        self._buffers: dict = {}
        self._ticks = torch.arange(self.Tc, dtype=torch.int32,
                                   device=self.device)

        # device-side metric accumulators ride the round only when
        # observability is on
        if self.obs is not None:
            self._dev_specs = (
                device_metrics_for(self._rec_shapes)
                if self.obs.device_metrics is None
                else device_metrics_for(self._rec_shapes,
                                        self.obs.device_metrics))
            self.obs.spans.meta.setdefault("scenario", scenario.name)
            self.obs.spans.meta.setdefault("round_ticks", self.Tc)
            self.obs.spans.meta.setdefault(
                "levels", [int(l) for l in self.levels])
        else:
            self._dev_specs = ()
        self.queue = RequestQueue(
            spans=None if self.obs is None else self.obs.spans)
        self.table = SessionTable(self.capacity)
        self._carry = None              # {"st": batched, "obs": batched}
        self._width = 0

    # ------------------------------------------------------------ rounds
    def _round(self, w: int, t0s: list) -> tuple:
        """One scheduling round at width ``w``: ``round_ticks`` batched
        steps from the instances' local ticks ``t0s``.  Returns the
        round's streamed records on the host, {key: (Tc, w, ...)}, and
        the device-metric totals (observability on), {name: (w,)}."""
        Tc = self.Tc
        if self.probe_specs and w not in self._probe_steps:
            self._probe_steps[w] = make_batched_probe_step(
                self.probe_specs, self._rec_shapes, self.probe_ticks, w,
                device=self.device)[1]
        pstep = self._probe_steps.get(w)
        if self._dev_specs:
            met, dstep = make_device_metrics(self._dev_specs, w,
                                             device=self.device)
        else:
            met, dstep = {}, None
        bufs = self._buffers.get(w)
        if bufs is None:
            bufs = self._buffers[w] = {
                dt: torch.empty((Tc, w, cols[-1][1].stop), dtype=dt,
                                device=self.device)
                for dt, cols in self._streams.items()}
        t0 = torch.as_tensor(np.asarray(t0s, np.int32), device=self.device)
        ts = t0[None, :] + self._ticks[:, None]           # (Tc, w) local
        st, obs = self._carry["st"], self._carry["obs"]
        for i in range(Tc):
            st, rec = self._step(st, ts[i])
            if pstep is not None:
                obs = pstep(obs, rec, ts[i])
            if dstep is not None:
                met = dstep(met, rec)
            for dt, cols in self._streams.items():
                torch.cat([rec[k].reshape(w, -1) for k, _, _ in cols], -1,
                          out=bufs[dt][i])
        self._carry = {"st": st, "obs": obs}
        out = {}
        for dt, cols in self._streams.items():
            # the round's one sync; a copy, as the buffer is reused
            host = bufs[dt].to("cpu", copy=True).numpy()
            out.update((k, host[:, :, sl].reshape((Tc, w) + shape))
                       for k, sl, shape in cols)
        return out, {k: v.to("cpu", copy=True).numpy()
                     for k, v in met.items()}

    def width_for(self, n_active: int) -> int:
        """Smallest batch level covering ``n_active`` residents."""
        for l in self.levels:
            if l >= n_active:
                return l
        return self.levels[-1]

    # ----------------------------------------------- batched state admin
    def _template_tree(self) -> dict:
        return {"st": self._template, "obs": self._obs_template}

    def _ensure_width(self, w: int) -> None:
        if self._carry is None:
            self._carry = broadcast_state(self._template_tree(), w)
        elif self._width != w:
            def fix(x, tmpl):
                if x.shape[0] >= w:
                    return x[:w]
                pad = tmpl.expand((w - x.shape[0],) + tmpl.shape)
                return torch.cat([x, pad])
            self._carry = _tmap(fix, self._carry, self._template_tree())
        self._width = w

    def _gather(self, slot: int) -> dict:
        """Session snapshot: slot ``slot`` of the fleet's state, as numpy
        in the reference's layout."""
        return _numpy(_tmap(lambda x: x[slot], self._carry))

    def _scatter(self, slot: int, snap: dict) -> None:
        self._carry = _put(self._carry, slot, snap)

    def _move_slot(self, dst: int, src: int) -> None:
        def move(x):
            y = x.clone()
            y[dst] = x[src]
            return y
        self._carry = _tmap(move, self._carry)

    # ------------------------------------------------ checkpoint/restore
    def _ckpt_mgr(self, sid: int) -> CheckpointManager:
        return CheckpointManager(self.ckpt_dir / f"s{sid:06d}", keep=1,
                                 async_save=False)

    def _store(self, sess: Session, snap: dict) -> None:
        if self.ckpt_dir is None:
            sess.snapshot = snap
        else:
            self._ckpt_mgr(sess.sid).save(
                sess.ticks_done, snap,
                meta={"sid": sess.sid, "ticks_done": sess.ticks_done,
                      "scenario": self.scenario.name})
            sess.ckpt_step = sess.ticks_done

    def _load(self, sess: Session) -> dict:
        if self.ckpt_dir is not None and sess.ticks_done > 0:
            template = _numpy(self._template_tree())
            tree, manifest = self._ckpt_mgr(sess.sid).restore(
                template, device=self.device)
            if tree is not None:
                sess.ticks_done = int(manifest["meta"].get(
                    "ticks_done", sess.ticks_done))
                return tree
        if sess.snapshot is not None:
            return sess.snapshot
        return self._template_tree()      # fresh session

    def suspend(self) -> list:
        """Checkpoint and evict every resident session (graceful engine
        shutdown / drain).  Returns the suspended sessions; with a
        ``ckpt_dir`` another engine (or the reference's) can pick each
        one up through ``restore_session`` and continue bit for bit."""
        out = []
        while self.table.n_active:
            sess = self.table.evict_tail()
            self._store(sess, self._gather(self.table.n_active))
            if self.obs is not None:
                self.obs.spans.emit(
                    "suspend", sess.sid, ticks_done=sess.ticks_done,
                    ckpt="disk" if self.ckpt_dir is not None else "memory")
            out.append(sess)
        return out

    def restore_session(self, spec_or_sid, stream=None,
                        total_ticks: int = 0) -> Session:
        """Re-open a checkpointed session in THIS engine (possibly
        another process than the one that evicted it): reads the
        session's latest checkpoint step and returns it for admission."""
        sid = getattr(spec_or_sid, "sid", spec_or_sid)
        step = self._ckpt_mgr(sid).latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint for session {sid}")
        sess = Session(sid=sid,
                       stream=stream or self.scenario.stream(sid),
                       total_ticks=total_ticks)
        sess.ticks_done = step
        sess.ckpt_step = step
        return sess

    # -------------------------------------------------------- the server
    def _admit_specs(self, specs, t_base: float) -> None:
        for spec in specs:
            self.queue.submit(Session(
                sid=spec.sid, stream=self.scenario.stream(spec.seed),
                total_ticks=spec.total_ticks,
                arrival_s=time.perf_counter() - t_base))

    def serve(self, traffic, *, sessions=None) -> dict:
        """Drive the fleet until ``traffic`` is exhausted and every
        session has completed.  ``sessions`` optionally seeds the queue
        with pre-built ``Session`` objects (e.g. checkpointed resumes)
        ahead of generated arrivals."""
        t0 = time.perf_counter()
        obs = self.obs
        for s in (sessions or []):
            s.arrival_s = time.perf_counter() - t0
            self.queue.submit(s)
        completed: list = []
        width_hist: dict = {}
        tick_lat_s: list = []
        rounds = 0

        while rounds < self.max_rounds:
            rounds += 1
            if traffic is not None:
                self._admit_specs(traffic.poll(), t0)
            exhausted = traffic is None or traffic.exhausted

            target = min(self.capacity, self.dvfs.batch_size(
                self.queue.peek_depth_with(self.table.n_active)))
            # narrow: preempt tail sessions (checkpoint + requeue front)
            while self.table.n_active > target:
                sess = self.table.evict_tail()
                self._store(sess, self._gather(self.table.n_active))
                sess.preemptions += 1
                if obs is not None:
                    obs.spans.emit(
                        "preempt", sess.sid, round_i=rounds - 1,
                        slot=self.table.n_active, target=target,
                        ticks_done=sess.ticks_done,
                        ckpt="disk" if self.ckpt_dir is not None
                        else "memory")
                    obs.metrics.counter("preempted").inc()
                self.queue.submit(sess, front=True)
            # widen: admit from the queue into compact slots
            while self.table.n_active < target and self.queue:
                sess = self.queue.take(1)[0]
                self._ensure_width(self.width_for(self.table.n_active + 1))
                slot = self.table.admit(sess)
                if sess.admitted_s is None:
                    sess.admitted_s = time.perf_counter() - t0
                self._scatter(slot, self._load(sess))
                sess.snapshot = None
                if obs is not None:
                    # a session with served ticks is resuming (it was
                    # preempted here, or restored from another engine's
                    # checkpoint); a fresh session is admitted
                    kind = "resume" if sess.ticks_done > 0 else "admit"
                    obs.spans.emit(kind, sess.sid, round_i=rounds - 1,
                                   slot=slot, width=target,
                                   ticks_done=sess.ticks_done)
                    obs.metrics.counter(
                        "resumed" if kind == "resume" else "admitted").inc()

            n_active = self.table.n_active
            if n_active == 0:
                if exhausted and not self.queue:
                    break
                continue
            w = self.width_for(n_active)
            self._ensure_width(w)
            width_hist[w] = width_hist.get(w, 0) + 1

            # stream this round's stimulus windows into the state: every
            # slot's in one encode, idle slots silent
            sig = np.zeros((w, self.Tc), np.float32)
            for slot, s in enumerate(self.table.slots):
                sig[slot] = s.stream.signal(s.ticks_done, self.Tc)
            self._carry["st"] = {**self._carry["st"],
                                 "stim": stim_windows(self.scenario.ens,
                                                      sig)}
            t0s = [s.ticks_done for s in self.table.slots] \
                + [0] * (w - n_active)

            wall0 = time.perf_counter()
            outs_np, met = self._round(w, t0s)
            round_s = time.perf_counter() - wall0
            tick_lat_s.append(round_s / self.Tc)

            es_np = np.zeros((self.Tc, w), np.float32)    # (Tc, w) joules
            for k in self.energy_keys:
                v = outs_np[k]
                es_np = es_np + v.reshape(self.Tc, w, -1).sum(-1)
            done_slots = []
            for slot, sess in enumerate(self.table.slots):
                use = min(sess.remaining, self.Tc)
                if obs is not None:
                    obs.spans.emit("round", sess.sid, round_i=rounds - 1,
                                   slot=slot, width=w,
                                   t0_ticks=sess.ticks_done, ticks=use,
                                   start_s=wall0 - t0, dur_s=round_s)
                sess.ticks_run += self.Tc
                sess.energy_j += float(es_np[:, slot].sum())
                if self.keep_outputs:
                    for k in self.output_keys:
                        sess.outputs.setdefault(k, []).append(
                            outs_np[k][:use, slot])
                sess.ticks_done += use
                if sess.done:
                    done_slots.append(slot)
            for slot in sorted(done_slots, reverse=True):
                sess = self.table.slots[slot]
                sess.done_s = time.perf_counter() - t0
                if self.keep_outputs:
                    cat = {k: np.concatenate(v)
                           for k, v in sess.outputs.items()}
                    sess.outputs = cat
                    if self._obs_fin is not None:
                        obs_slot = _tmap(lambda x: x[slot],
                                         self._carry["obs"])
                        sess.outputs["probes"] = {
                            k: v.cpu().numpy() for k, v in
                            self._obs_fin(obs_slot).items()}
                    if self.scenario.response is not None:
                        sess.response = self.scenario.response(cat)
                _, moved_from = self.table.evict(slot)
                if moved_from is not None:
                    self._move_slot(slot, moved_from)
                completed.append(sess)
                if obs is not None:
                    obs.spans.emit(
                        "complete", sess.sid, round_i=rounds - 1,
                        ticks_done=sess.ticks_done,
                        energy_j=round(sess.energy_j, 9),
                        latency_s=round(sess.latency_s(), 6))
            if obs is not None:
                self._observe_round(obs, rounds - 1, w, n_active, round_s,
                                    es_np, met, completed, t0, wall0)

        wall = time.perf_counter() - t0
        lat = [s.latency_s() for s in completed]
        ticks_served = sum(s.ticks_done for s in completed)
        stats = {
            "completed": len(completed),
            "rounds": rounds,
            "wall_s": wall,
            "sessions_per_s": len(completed) / wall if wall > 0 else 0.0,
            "ticks_served": ticks_served,
            "ticks_run": sum(s.ticks_run for s in completed),
            "ticks_per_s": ticks_served / wall if wall > 0 else 0.0,
            "request_latency_s": percentiles(lat),
            "tick_latency_s": percentiles(tick_lat_s),
            "joules_per_request": (float(np.mean([s.energy_j
                                                  for s in completed]))
                                   if completed else 0.0),
            "preemptions": sum(s.preemptions for s in completed),
            "width_hist": {str(k): v for k, v in sorted(width_hist.items())},
            "queue": self.queue.stats(),
        }
        result = {"sessions": completed, "stats": stats}
        if obs is not None:
            dropped = len(self.queue) + self.table.n_active
            errors = validate_spans(obs.spans.events)
            stats["health"] = obs.monitor.verdict(dropped=dropped,
                                                  span_errors=errors)
            result["obs"] = {"spans": obs.spans,
                             "metrics": obs.metrics.snapshot(),
                             "health": stats["health"]}
        return result

    # ------------------------------------------------- per-round telemetry
    def _observe_round(self, obs, round_i: int, w: int, n_active: int,
                       round_s: float, es_np, met, completed, t0,
                       wall0) -> None:
        """Fold one scheduling round into the observability bundle:
        fleet counter sample, host and device metrics, SLO check.  Pure
        bookkeeping: nothing here feeds back into scheduling."""
        m = obs.metrics
        tick_us = round_s / self.Tc * 1e6
        round_e = float(es_np[:, :n_active].sum())
        m.counter("rounds").inc()
        m.counter("ticks_run").inc(n_active * self.Tc)
        m.counter("energy_j").inc(round_e)
        m.gauge("width").set(w)
        m.gauge("n_active").set(n_active)
        m.gauge("queue_depth").set(len(self.queue))
        m.histogram("tick_us", scale=1.0).observe(tick_us)
        for s in self._dev_specs:
            vals = met[s.name][:n_active]
            if s.op == "sum":
                m.counter(f"dev/{s.name}").inc(float(vals.sum()))
            elif vals.size:
                # snapshot suffixes gauges with _peak itself
                m.gauge(f"dev/{s.name}").set(float(vals.max()))
        # completion-derived quantities (latency / energy / throughput)
        elapsed = time.perf_counter() - t0
        n_done = len(completed)
        m.gauge("sessions_per_s").set(n_done / elapsed if elapsed else 0.0)
        admitted = m.counter("admitted").value
        m.gauge("preempt_rate").set(
            m.counter("preempted").value / max(1.0, admitted))
        if n_done:
            m.gauge("mj_per_request").set(
                float(np.mean([s.energy_j for s in completed])) * 1e3)
        lat_hist = m.histogram("req_latency_s", scale=1e-3)
        done_this_round = [s for s in completed
                           if s.done_s is not None
                           and s.done_s >= wall0 - t0]
        for sess in done_this_round:
            lat_hist.observe(sess.latency_s())
        obs.spans.sample(round_i, width=w, n_active=n_active,
                         queue_depth=len(self.queue),
                         tick_us=round(tick_us, 3),
                         round_s=round(round_s, 6),
                         energy_j=round(round_e, 9),
                         completed=len(completed))
        obs.monitor.check(m.snapshot(), round_i=round_i)
