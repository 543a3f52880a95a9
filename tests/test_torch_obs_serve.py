"""The port's serving-tier observability (``repro_torch.obs.{spans,
metrics,health}`` through ``FleetEngine``, and the fleet half of
``obs.trace``) against the JAX reference's, on the CPU.

* spans, health and metrics give the reference's results on the same
  events (the cases of tests/test_obs_serve.py): the span grammar's
  verdicts on valid and broken chains, span logs read across packages,
  counters, gauges, histograms and snapshots, SLO parsing, checks and
  verdicts;
* an observed serve of the port (adaptive 1 x 32, rounds of 32 ticks,
  levels (1, 4), threshold 3) validates its chains, records its
  preemptions and counters, and its device counters equal the host sums
  of the same serve's records;
* observability off is bitwise free; chains validate across
  suspend-to-disk and restore, and SLOs gate the serve;
* ``fleet_trace_events`` gives the reference's payload for the same
  span log, and ``python -m repro_torch.obs.trace --fleet`` writes it.
"""
import gzip
import json

import numpy as np
import pytest

from repro.obs.health import SloMonitor as JSloMonitor
from repro.obs.health import SloRule as JSloRule
from repro.obs.health import default_fleet_slos as j_default_fleet_slos
from repro.obs.health import parse_slo as j_parse_slo
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.obs.spans import SpanLog as JSpanLog
from repro.obs.spans import load_spans as j_load_spans
from repro.obs.spans import validate_spans as j_validate_spans
from repro.obs.trace import fleet_trace_events as j_fleet_trace_events

from repro_torch.core.dvfs import QueueDVFS
from repro_torch.obs import (Counter, Gauge, Histogram, MetricsRegistry,
                             SloMonitor, SloRule, SpanLog,
                             default_fleet_slos, load_spans, parse_slo,
                             validate_spans)
from repro_torch.obs.spans import FLEET_SID
from repro_torch.obs.trace import fleet_trace_events
from repro_torch.obs.trace import main as trace_main
from repro_torch.serve import RequestQueue
from repro_torch.serve.fleet import (FleetEngine, FleetObs, Session,
                                     adaptive_scenario)

TC = 32


@pytest.fixture(scope="module")
def sc():
    return adaptive_scenario(n_neurons=32, device="cpu")


# ------------------------------------------------------------ span grammar

CHAINS = {
    "preempt_resume": [("enqueue", {}), ("admit", {"slot": 0}),
                       ("round", {"ticks": TC}), ("preempt", {}),
                       ("enqueue", {"front": True}), ("resume", {}),
                       ("round", {"ticks": TC}), ("complete", {})],
    "admit_while_new": [("admit", {})],
    "round_while_queued": [("enqueue", {}), ("round", {})],
    "admit_after_ticks": [("enqueue", {}), ("admit", {}),
                          ("round", {"ticks": 4}), ("preempt", {}),
                          ("enqueue", {}), ("admit", {})],
    "resume_no_prior": [("enqueue", {}), ("resume", {})],
    "complete_twice": [("enqueue", {}), ("admit", {}), ("complete", {}),
                       ("complete", {})],
    "round_after_done": [("enqueue", {}), ("admit", {}), ("complete", {}),
                         ("round", {})],
    "enqueue_resident": [("enqueue", {}), ("admit", {}), ("enqueue", {})],
    "preempt_twice": [("enqueue", {}), ("admit", {}), ("preempt", {}),
                      ("preempt", {})],
    "restored_ok": [("enqueue", {"ticks_done": 64}), ("resume", {}),
                    ("round", {"ticks": TC}), ("complete", {})],
    "restored_admit": [("enqueue", {"ticks_done": 64}), ("admit", {})],
    "unfinished": [("enqueue", {}), ("admit", {})],
    "zero_tick_round": [("enqueue", {}), ("admit", {}),
                        ("round", {"ticks": 0}), ("preempt", {}),
                        ("enqueue", {}), ("resume", {})],
}


def _emit_all(log, chain, sid=0):
    for kind, args in chain:
        log.emit(kind, sid=sid, **args)
    return log


@pytest.mark.parametrize("name", sorted(CHAINS))
@pytest.mark.parametrize("require_complete", [False, True])
def test_span_grammar_matches_reference(name, require_complete):
    got = validate_spans(_emit_all(SpanLog(), CHAINS[name]).events,
                         require_complete=require_complete)
    want = j_validate_spans(_emit_all(JSpanLog(), CHAINS[name]).events,
                            require_complete=require_complete)
    assert got == want


def test_fleet_level_events_and_unknown_kinds():
    log = SpanLog()
    log.emit("slo", rule="tick_us<=5", value=9.0)
    assert log.events[0].sid == FLEET_SID
    assert validate_spans(log.events, require_complete=True) == []
    with pytest.raises(ValueError, match="unknown span kind"):
        SpanLog().emit("frobnicate", 0)


@pytest.mark.parametrize("compress", [False, True])
def test_span_logs_read_across_packages(tmp_path, compress):
    """A span log either package writes the other loads, and the payloads
    agree but for the wall-clock times."""
    def fill(log):
        log.meta["scenario"] = "t"
        _emit_all(log, CHAINS["preempt_resume"], sid=3)
        log.sample(0, width=4, queue_depth=2)
        return log
    ours = fill(SpanLog()).write(tmp_path / "ours.json", compress=compress)
    theirs = fill(JSpanLog()).write(tmp_path / "theirs.json",
                                    compress=compress)
    a, b = j_load_spans(ours), load_spans(theirs)
    assert a["schema"] == b["schema"] == "fleet-spans-v1"
    for p in (a, b):
        assert p["meta"] == {"scenario": "t"}
        assert [(e["kind"], e["sid"], e["args"]) for e in p["events"]] == \
            [(k, 3, args) for k, args in CHAINS["preempt_resume"]]
        assert validate_spans(p["events"], require_complete=True) == []
    assert ours.suffix == (".gz" if compress else ".json")


def test_queue_emits_enqueue_spans(sc):
    log = SpanLog()
    q = RequestQueue(spans=log)
    q.submit("no-sid-item")
    s = Session(sid=5, stream=sc.stream(0), total_ticks=TC)
    s.ticks_done = 2 * TC
    q.submit(s, front=True)
    assert len(log.events) == 1
    ev = log.events[0]
    assert ev.kind == "enqueue" and ev.sid == 5
    assert ev.args == {"front": True, "depth": 2, "ticks_done": 2 * TC}


# ---------------------------------------------------------------- metrics

def _observe(reg):
    reg.counter("a").inc()
    reg.counter("a").inc(2.5)
    for v in (4, 2, 9, 1):
        reg.gauge("g").set(v)
    h = reg.histogram("h", scale=1e-6, n_buckets=40)
    for v in (3e-6, 1e-6, 2e-6, 4e-6, 1e-3, 2e-3, 5e-7, 1e9):
        h.observe(v)
    reg.histogram("lat", scale=1e-3)
    reg.histogram("one", scale=1.0).observe(17.0)
    return reg


def test_metrics_registry_matches_reference():
    got, want = _observe(MetricsRegistry()), _observe(JMetricsRegistry())
    assert got.snapshot() == want.snapshot()
    assert got.names() == want.names()
    with pytest.raises(TypeError):
        got.gauge("a")


def test_metric_types():
    c, g, h = Counter(), Gauge(), Histogram(scale=1e-6, n_buckets=40)
    c.inc()
    g.set(3)
    g.set(1)
    assert (c.value, g.value, g.peak) == (1.0, 1.0, 3.0)
    assert h.percentile(99) == 0.0 and h.mean == 0.0
    for v in (1e-6, 2e-3):
        h.observe(v)
    assert h.percentile(99) == h.max == 2e-3
    with pytest.raises(ValueError):
        Histogram(scale=0.0)


# ----------------------------------------------------------------- health

@pytest.mark.parametrize("spec", ["req_latency_s_p99<=2.5",
                                  "sessions_per_s>=10:critical",
                                  " dev/pl_peak <= 2 :warn", "m>=-1e-3"])
def test_parse_slo_matches_reference(spec):
    r, j = parse_slo(spec), j_parse_slo(spec)
    assert (r.metric, r.op, r.threshold, r.level, r.name) == \
        (j.metric, j.op, j.threshold, j.level, j.name)


@pytest.mark.parametrize("bad", ["nope", "m<5", "m<=x", "m<=1:fatal"])
def test_parse_slo_refusals(bad):
    with pytest.raises(ValueError):
        parse_slo(bad)
    with pytest.raises(ValueError):
        j_parse_slo(bad)


def test_slo_monitor_matches_reference():
    def run(monitor_cls, rule_cls, log_cls):
        log = log_cls()
        mon = monitor_cls(["tick_us<=5:critical", "sessions_per_s>=1",
                           rule_cls("absent_metric", "<=", 0.0)], spans=log)
        hits = [mon.check({"tick_us": 3.0, "sessions_per_s": 2.0}, 0),
                mon.check({"tick_us": 9.0, "sessions_per_s": 0.25}, 1),
                mon.check({"tick_us": 7.0}, 2)]
        return (hits, mon.verdict(), mon.verdict(dropped=1),
                mon.verdict(span_errors=["x"]),
                [(e.kind, e.round, e.args) for e in log.events])
    assert run(SloMonitor, SloRule, SpanLog) == \
        run(JSloMonitor, JSloRule, JSpanLog)
    assert [r.name for r in default_fleet_slos()] == \
        [r.name for r in j_default_fleet_slos()]
    assert SloMonitor(default_fleet_slos()).verdict() == \
        JSloMonitor(j_default_fleet_slos()).verdict()


# ------------------------------------------------- fleet serves, observed

def _sessions(sc, seeds_totals):
    return [Session(sid=i, stream=sc.stream(seed), total_ticks=t)
            for i, (seed, t) in enumerate(seeds_totals)]


@pytest.fixture(scope="module")
def observed_serve(sc):
    """One instrumented serve with narrowing (preempt and resume spans),
    every tick's metric records kept on the side."""
    eng = FleetEngine(sc, round_ticks=TC, device="cpu", obs=True,
                      dvfs=QueueDVFS(thresholds=(3,), batch_levels=(1, 4)))
    kept, step = [], eng._step
    keys = {s.key for s in eng._dev_specs}

    def recording(state, t):
        state, rec = step(state, t)
        kept.append({k: rec[k].clone() for k in keys})
        return state, rec
    eng._step = recording
    out = eng.serve(None, sessions=_sessions(
        sc, [(40, 2 * TC), (41, 5 * TC), (42, 5 * TC)]))
    return eng, out, kept


def test_observed_serve_health_and_chains(observed_serve):
    eng, out, _ = observed_serve
    assert out["stats"]["completed"] == 3
    obs = out["obs"]
    assert obs["health"]["status"] in ("ok", "warn")
    assert obs["health"]["dropped_sessions"] == 0
    assert obs["health"]["span_errors"] == []
    assert validate_spans(obs["spans"].events, require_complete=True) == []
    assert j_validate_spans(obs["spans"].payload()["events"],
                            require_complete=True) == []
    assert sorted(obs["spans"].sids) == [0, 1, 2]
    assert obs["spans"].meta == {"scenario": "adaptive1ch",
                                 "round_ticks": TC, "levels": [1, 4]}


def test_observed_serve_records_preemption_spans(observed_serve):
    eng, out, _ = observed_serve
    assert out["stats"]["preemptions"] >= 1
    kinds = [e.kind for e in out["obs"]["spans"].events]
    assert kinds.count("preempt") == out["stats"]["preemptions"]
    assert kinds.count("resume") >= 1 and kinds.count("complete") == 3
    pre = next(e for e in out["obs"]["spans"].events
               if e.kind == "preempt")
    assert {"slot", "target", "ticks_done", "ckpt"} <= set(pre.args)


def test_observed_serve_metrics_and_counters(observed_serve):
    eng, out, kept = observed_serve
    snap = out["obs"]["metrics"]
    st = out["stats"]
    assert snap["ticks_run"] == st["ticks_run"]
    assert snap["admitted"] == 3
    assert snap["resumed"] == snap["preempted"] == st["preemptions"]
    assert snap["energy_j"] == pytest.approx(
        sum(s.energy_j for s in out["sessions"]), rel=1e-6)
    counters = out["obs"]["spans"].counters
    rounds = [c["round"] for c in counters]
    assert rounds == list(range(len(rounds))) and rounds
    assert snap["rounds"] == snap["tick_us_count"] == len(rounds)
    assert snap["rounds"] <= st["rounds"]
    assert all({"width", "queue_depth", "tick_us", "energy_j"} <= set(c)
               for c in counters)
    # the device counters: the host sums of the same serve's records over
    # each round's active slots
    assert len(kept) == len(counters) * TC
    for s in eng._dev_specs:
        vals = [np.stack([k[s.key].numpy() for k in
                          kept[r * TC:(r + 1) * TC]])[:, :c["n_active"]]
                for r, c in enumerate(counters)]
        if s.op == "sum":
            want = sum(float(v.astype(np.float64).sum()) for v in vals)
            assert snap[f"dev/{s.name}"] == want, s.name
        else:
            assert snap[f"dev/{s.name}_peak"] == max(float(v.max())
                                                     for v in vals)
    assert snap["dev/spikes"] > 0 and snap["dev/pl_peak"] >= 1


def test_obs_off_is_bitwise_free(sc):
    def run(obs):
        eng = FleetEngine(sc, round_ticks=TC, device="cpu", obs=obs,
                          dvfs=QueueDVFS(thresholds=(3,),
                                         batch_levels=(1, 4)))
        return eng.serve(None, sessions=_sessions(
            sc, [(60, 2 * TC), (61, 4 * TC), (62, 4 * TC)]))

    plain, instrumented = run(None), run(True)
    assert "obs" not in plain and "health" not in plain["stats"]
    assert instrumented["obs"]["health"]["span_errors"] == []
    for a, b in zip(plain["sessions"], instrumented["sessions"]):
        assert a.energy_j == b.energy_j
        for k in sc.output_keys:
            np.testing.assert_array_equal(a.outputs[k], b.outputs[k])


def test_span_chain_across_suspend_restore(sc, tmp_path):
    kw = dict(round_ticks=TC, capacity=1, ckpt_dir=tmp_path, device="cpu",
              dvfs=QueueDVFS(thresholds=(2,), batch_levels=(1, 1)))
    T, seed = 4 * TC, 17
    eng1 = FleetEngine(sc, max_rounds=2, obs=True, **kw)
    s1 = Session(sid=9, stream=sc.stream(seed), total_ticks=T)
    eng1.serve(None, sessions=[s1])
    eng1.suspend()
    log1 = eng1.obs.spans.events
    assert "suspend" in [e.kind for e in log1]
    assert validate_spans(log1) == []
    assert validate_spans(log1, require_complete=True) != []

    eng2 = FleetEngine(sc, obs=True, **kw)
    s2 = eng2.restore_session(9, stream=sc.stream(seed), total_ticks=T)
    out2 = eng2.serve(None, sessions=[s2])
    assert out2["sessions"][0].done
    log2 = eng2.obs.spans.events
    assert validate_spans(log2, require_complete=True) == []
    sid9 = [e for e in log2 if e.sid == 9]
    assert sid9[0].kind == "enqueue" and sid9[0].args["ticks_done"] == 2 * TC
    assert "resume" in [e.kind for e in sid9]
    assert validate_spans(list(log1) + list(log2),
                          require_complete=True) == []
    assert out2["obs"]["health"]["status"] in ("ok", "warn")


def test_custom_slos_gate_the_serve(sc):
    obs = FleetObs(slos=(SloRule("sessions_per_s", ">=", 1e9),))
    eng = FleetEngine(sc, round_ticks=TC, capacity=1, obs=obs,
                      device="cpu", dvfs=QueueDVFS(thresholds=(2,),
                                                   batch_levels=(1, 1)))
    out = eng.serve(None, sessions=[Session(sid=0, stream=sc.stream(1),
                                            total_ticks=TC)])
    assert out["obs"]["health"]["status"] == "warn"
    assert any(e.kind == "slo" for e in obs.spans.events)

    eng2 = FleetEngine(sc, round_ticks=TC, max_rounds=1, capacity=1,
                       obs=FleetObs(), device="cpu",
                       dvfs=QueueDVFS(thresholds=(2,), batch_levels=(1, 1)))
    out2 = eng2.serve(None, sessions=_sessions(sc, [(0, 2 * TC),
                                                    (1, 2 * TC)]))
    assert out2["stats"]["completed"] < 2
    assert out2["obs"]["health"]["status"] == "critical"
    assert out2["obs"]["health"]["dropped_sessions"] >= 1


# ----------------------------------------------------------- trace export

def test_fleet_trace_matches_reference(observed_serve):
    """The port's fleet trace of a served span log equals the
    reference's for the same payload, event for event."""
    _, out, _ = observed_serve
    payload = out["obs"]["spans"].payload()
    got = fleet_trace_events(payload)
    assert got == j_fleet_trace_events(json.loads(json.dumps(payload)))
    ev = got["traceEvents"]
    assert {"M", "C", "X", "i"} <= {e["ph"] for e in ev}
    counters = {e["name"].split(" [")[0] for e in ev if e["ph"] == "C"}
    assert {"queue_depth", "width", "tick_us", "energy_j"} <= counters
    assert len([e for e in ev if e["ph"] == "i"
                and e["name"] == "complete"]) == 3
    assert got["otherData"]["n_requests"] == 3


def test_fleet_trace_cli(observed_serve, tmp_path):
    _, out, _ = observed_serve
    spans = out["obs"]["spans"]
    slog = spans.write(tmp_path / "spans.json.gz")
    out_path = tmp_path / "fleet.perfetto-trace.json"
    assert trace_main(["--fleet", str(slog), "--gzip",
                       "--out", str(out_path)]) == 0
    gz = out_path.with_suffix(".json.gz")
    loaded = json.loads(gzip.decompress(gz.read_bytes()))
    assert loaded == json.loads(json.dumps(fleet_trace_events(
        load_spans(slog))))
