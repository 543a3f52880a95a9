"""SLO health gate for the serving tier.

Declarative rules over the metrics snapshot — the SpiNNaker 2 system
papers treat live load/latency/energy monitoring as first-class at
machine scale; this is the serving tier's version of that loop:

    rules = (SloRule("req_latency_s_p99", "<=", 2.5, "critical"),
             SloRule("sessions_per_s", ">=", 5.0),
             SloRule("mj_per_request", "<=", 50.0))
    mon = SloMonitor(rules, spans=span_log)
    mon.check(metrics.snapshot(), round_i=r)     # every scheduling round
    mon.verdict(dropped=0, span_errors=[])       # final health verdict

``check`` evaluates every rule whose metric is present in the snapshot,
emits one structured ``slo`` event into the span log per violation
(level ``warn`` or ``critical``), and remembers the worst value seen
per rule.  ``verdict`` folds the rule history with two hard serving
invariants — no dropped sessions, no broken span chains — into the
final status: ``ok`` / ``warn`` / ``critical``.  A critical verdict is
CI-fatal in the serving smoke; warn is advisory.

Rules parse from compact specs (``"metric<=3.5"``,
``"metric>=10:critical"``) so benchmarks and CI can pass them as flags.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

SLO_LEVELS = ("warn", "critical")
_SPEC_RE = re.compile(r"^\s*([\w./]+)\s*(<=|>=)\s*([-+0-9.eE]+)"
                      r"\s*(?::(\w+))?\s*$")

_RANK = {"ok": 0, "warn": 1, "critical": 2}


@dataclass(frozen=True)
class SloRule:
    """``metric op threshold`` at a severity ``level``: the metric (a
    key of the registry snapshot) must stay ``<=`` or ``>=`` the
    threshold; a violation emits a span event at ``level``."""
    metric: str
    op: str                    # "<=" | ">="
    threshold: float
    level: str = "warn"

    def __post_init__(self):
        if self.op not in ("<=", ">="):
            raise ValueError(f"SLO rule {self.metric!r}: op must be '<=' "
                             f"or '>=', got {self.op!r}")
        if self.level not in SLO_LEVELS:
            raise ValueError(f"SLO rule {self.metric!r}: level must be "
                             f"one of {SLO_LEVELS}, got {self.level!r}")

    def ok(self, value: float) -> bool:
        return (value <= self.threshold if self.op == "<="
                else value >= self.threshold)

    @property
    def name(self) -> str:
        return f"{self.metric}{self.op}{self.threshold:g}"


def parse_slo(spec: str) -> SloRule:
    """``"metric<=3.5"`` / ``"metric>=10:critical"`` -> ``SloRule``."""
    m = _SPEC_RE.match(spec)
    if not m:
        raise ValueError(f"cannot parse SLO spec {spec!r}; expected "
                         f"METRIC<=X[:LEVEL] or METRIC>=X[:LEVEL]")
    metric, op, thr, level = m.groups()
    return SloRule(metric, op, float(thr), level or "warn")


def default_fleet_slos(max_req_p99_s: float = 60.0,
                       min_sessions_per_s: float = 0.0,
                       max_preempt_rate: float = 2.0,
                       max_mj_per_request: float = 1000.0) -> tuple:
    """The standard fleet rule set (latency / throughput / preemption /
    energy), with deliberately loose defaults — tighten per deployment;
    the defaults exist so every serve carries the full rule *shape*."""
    return (SloRule("req_latency_s_p99", "<=", max_req_p99_s, "warn"),
            SloRule("sessions_per_s", ">=", min_sessions_per_s, "warn"),
            SloRule("preempt_rate", "<=", max_preempt_rate, "warn"),
            SloRule("mj_per_request", "<=", max_mj_per_request, "warn"))


class SloMonitor:
    """Evaluate a rule set against metric snapshots, round by round."""

    def __init__(self, rules=(), spans=None):
        self.rules = tuple(parse_slo(r) if isinstance(r, str) else r
                           for r in rules)
        self.spans = spans
        self.violations: list = []
        self._per_rule: dict = {r.name: {"rule": r, "violations": 0,
                                         "worst": None}
                                for r in self.rules}

    def check(self, snapshot: dict, round_i: int = -1) -> list:
        """Evaluate every rule whose metric the snapshot carries;
        returns (and records) this round's violations."""
        hits = []
        for r in self.rules:
            v = snapshot.get(r.metric)
            if v is None or r.ok(float(v)):
                continue
            hit = {"rule": r.name, "metric": r.metric, "value": float(v),
                   "threshold": r.threshold, "level": r.level,
                   "round": int(round_i)}
            hits.append(hit)
            self.violations.append(hit)
            pr = self._per_rule[r.name]
            pr["violations"] += 1
            worse = (max if r.op == "<=" else min)
            pr["worst"] = (float(v) if pr["worst"] is None
                           else worse(pr["worst"], float(v)))
            if self.spans is not None:
                self.spans.emit("slo", round_i=round_i, **hit)
        return hits

    def verdict(self, dropped: int = 0, span_errors=()) -> dict:
        """The final health verdict: the worst rule level violated,
        escalated to ``critical`` by either hard invariant (dropped
        sessions, broken span chains)."""
        status = "ok"
        for hit in self.violations:
            status = max(status, hit["level"], key=_RANK.get)
        span_errors = list(span_errors)
        if dropped > 0 or span_errors:
            status = "critical"
        return {
            "status": status,
            "violations": len(self.violations),
            "dropped_sessions": int(dropped),
            "span_errors": span_errors,
            "rules": [{"rule": name, "level": pr["rule"].level,
                       "violations": pr["violations"],
                       "worst": pr["worst"]}
                      for name, pr in self._per_rule.items()],
        }
