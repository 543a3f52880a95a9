"""BENCH regression gate: diff two benchmark JSON artifacts.

    python -m repro_torch.obs.report BASELINE.json FRESH.json \
        [--threshold 0.2] [--metric NAME[:direction[:threshold]]]... \
        [--warn-only]

Rows are matched by name; for each shared row the chosen metric is
compared as a ratio fresh/baseline, and any ratio above
``1 + threshold`` is a regression.  Exit status: 0 clean, 1 regressions
found (suppressed by ``--warn-only``), 2 malformed input / no
comparable rows — so CI can gate on it directly.

``--metric`` repeats: each occurrence gates one metric, optionally with
an inline direction and threshold overriding the global flags —

    --metric us_per_call --metric sessions_per_s:higher \
        --metric compile_s:lower:0.5

gates wall time (lower is good, global threshold), throughput (higher
is good), and compile time (lower, ±50%) in ONE invocation; the exit
code is the worst across all of them (2 only if *no* metric found
comparable rows).  The metric defaults to ``us_per_call`` (the per-row
wall time every ``benchmarks.common.emit`` records — tick_us for the
scale sweeps); any numeric key of a row's parsed ``values`` dict
(``compile_s``, ``partition_s``, ...) works too.  Both files'
provenance manifests are echoed so the report says what was actually
compared.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional


def _metric(row: dict, metric: str) -> Optional[float]:
    v = row.get(metric, row.get("values", {}).get(metric))
    return float(v) if isinstance(v, (int, float)) else None


def diff_benches(base: dict, new: dict, metric: str = "us_per_call",
                 threshold: float = 0.2, direction: str = "lower") -> dict:
    """Compare two ``bench_payload`` dicts row by row.

    ``direction`` says which way the metric is good: "lower" (wall
    times, ``peak_xlink_flits`` — a regression is ratio > 1 +
    threshold, the historical behavior) or "higher" (throughput,
    ``improvement`` — a regression is ratio < 1 / (1 + threshold)).

    Returns {"rows": [...], "regressions": [...], "missing": [...]} where
    each row entry is (name, base_value, new_value, ratio) and
    regressions are the subset past the threshold in the bad direction.
    """
    if direction not in ("lower", "higher"):
        raise ValueError(f"direction must be 'lower' or 'higher', "
                         f"got {direction!r}")
    base_rows = {r["name"]: r for r in base.get("rows", [])}
    new_rows = {r["name"]: r for r in new.get("rows", [])}
    rows, regressions = [], []
    for name in base_rows:
        if name not in new_rows:
            continue
        b = _metric(base_rows[name], metric)
        n = _metric(new_rows[name], metric)
        if b is None or n is None or b <= 0:
            continue
        ratio = n / b
        entry = {"name": name, "base": b, "new": n, "ratio": ratio}
        rows.append(entry)
        bad = (ratio > 1.0 + threshold if direction == "lower"
               else ratio < 1.0 / (1.0 + threshold))
        if bad:
            regressions.append(entry)
    missing = sorted(set(base_rows) - set(new_rows))
    return {"rows": rows, "regressions": regressions, "missing": missing}


def _describe(label: str, path: Path, payload: dict) -> None:
    man = payload.get("manifest", {})
    sha = (man.get("git_sha") or "?")[:12]
    when = man.get("timestamp_utc", "?")
    host = man.get("host", "?")
    # the port's manifests name torch and the device, the reference's jax
    if "torch_version" in man:
        stack = f"torch={man['torch_version']}  device={man.get('device')}"
    else:
        jaxv = man.get("jax_version", payload.get("jax_version", "?"))
        stack = f"jax={jaxv}"
    print(f"# {label}: {path}  sha={sha}  {stack}  host={host}  {when}")


def parse_metric_spec(spec: str, direction: str = "lower",
                      threshold: float = 0.2) -> tuple:
    """``"NAME[:direction[:threshold]]"`` -> (name, direction,
    threshold), inheriting the global flags for omitted parts."""
    parts = spec.split(":")
    if len(parts) > 3 or not parts[0]:
        raise ValueError(f"bad metric spec {spec!r}; expected "
                         f"NAME[:direction[:threshold]]")
    name = parts[0]
    if len(parts) >= 2:
        if parts[1] not in ("lower", "higher"):
            raise ValueError(f"bad direction in metric spec {spec!r}; "
                             f"expected 'lower' or 'higher'")
        direction = parts[1]
    if len(parts) == 3:
        threshold = float(parts[2])
    return name, direction, threshold


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("baseline", type=Path)
    ap.add_argument("fresh", type=Path)
    ap.add_argument("--metric", action="append", default=None,
                    metavar="NAME[:direction[:threshold]]",
                    help="metric to gate; repeatable — each occurrence "
                         "may carry its own direction/threshold "
                         "(default: us_per_call with the global flags)")
    ap.add_argument("--threshold", type=float, default=0.2,
                    help="relative regression threshold (0.2 = +20%%)")
    ap.add_argument("--direction", choices=("lower", "higher"),
                    default="lower",
                    help="which way the metric is good: 'lower' (times, "
                         "peak_xlink_flits) or 'higher' (throughput)")
    ap.add_argument("--warn-only", action="store_true",
                    help="report regressions but exit 0 (CI advisory mode)")
    args = ap.parse_args(argv)

    try:
        specs = [parse_metric_spec(s, args.direction, args.threshold)
                 for s in (args.metric or ["us_per_call"])]
    except ValueError as e:
        print(f"# {e}", file=sys.stderr)
        return 2

    payloads = []
    for path in (args.baseline, args.fresh):
        try:
            payloads.append(json.loads(path.read_text()))
        except (OSError, json.JSONDecodeError) as e:
            print(f"# cannot read {path}: {e}", file=sys.stderr)
            return 2
    base, new = payloads
    _describe("baseline", args.baseline, base)
    _describe("fresh   ", args.fresh, new)

    compared = regressed = 0
    for metric, direction, threshold in specs:
        d = diff_benches(base, new, metric=metric,
                         threshold=threshold, direction=direction)
        if not d["rows"]:
            print(f"# no comparable rows for metric {metric!r}",
                  file=sys.stderr)
            continue
        compared += len(d["rows"])

        print(f"name,{metric}_base,{metric}_new,ratio  [{direction} "
              f"is good, +/-{threshold * 100:.0f}%]")
        for r in sorted(d["rows"], key=lambda r: -r["ratio"]):
            flag = "  <-- REGRESSION" if r in d["regressions"] else ""
            print(f"{r['name']},{r['base']:.3f},{r['new']:.3f},"
                  f"{r['ratio']:.3f}{flag}")
        if d["missing"]:
            print(f"# rows only in baseline (not compared): {d['missing']}")

        if d["regressions"]:
            regressed += len(d["regressions"])
            worst = max(r["ratio"] for r in d["regressions"])
            print(f"# {metric}: {len(d['regressions'])}/{len(d['rows'])} "
                  f"rows regressed past {threshold * 100:.0f}% "
                  f"(worst {worst:.2f}x)")
        else:
            print(f"# {metric}: all {len(d['rows'])} rows within "
                  f"{threshold * 100:.0f}%")

    if compared == 0:
        print("# no metric had comparable rows", file=sys.stderr)
        return 2
    if regressed:
        print(f"# TOTAL: {regressed} regression(s) across "
              f"{len(specs)} gated metric(s)")
        return 0 if args.warn_only else 1
    print(f"# TOTAL: {len(specs)} metric(s) gated, no regressions")
    return 0


if __name__ == "__main__":                                # pragma: no cover
    raise SystemExit(main())
