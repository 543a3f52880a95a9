"""Telemetry over the engine's records: probes and Perfetto traces.

* ``probes``: declarative ``ProbeSpec``s folded over each tick's records
  on the device (sampling strides, windowed peak / mean / sum / EMA /
  last), so board-scale runs record without per-tick host round trips
  or (T, ...) memory.  A run without probes is exactly the bare run.
* ``trace``: export of recorded timelines as Chrome/Perfetto trace-event
  JSON (per-PE compute and DVFS tracks, per-tier NoC flit counters,
  learn updates; a served fleet's request lifecycles), and its
  ``python -m repro_torch.obs.trace`` entry.
* ``spans``, ``metrics``, ``health``: the serving tier's request
  lifecycles, counters and device-side accumulators, and SLO verdict.
* ``manifest``: a provenance manifest (git sha, config hash, seed, torch
  and CUDA versions, device name and power limit, host) and host-side
  phase timers attached to every BENCH json artifact.
* ``report``: ``python -m repro_torch.obs.report A.json B.json`` diffs
  two BENCH artifacts (the port's or the reference's) and exits nonzero
  past a regression threshold.
"""
from repro_torch.obs.health import (SloMonitor, SloRule,
                                    default_fleet_slos, parse_slo)
from repro_torch.obs.manifest import (PhaseTimers, bench_payload,
                                      config_hash, device_info,
                                      run_manifest, write_bench_json)
from repro_torch.obs.metrics import (Counter, DeviceMetricSpec, Gauge,
                                     Histogram, MetricsRegistry,
                                     device_metrics_for,
                                     make_device_metrics)
from repro_torch.obs.probes import (PROBE_OPS, PROBE_REGISTRY, ProbeSpec,
                                    default_probes, link_profile,
                                    link_profile_probes,
                                    make_batched_probe_step,
                                    make_probe_step, n_probe_samples,
                                    record_link_profile, resolve_probes)
from repro_torch.obs.spans import (SpanEvent, SpanLog, load_spans,
                                   validate_spans)

_TRACE = ("fleet_trace_events", "trace_events", "write_fleet_trace",
          "write_trace")

__all__ = ["Counter", "DeviceMetricSpec", "Gauge", "Histogram",
           "MetricsRegistry", "PROBE_OPS", "PROBE_REGISTRY", "PhaseTimers",
           "ProbeSpec", "SloMonitor", "SloRule", "SpanEvent", "SpanLog",
           "bench_payload", "config_hash", "default_fleet_slos",
           "default_probes", "device_info", "device_metrics_for",
           "diff_benches", "link_profile", "link_profile_probes",
           "load_spans", "make_batched_probe_step", "make_device_metrics",
           "make_probe_step", "n_probe_samples", "parse_slo",
           "record_link_profile", "resolve_probes", "run_manifest",
           "validate_spans", "write_bench_json", *_TRACE]


def __getattr__(name):
    # trace and report are also ``python -m`` entry points; importing them
    # eagerly here would trip runpy's double-import warning, so their
    # names resolve on first use
    if name in _TRACE:
        from repro_torch.obs import trace
        return getattr(trace, name)
    if name == "diff_benches":
        from repro_torch.obs.report import diff_benches
        return diff_benches
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
