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
"""
from repro_torch.obs.health import (SloMonitor, SloRule,
                                    default_fleet_slos, parse_slo)
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
           "MetricsRegistry", "PROBE_OPS", "PROBE_REGISTRY", "ProbeSpec",
           "SloMonitor", "SloRule", "SpanEvent", "SpanLog",
           "default_fleet_slos", "default_probes", "device_metrics_for",
           "link_profile", "link_profile_probes", "load_spans",
           "make_batched_probe_step", "make_device_metrics",
           "make_probe_step", "n_probe_samples", "parse_slo",
           "record_link_profile", "resolve_probes", "validate_spans",
           *_TRACE]


def __getattr__(name):
    # trace is also a ``python -m`` entry point; importing it eagerly here
    # would trip runpy's double-import warning, so its names resolve on
    # first use
    if name in _TRACE:
        from repro_torch.obs import trace
        return getattr(trace, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
