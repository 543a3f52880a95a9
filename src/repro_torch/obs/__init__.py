"""Telemetry over the engine's records: probes and Perfetto traces.

* ``probes``: declarative ``ProbeSpec``s folded over each tick's records
  on the device (sampling strides, windowed peak / mean / sum / EMA /
  last), so board-scale runs record without per-tick host round trips
  or (T, ...) memory.  A run without probes is exactly the bare run.
* ``trace``: export of recorded timelines as Chrome/Perfetto trace-event
  JSON (per-PE compute and DVFS tracks, per-tier NoC flit counters,
  learn updates), and its ``python -m repro_torch.obs.trace`` entry.
"""
from repro_torch.obs.probes import (PROBE_OPS, PROBE_REGISTRY, ProbeSpec,
                                    default_probes, link_profile,
                                    link_profile_probes, make_probe_step,
                                    n_probe_samples, record_link_profile,
                                    resolve_probes)

__all__ = ["PROBE_OPS", "PROBE_REGISTRY", "ProbeSpec", "default_probes",
           "link_profile", "link_profile_probes", "make_probe_step",
           "n_probe_samples", "record_link_profile", "resolve_probes",
           "trace_events", "write_trace"]


def __getattr__(name):
    # trace is also a ``python -m`` entry point; importing it eagerly here
    # would trip runpy's double-import warning, so its names resolve on
    # first use
    if name in ("trace_events", "write_trace"):
        from repro_torch.obs import trace
        return getattr(trace, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
