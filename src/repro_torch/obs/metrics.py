"""Serving-tier metrics: counters, gauges, log2 histograms and
device-side accumulators.

Two tiers, matching where the numbers are born:

* **host-side**: scheduler and queue events (admissions, preemptions,
  widths, wall-clock latencies) land in a small ``MetricsRegistry`` of
  ``Counter`` / ``Gauge`` / fixed-bucket log2 ``Histogram`` objects; no
  allocation per observation, so the registry can be sampled every
  scheduling round;
* **device-side**: per-tick record signals (spikes, packets, synaptic
  events, PLs) accumulate on the device inside the fleet's round
  (``make_device_metrics``, the batched analogue of the probes with a
  reduction per instance): one (width,) float32 tensor a metric, folded
  every tick, read back once a scheduling round, with no host round
  trip a tick.

``MetricsRegistry.snapshot()`` flattens everything to one
``{name: float}`` dict: the numbers the SLO monitor evaluates.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


class Counter:
    """Monotonic accumulator (events, joules, ticks)."""

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += float(n)


class Gauge:
    """Last-value metric that also remembers its peak (queue depth,
    fleet width, sessions/s)."""

    def __init__(self):
        self.value = 0.0
        self.peak = 0.0
        self._seen = False

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        self.peak = v if not self._seen else max(self.peak, v)
        self._seen = True


class Histogram:
    """Fixed-bucket log2 histogram (a static bucket count, O(1) observe)
    for long-tailed serving quantities.

    Bucket i counts observations in ``[scale * 2**i, scale * 2**(i+1))``;
    values below ``scale`` land in bucket 0, values off the top in the
    last bucket.  Percentiles are upper-bound estimates off the bucket
    edges (exact total/sum/max are tracked alongside), so a p99 is never
    under-reported — the right bias for latency SLOs.
    """

    def __init__(self, scale: float = 1e-6, n_buckets: int = 40):
        if scale <= 0 or n_buckets < 1:
            raise ValueError(f"need scale > 0 and n_buckets >= 1, got "
                             f"scale={scale} n_buckets={n_buckets}")
        self.scale = float(scale)
        self.counts = np.zeros(n_buckets, np.int64)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def bucket_of(self, v: float) -> int:
        if v < self.scale:
            return 0
        return min(int(math.floor(math.log2(v / self.scale))),
                   len(self.counts) - 1)

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[self.bucket_of(v)] += 1
        self.count += 1
        self.sum += v
        self.max = max(self.max, v)

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-th percentile (0.0
        when empty); the exact ``max`` caps the top bucket."""
        if self.count == 0:
            return 0.0
        target = math.ceil(self.count * p / 100.0)
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target))
        return min(self.scale * 2.0 ** (i + 1), self.max)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Get-or-create registry of named metrics with one flat snapshot."""

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, name: str, cls, *args, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(*args, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, scale: float = 1e-6,
                  n_buckets: int = 40) -> Histogram:
        return self._get(name, Histogram, scale, n_buckets)

    def names(self) -> list:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Flatten to ``{name: float}``: counters/gauges by name (gauges
        add ``_peak``), histograms as ``_p50`` / ``_p99`` / ``_mean`` /
        ``_max`` / ``_count``: the dict the SLO monitor consumes."""
        out: dict = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Gauge):
                out[name] = m.value
                out[f"{name}_peak"] = m.peak
            else:
                out[f"{name}_p50"] = m.percentile(50)
                out[f"{name}_p99"] = m.percentile(99)
                out[f"{name}_mean"] = m.mean
                out[f"{name}_max"] = m.max
                out[f"{name}_count"] = float(m.count)
        return out


# ---------------------------------------------------------------------------
# Device-side accumulators (ride the fleet's round)
# ---------------------------------------------------------------------------

DEVICE_METRIC_OPS = ("sum", "peak")


@dataclass(frozen=True)
class DeviceMetricSpec:
    """One per-instance reduction of a per-tick record signal,
    accumulated on the device over a scheduling round: ``sum`` (event
    totals, energy) or ``peak`` (high-water marks)."""
    name: str
    key: str
    op: str = "sum"

    def __post_init__(self):
        if self.op not in DEVICE_METRIC_OPS:
            raise ValueError(f"device metric {self.name!r}: unknown op "
                             f"{self.op!r}; expected {DEVICE_METRIC_OPS}")


# the standard fleet set, filtered against the program's record keys
FLEET_DEVICE_METRICS = (
    DeviceMetricSpec("spikes", "n_spk", "sum"),
    DeviceMetricSpec("packets", "packets", "sum"),
    DeviceMetricSpec("syn_events", "syn_events", "sum"),
    DeviceMetricSpec("pl", "pl", "peak"),
)


def device_metrics_for(rec_keys, specs=FLEET_DEVICE_METRICS) -> tuple:
    """The subset of ``specs`` whose record key this program reports
    (``rec_keys``: any container of the tick's record keys)."""
    return tuple(s for s in specs if s.key in rec_keys)


def make_device_metrics(specs: tuple, width: int, device=None):
    """Compile ``specs`` into a batched fold over a fleet's ticks.

    Returns ``(init, step)``: ``init`` is ``{name: (width,) float32
    zeros}`` on ``device`` (the CUDA device unless the caller asks for the
    CPU); ``step(acc, rec)`` folds one batched tick's records (each
    ``(width, ...)``; the other axes reduce per instance) and returns the
    new accumulators.  Slot i is instance i's total, so padded slots are
    separable from real sessions.
    """
    from repro_torch import resolve_device
    device = resolve_device(device)
    init = {s.name: torch.zeros((width,), dtype=torch.float32,
                                device=device) for s in specs}

    def step(acc, rec):
        out = dict(acc)
        for s in specs:
            v = rec[s.key].to(torch.float32).reshape(width, -1)
            if s.op == "sum":
                out[s.name] = acc[s.name] + v.sum(1)
            else:
                out[s.name] = torch.maximum(acc[s.name], v.amax(1))
        return out

    return init, step
