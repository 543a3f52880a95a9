"""Profile-guided routing & placement: a closed-loop congestion
optimizer over the board compiler's free routing parameters.

The compiler's default routes are legal but blind: every multicast tree
is X-then-Y and every chip-to-chip hop crosses the one mid-edge border
port, so hot sources pile onto the same SerDes links — BENCH_pr4 showed
the chip-to-chip tier carrying 42.9% of flits but 90.4% of NoC energy.
This package closes the loop the telemetry PRs opened:

    simulate -> probe -> re-route / re-place -> re-compile -> re-simulate

``measure_profile`` turns one probed run into a ``TrafficProfile``
(per-link peak/mean flits split at the tier boundary, per-source packet
rates, per-tier touched-link counts — all in-scan ``ProbeSpec``
reductions, O(n_links) memory).  ``optimize_routes`` then iterates:
re-partition with measured rates, pick each population's tree
orientations (X/Y vs Y/X, on-chip and at chip granularity) and spread
its chip-to-chip exits across multiple border ports against the
predicted residual load, re-compile, re-measure, and stop when the
measured peak stops improving (or the iteration / wall-clock budget
runs out).

Routing never changes neuron dynamics: packets ride the routing-table
masks, incidence only prices links — so every candidate is bitwise
neuron-identical by construction (``invariants.check_delivery`` proves
the flit-conservation half; the test suite asserts the record half).

The search is host numpy; each measurement is one probed ``ChipSim.run``
on the device, its probe folds read back once at the run's end.
"""
# Lazy re-exports (PEP 562): ``repro_torch.board.route`` imports
# ``repro_torch.routeopt.config`` while ``repro_torch.routeopt.optimize``
# imports ``repro_torch.board.route`` back — resolving attributes on first touch
# keeps the package importable from either side of that edge.
_EXPORTS = {
    "RouteConfig": "repro_torch.routeopt.config",
    "TrafficProfile": "repro_torch.routeopt.profile",
    "measure_profile": "repro_torch.routeopt.profile",
    "RouteOptResult": "repro_torch.routeopt.optimize",
    "optimize_routes": "repro_torch.routeopt.optimize",
    "check_delivery": "repro_torch.routeopt.invariants",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
