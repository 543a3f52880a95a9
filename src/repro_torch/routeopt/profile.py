"""One probed simulation -> one ``TrafficProfile``.

The optimizer steers by measurement, and ALL of it rides the probe API
(``repro_torch.obs``, folded on the device after each tick): per-link
peak/mean flit loads (``link_flits`` probes, O(n_links) memory however
long the run), per-source packet rates (``packets`` probes — the
partition re-weights and the load predictor both consume these), and
per-tier touched-link counts (the ``activity`` signals).
``keep_records=False`` throughout: no (T, n_links) timeline ever
materializes.

The load-bearing physics: packet emission depends only on neuron
dynamics, which routing cannot touch (packets ride the routing-table
masks; incidence only prices links) — so measured source rates are
ROUTING-INVARIANT, and mean link loads are exactly linear in them:

    mean_flits[link] = sum over sources whose tree crosses the link of
                       mean_packets[source] * flits_per_packet[source]

That identity is what lets ``optimize.predicted_loads`` score a
candidate routing exactly (for the mean profile) without simulating it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.obs.probes import ProbeSpec, link_profile_probes


@dataclass
class TrafficProfile:
    """Measured per-link and per-source traffic of one run."""
    peak: np.ndarray          # (n_links,) peak flits in any tick
    mean: np.ndarray          # (n_links,) mean flits per tick
    src_mean: np.ndarray      # (P,) mean packets/tick per source PE
    src_peak: np.ndarray      # (P,) peak packets in any tick
    touched: dict             # tier -> mean touched links per tick
    n_onchip_links: int       # tier boundary in the link-id space
    n_ticks: int

    @property
    def n_xchip_links(self) -> int:
        return len(self.peak) - self.n_onchip_links

    @property
    def peak_xlink(self) -> float:
        """Peak flits on any chip-to-chip link — THE congestion gate."""
        return float(self.peak[self.n_onchip_links:].max(initial=0.0))

    @property
    def mean_xlink(self) -> float:
        x = self.mean[self.n_onchip_links:]
        return float(x.mean()) if x.size else 0.0

    @property
    def peak_onchip(self) -> float:
        return float(self.peak[:self.n_onchip_links].max(initial=0.0))

    @property
    def peak_overall(self) -> float:
        return float(self.peak.max(initial=0.0))

    def objective(self) -> float:
        """What the optimizer minimizes: the chip-to-chip peak when the
        board has that tier, the overall peak otherwise (1x1 boards)."""
        return self.peak_xlink if self.n_xchip_links else self.peak_overall

    def pop_rates(self, pe_slices: dict) -> dict:
        """Population -> measured packets/tick summed over its tiles —
        the drop-in replacement for the partitioner's static
        every-tile-fires estimate.  ``pe_slices`` ordering is partition-
        independent (graph order), so rates measured under one placement
        re-weight any other."""
        return {name: float(self.src_mean[sl].sum())
                for name, sl in pe_slices.items()}

    def summary(self) -> dict:
        """The trajectory row committed per iteration in BENCH_pr9."""
        out = {"peak_xlink_flits": round(self.peak_xlink, 2),
               "mean_xlink_flits": round(self.mean_xlink, 4),
               "peak_onchip_flits": round(self.peak_onchip, 2),
               "peak_flits": round(self.peak_overall, 2)}
        for tier, v in self.touched.items():
            out[f"touched_links_{tier}"] = round(v, 2)
        return out


def profile_probes(program) -> tuple:
    """The full measurement set: link peak/mean + per-source packet
    rates + per-tier touched-link counts (empty tiers emit none, same
    rule as the ``activity`` registry set)."""
    specs = list(link_profile_probes())
    specs += [ProbeSpec("src_packets_mean", "packets", "mean"),
              ProbeSpec("src_packets_peak", "packets", "peak")]
    for tier, m in program.noc.tier_masks().items():
        if np.asarray(m).any():
            specs.append(ProbeSpec(f"touched_{tier}",
                                   f"touched_links_{tier}", "mean"))
    return tuple(specs)


def measure_profile(sim, n_ticks: int, **run_kw) -> TrafficProfile:
    """Run ``sim`` for ``n_ticks`` with the profile probe set (records
    dropped, probes only) and fold the output into a
    ``TrafficProfile``.  The probes' whole-run windows stay on the
    device until the run ends; each comes back to the host once, here."""
    program = sim.program
    recs = sim.run(n_ticks, probes=profile_probes(program),
                   keep_records=False, **run_kw)
    po = {k: v[-1].cpu().numpy() for k, v in recs["probes"].items()}
    noc = program.noc
    touched = {}
    for tier, m in noc.tier_masks().items():
        if np.asarray(m).any():
            touched[tier] = float(po[f"touched_{tier}"])
    return TrafficProfile(
        peak=po["link_flits_peak"],
        mean=po["link_flits_mean"],
        src_mean=po["src_packets_mean"],
        src_peak=po["src_packets_peak"],
        touched=touched,
        n_onchip_links=int(getattr(noc, "n_onchip_links", noc.n_links)),
        n_ticks=n_ticks)
