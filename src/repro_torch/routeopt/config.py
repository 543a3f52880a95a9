"""The board compiler's free routing parameters, as one value object.

``RouteConfig`` is what ``board.route.compile_board(route=...)``
consumes (and what the reference's profile-guided optimizer searches
over).  Three independent knobs, all defaulting to the fixed choices
(X-first trees, port 0), so an empty config gives the default routes:

* ``tree_orient`` — per source population, the on-chip multicast tree
  orientation ("xy" X-then-Y / "yx" Y-then-X) used for the local tree
  on the source chip and the entry trees on every downstream chip;
* ``chip_orient`` — per source population, the orientation of the
  chip-GRANULARITY tree that decides which chips the multicast
  traverses;
* ``ports`` — per (population, chip, direction), which of the board's
  ``ports_per_edge`` parallel border ports that population's exit in
  that direction uses.  A population keeps ONE port per (chip, dir) —
  the router duplicates packets at branch points, so splitting one
  tree's exit across ports would duplicate traffic, not spread it.

This module imports nothing from ``board`` so the board stitcher can
import it without a cycle.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.noc import ORIENTATIONS


@dataclass(frozen=True)
class RouteConfig:
    tree_orient: dict = field(default_factory=dict)  # pop -> "xy" | "yx"
    chip_orient: dict = field(default_factory=dict)  # pop -> "xy" | "yx"
    ports: dict = field(default_factory=dict)        # (pop, chip, dir) -> j

    def orient_tree(self, pop: str) -> str:
        return self.tree_orient.get(pop, "xy")

    def orient_chip(self, pop: str) -> str:
        return self.chip_orient.get(pop, "xy")

    def port_index(self, pop: str, chip: int, d: str) -> int:
        return self.ports.get((pop, chip, d), 0)

    def validate(self, board) -> "RouteConfig":
        """Raise ValueError on an orientation outside ``ORIENTATIONS``
        or a port index outside ``board.ports_per_edge``; returns self
        so callers can chain."""
        for m in (self.tree_orient, self.chip_orient):
            for pop, o in m.items():
                if o not in ORIENTATIONS:
                    raise ValueError(
                        f"population {pop!r}: orientation {o!r} not in "
                        f"{ORIENTATIONS}")
        k = board.ports_per_edge
        for (pop, chip, d), j in self.ports.items():
            if not 0 <= j < k:
                raise ValueError(
                    f"population {pop!r}, chip {chip}, dir {d!r}: port "
                    f"{j} out of range for ports_per_edge={k}")
        return self
