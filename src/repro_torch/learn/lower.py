"""Plasticity lowering: graph projections -> per-projection learn slots.

Shared by the chip compiler (``chip.compile.compile``) and the board
compiler (``board.route.compile_board``): both call
``lower_plasticity(graph, pe_slices)`` after placement and store the
tuple on the program, so a plastic graph trains the same on one chip and
across a board, and a graph without plasticity lowers to
``learn_slots == ()`` (the engine then runs exactly the frozen tick).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.chip.graph import GRADED, SPIKE, NetGraph
from repro_torch.learn.rules import PES, STDP


@dataclass(frozen=True)
class LearnSlot:
    """One plastic projection, lowered.

    ``n_pre``/``n_post`` are the unit counts of the source/destination
    populations (STDP: the synapse matrix; PES: the decoders, ``n_post``
    the error dimensionality).  ``pe_ids`` are the logical PEs that run,
    and are charged ``e_learn`` for, the update: the destination tiles
    for STDP (fan-in weights live at the synapse), the source tiles for
    PES (decoders live where decoding happens).
    """
    name: str
    kind: str                  # "stdp" | "pes"
    rule: object
    src: str
    dst: str
    n_pre: int
    n_post: int
    pe_ids: tuple


def lower_plasticity(graph: NetGraph, pe_slices: dict) -> tuple:
    """Collect the graph's plastic projections into ``LearnSlot``s,
    checking each rule against its payload with errors that name the
    edge."""
    slots = []
    for pr in graph.projections:
        rule = getattr(pr, "plasticity", None)
        if rule is None:
            continue
        edge = f"{pr.src}->{pr.dst}"
        if isinstance(rule, STDP):
            if pr.payload != SPIKE:
                raise ValueError(
                    f"projection {edge}: STDP needs a SPIKE projection "
                    f"(pair STDP is defined on spike events), got "
                    f"{pr.payload!r}")
            kind, own = "stdp", pe_slices[pr.dst]
        elif isinstance(rule, PES):
            if pr.payload != GRADED:
                raise ValueError(
                    f"projection {edge}: PES needs a GRADED projection "
                    f"(it carries the decoded value), got {pr.payload!r}")
            kind, own = "pes", pe_slices[pr.src]
        else:
            raise ValueError(
                f"projection {edge}: unknown plasticity rule "
                f"{type(rule).__name__!r}; expected STDP or PES")
        slots.append(LearnSlot(
            name=edge, kind=kind, rule=rule, src=pr.src, dst=pr.dst,
            n_pre=graph.population(pr.src).n,
            n_post=graph.population(pr.dst).n,
            pe_ids=tuple(range(own.start, own.stop))))
    return tuple(slots)
