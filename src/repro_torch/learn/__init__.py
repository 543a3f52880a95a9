"""On-mesh synaptic plasticity (paper Sec. III-B; Yan et al. 2009.08921).

Projections of a ``NetGraph`` become trainable by attaching a rule:

    from repro_torch.learn import PES, STDP
    Projection("nef0", "plant0", payload=GRADED, bits_per_packet=32,
               plasticity=PES(learning_rate=3e-5))

``compile``/``compile_board`` lower plastic projections into
``LearnSlot`` descriptors on the program; ``ChipSim`` carries per-slot
weight/trace state (``LearnState``) and applies the rule every tick
(``learn.engine``), pricing the work into a per-PE ``e_learn`` record.
The rules are in ``learn.rules``; the closed-loop adaptive-control and
STDP-pair workloads in ``learn.adaptive`` (a submodule, not imported
here: it reaches back into ``chip``).
"""
from repro_torch.learn.engine import (LearnState, init_learn_state,
                                      learn_state_from_numpy,
                                      make_learn_step)
from repro_torch.learn.lower import LearnSlot, lower_plasticity
from repro_torch.learn.rules import (EXP_ACC_CYCLES, PES, PLASTICITY_RULES,
                                     STDP, exp_op_energy_j, pes_step,
                                     stdp_step_fx, stdp_step_ref,
                                     trace_decay_fx, trace_decays_fx,
                                     trace_step_fx, trace_step_ref,
                                     trace_to_hz)

__all__ = ["STDP", "PES", "PLASTICITY_RULES", "LearnSlot", "LearnState",
           "lower_plasticity", "init_learn_state", "learn_state_from_numpy",
           "make_learn_step", "trace_decay_fx", "trace_decays_fx",
           "trace_step_fx", "trace_step_ref", "trace_to_hz",
           "stdp_step_fx", "stdp_step_ref", "pes_step",
           "exp_op_energy_j", "EXP_ACC_CYCLES"]
