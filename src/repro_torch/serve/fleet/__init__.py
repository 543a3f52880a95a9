from repro_torch.serve.fleet.engine import FleetEngine, FleetObs
from repro_torch.serve.fleet.scenarios import (SCENARIOS, ServedScenario,
                                               SineStream, adaptive_scenario,
                                               blank_stim, kws_scenario,
                                               served_adaptive_graph,
                                               served_kws_graph,
                                               stim_windows)
from repro_torch.serve.fleet.sessions import Session, SessionTable
from repro_torch.serve.fleet.traffic import PoissonTraffic, SessionSpec

__all__ = ["FleetEngine", "FleetObs", "PoissonTraffic", "SCENARIOS",
           "ServedScenario", "Session", "SessionSpec", "SessionTable",
           "SineStream", "adaptive_scenario", "blank_stim", "kws_scenario",
           "served_adaptive_graph", "served_kws_graph", "stim_windows"]
