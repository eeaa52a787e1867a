"""Simulation orchestration (reference: python/src/mettagrid/simulator/)."""

from mettagrid_tpu_torch.simulator.interface import (
    AgentObservation,
    Location,
    ObservationToken,
    SimulatorEventHandler,
)
from mettagrid_tpu_torch.simulator.monologue_projection import (
    compute_monologue_transcript_update,
    strip_monologue_transcript_tail,
)
from mettagrid_tpu_torch.simulator.simulator import Simulation, SimulationAgent, Simulator
from mettagrid_tpu_torch.simulator.stats import episode_stats
from mettagrid_tpu_torch.simulator.time_averaged_stats import TimeAveragedStatsHandler
from mettagrid_tpu_torch.types import Action, EpisodeStats

__all__ = [
    "Action",
    "AgentObservation",
    "EpisodeStats",
    "Location",
    "ObservationToken",
    "Simulation",
    "SimulationAgent",
    "Simulator",
    "SimulatorEventHandler",
    "TimeAveragedStatsHandler",
    "compute_monologue_transcript_update",
    "episode_stats",
    "strip_monologue_transcript_tail",
]
