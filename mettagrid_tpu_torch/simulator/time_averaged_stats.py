"""Time-averaged game stats (reference: simulator/time_averaged_stats.py).

Episode-end stats only capture the final state; metrics that fluctuate
during an episode (territory held, active effects) need per-step sampling.
"""

from __future__ import annotations

from collections import defaultdict

from mettagrid_tpu_torch.simulator.interface import SimulatorEventHandler


class TimeAveragedStatsHandler(SimulatorEventHandler):
    """Samples episode_stats['game'] every step; exposes the time-average."""

    def __init__(self) -> None:
        super().__init__()
        self._step_count = 0
        self._accumulated: defaultdict[str, float] = defaultdict(float)

    def on_episode_start(self) -> None:
        self._step_count = 0
        self._accumulated.clear()

    def on_step(self) -> None:
        self._step_count += 1
        for key, value in self._simulation.episode_stats.get("game", {}).items():
            self._accumulated[key] += float(value)

    @property
    def time_averaged_game_stats(self) -> dict[str, float]:
        if self._step_count == 0:
            return {}
        return {k: v / self._step_count for k, v in self._accumulated.items()}
