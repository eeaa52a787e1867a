"""Early-reset desync handler (reference: envs/early_reset_handler.py:6-25).

Ends the FIRST episode at a seed-derived random step so a fleet of envs
doesn't finish episodes in lockstep (per-episode numpy RNG keyed on the
simulation seed — fork-safe, no global RNG state)."""

from __future__ import annotations

import numpy as np

from mettagrid_tpu_torch.simulator.interface import SimulatorEventHandler


class EarlyResetHandler(SimulatorEventHandler):
    def __init__(self):
        super().__init__()
        self._should_early_reset = True
        self._early_reset_step: int | None = None

    def on_episode_start(self) -> None:
        if self._should_early_reset:
            self._should_early_reset = False
            rng = np.random.default_rng(self._simulation.seed)
            max_steps = max(self._simulation.config.game.max_steps, 1)
            self._early_reset_step = int(rng.integers(1, max_steps + 1))

    def on_step(self) -> None:
        if self._early_reset_step is not None and self._simulation.current_step >= self._early_reset_step:
            self._simulation.end_episode()
            self._early_reset_step = None
