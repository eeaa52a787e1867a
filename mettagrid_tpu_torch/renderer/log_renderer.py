"""Log renderer: prints simulation events to the logger
(reference: renderer/log_renderer.py)."""

from __future__ import annotations

import logging

from mettagrid_tpu_torch.renderer.renderer import Renderer

logger = logging.getLogger(__name__)


class LogRenderer(Renderer):
    def on_episode_start(self) -> None:
        logger.info("=== Episode Start ===")
        logger.info("Num agents: %s", self.sim.num_agents)
        logger.info("Max steps: %s", self.sim.config.game.max_steps)

    def on_step(self) -> None:
        logger.info("--------------------------------")
        logger.info("Step %s", self.sim.current_step)
        logger.info("Episode rewards: %s", self.sim.episode_rewards)
        logger.info("Done: %s", self.sim.is_done)

    def on_episode_end(self) -> None:
        logger.info("=== Episode End ===")
        logger.info("Total steps: %s", self.sim.current_step)
        logger.info("Total rewards: %s", self.sim.episode_rewards)
