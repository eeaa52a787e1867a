"""PettingZoo ParallelEnv adapter (reference: envs/pettingzoo_env.py:22-224)."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from mettagrid_tpu_torch.config.game_config import MettaGridConfig
from mettagrid_tpu_torch.envs.vector_env import MettaGridVectorEnv

try:
    from pettingzoo import ParallelEnv
except ImportError:  # pragma: no cover
    ParallelEnv = object  # type: ignore[assignment,misc]


class MettaGridPettingZooEnv(ParallelEnv):
    """Dict-per-agent parallel API over one env instance (E=1)."""

    metadata = {"name": "mettagrid_tpu", "render_modes": []}

    def __init__(self, config: MettaGridConfig, seed: int = 0, device=None):
        self._env = MettaGridVectorEnv(config, num_envs=1, seed=seed, auto_reset=False, device=device)
        A = self._env.agents_per_env
        self.possible_agents = [f"agent_{i}" for i in range(A)]
        self.agents = list(self.possible_agents)

    def observation_space(self, agent: str):
        return self._env.single_observation_space

    def action_space(self, agent: str):
        return self._env.single_action_space

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        obs, _ = self._env.reset(seed=seed)
        self.agents = list(self.possible_agents)
        observations = {name: obs[i] for i, name in enumerate(self.possible_agents)}
        infos = {name: {} for name in self.possible_agents}
        return observations, infos

    def step(self, actions: dict[str, Any]):
        acts = np.zeros(len(self.possible_agents), dtype=np.int32)
        for i, name in enumerate(self.possible_agents):
            if name in actions:
                acts[i] = int(actions[name])
        obs, rewards, terminals, truncations, _ = self._env.step(acts)
        observations = {n: obs[i] for i, n in enumerate(self.possible_agents)}
        rew = {n: float(rewards[i]) for i, n in enumerate(self.possible_agents)}
        term = {n: bool(terminals[i]) for i, n in enumerate(self.possible_agents)}
        trunc = {n: bool(truncations[i]) for i, n in enumerate(self.possible_agents)}
        infos = {n: {} for n in self.possible_agents}
        if all(term[n] or trunc[n] for n in self.possible_agents):
            self.agents = []
        return observations, rew, term, trunc, infos

    def render(self):  # pragma: no cover
        return None

    def close(self):
        self._env.close()
