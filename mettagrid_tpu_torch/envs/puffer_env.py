"""PufferLib adapter (reference: envs/mettagrid_puffer_env.py:66-426).

PufferLib is an optional dependency (absent from this image); when present,
MettaGridPufferEnv subclasses pufferlib.PufferEnv and shares its buffers.
Without it, the class still offers the same buffer-protocol surface via
MettaGridVectorEnv, so trainers can duck-type against it. ``device`` is
the vector env's (CUDA unless device="cpu").
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from mettagrid_tpu_torch.config.game_config import MettaGridConfig
from mettagrid_tpu_torch.envs.vector_env import MettaGridVectorEnv

try:  # optional (reference: optional_deps.py:11-30)
    import pufferlib

    _PufferEnv = pufferlib.PufferEnv
    HAS_PUFFERLIB = True
except ImportError:  # pragma: no cover
    _PufferEnv = object
    HAS_PUFFERLIB = False


class MettaGridPufferEnv(_PufferEnv):  # type: ignore[misc]
    """Batched PufferEnv: num_agents = E * agents_per_env rows."""

    def __init__(
        self,
        config: MettaGridConfig,
        num_envs: int = 1,
        seed: int = 0,
        buf: Optional[Any] = None,
        device=None,
    ):
        self._venv = MettaGridVectorEnv(config, num_envs=num_envs, seed=seed, device=device)
        self.single_observation_space = self._venv.single_observation_space
        self.single_action_space = self._venv.single_action_space
        self.num_agents = self._venv.num_agents
        if HAS_PUFFERLIB:
            super().__init__(buf)

    @property
    def env_cfg(self) -> MettaGridConfig:
        return self._venv._config

    @property
    def program(self):
        return self._venv.program

    def reset(self, seed: Optional[int] = None):
        obs, info = self._venv.reset(seed=seed)
        if HAS_PUFFERLIB:
            np.copyto(self.observations, obs)
            return self.observations, []
        return obs, info

    def step(self, actions):
        actions = np.asarray(actions)
        if actions.ndim == 2 and actions.shape[-1] == 2:
            # 2-D transport: [primary, vibe] columns
            obs, rew, term, trunc, info = self._venv.step(actions[..., 0], actions[..., 1])
        else:
            obs, rew, term, trunc, info = self._venv.step(actions)
        if HAS_PUFFERLIB:
            np.copyto(self.observations, obs)
            np.copyto(self.rewards, rew)
            np.copyto(self.terminals, term)
            np.copyto(self.truncations, trunc)
            return self.observations, self.rewards, self.terminals, self.truncations, [], []
        return obs, rew, term, trunc, info

    def close(self):
        self._venv.close()
