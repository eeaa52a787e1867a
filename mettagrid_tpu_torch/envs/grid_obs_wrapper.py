"""Token obs -> dense grid obs converter for CNN policies
(reference: envs/grid_obs_wrapper.py:24-122).

Each (coord_byte, feature_id, value) token scatters its normalized value
into a (C, H, W) grid; globals land at the window center; duplicate tokens
at one cell accumulate."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

_PADDING = 0xFF
_GLOBAL = 0xFE


class GridObsWrapper:
    def __init__(self, env):
        self._env = env
        program = env.program
        self._H = program.obs_height
        self._W = program.obs_width
        id_map = env._config.game.id_map() if hasattr(env, "_config") else None
        features = list(id_map.features()) if id_map else []
        self._C = max((int(f.id) for f in features), default=0) + 1
        scale = np.ones(max(256, self._C), dtype=np.float32)
        for f in features:
            scale[f.id] = max(float(f.normalization), 1.0)
        self._scale = scale

        from gymnasium.spaces import Box

        self.single_observation_space = Box(
            low=0.0, high=np.inf, shape=(self._C, self._H, self._W), dtype=np.float32
        )

    def _convert(self, raw_obs: np.ndarray) -> np.ndarray:
        n = raw_obs.shape[0]
        H, W, C = self._H, self._W, self._C
        coord = raw_obs[..., 0]
        fid = raw_obs[..., 1].astype(np.int32)
        val = raw_obs[..., 2].astype(np.float32)

        y = np.where(coord == _GLOBAL, H // 2, (coord >> 4) & 0x0F)
        x = np.where(coord == _GLOBAL, W // 2, coord & 0x0F)
        valid = (coord != _PADDING) & (y < H) & (x < W) & (fid >= 0) & (fid < C)
        val = (val / self._scale[np.clip(fid, 0, self._scale.shape[0] - 1)]) * valid

        grid = np.zeros((n, C, H, W), dtype=np.float32)
        rows = np.broadcast_to(np.arange(n)[:, None], coord.shape)
        np.add.at(
            grid,
            (rows, np.clip(fid, 0, C - 1), np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)),
            val,
        )
        return grid

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, Dict[str, Any]]:
        raw, info = self._env.reset(seed=seed)
        return self._convert(raw), info

    def step(self, actions):
        raw, rewards, terminals, truncations, info = self._env.step(actions)
        return self._convert(raw), rewards, terminals, truncations, info

    @property
    def num_agents(self) -> int:
        return self._env.num_agents

    @property
    def single_action_space(self):
        return self._env.single_action_space

    def close(self) -> None:
        self._env.close()

    def __getattr__(self, name: str) -> Any:
        return getattr(self._env, name)
