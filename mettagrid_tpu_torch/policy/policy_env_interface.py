"""Lightweight environment description handed to policies at init
(reference: mettagrid_tpu/policy/policy_env_interface.py).

Serializable (pydantic), so it crosses subprocess / policy-server boundaries
without dragging the full game config along.
"""

from __future__ import annotations

from typing import Literal, Optional

import numpy as np
from pydantic import BaseModel, Field, field_validator

from mettagrid_tpu_torch.config.action_config import CHANGE_VIBE_PREFIX
from mettagrid_tpu_torch.config.game_config import TalkConfig
from mettagrid_tpu_torch.config.id_map import ObservationFeatureSpec


class PolicyEnvInterface(BaseModel):
    obs_features: list[ObservationFeatureSpec] = Field(
        default_factory=list,
        description="Feature specs (id, name, normalization) for token observations",
    )
    tags: list[str] = Field(
        default_factory=list,
        description="Sorted object tag names; tag IDs in observations index this list",
    )
    action_names: list[str] = Field(description="Ordered primary action names")
    vibe_action_names: list[str] = Field(default_factory=list)
    move_energy_cost: Optional[int] = None
    observation_kind: Literal["token", "box", "bitmask"] = "token"
    observation_dtype: str = "uint8"
    observation_low: float | None = 0.0
    observation_high: float | None = 255.0
    num_agents: int = Field(description="Number of agents in the environment")
    observation_shape: tuple[int, ...] = Field(
        description="Observation tensor shape, typically (num_tokens, token_dim)"
    )
    egocentric_shape: tuple[int, int] = Field(
        description="(height, width) of the egocentric observation window"
    )
    talk: TalkConfig = Field(default_factory=TalkConfig)

    @field_validator("observation_kind", mode="before")
    @classmethod
    def _normalize_observation_kind(cls, value: object) -> object:
        return "token" if value == "tokens" else value

    @property
    def obs_height(self) -> int:
        return self.egocentric_shape[0]

    @property
    def obs_width(self) -> int:
        return self.egocentric_shape[1]

    @property
    def num_tokens(self) -> int:
        return self.observation_shape[0]

    @property
    def observation_space(self):
        import gymnasium as gym

        dtype = np.dtype(self.observation_dtype)
        low = 0.0 if self.observation_low is None else float(self.observation_low)
        high = 255.0 if self.observation_high is None else float(self.observation_high)
        return gym.spaces.Box(low, high, self.observation_shape, dtype=dtype.type)

    @property
    def action_space(self):
        import gymnasium as gym

        return gym.spaces.Discrete(len(self.action_names))

    @property
    def vibe_action_space(self):
        import gymnasium as gym

        return gym.spaces.Discrete(max(1, len(self.vibe_action_names)))

    @staticmethod
    def split_action_names(action_names: list[str]) -> tuple[list[str], list[str]]:
        primary = [a for a in action_names if not a.startswith(CHANGE_VIBE_PREFIX)]
        vibe = [a for a in action_names if a.startswith(CHANGE_VIBE_PREFIX)]
        return primary, vibe

    @classmethod
    def from_config(cls, config) -> "PolicyEnvInterface":
        """Build from a MettaGridConfig (reference: policy_env_interface.py
        from_mg_cfg)."""
        game = config.game
        id_map = game.id_map()
        all_names = [a.name for a in game.actions.actions()]
        primary, vibe = cls.split_action_names(all_names)
        return cls(
            obs_features=id_map.features(),
            tags=id_map.tag_names(),
            action_names=primary,
            vibe_action_names=vibe,
            num_agents=game.num_agents,
            observation_shape=(game.obs.num_tokens, game.obs.token_dim),
            egocentric_shape=(game.obs.height, game.obs.width),
            talk=getattr(game, "talk", None) or TalkConfig(),
        )
