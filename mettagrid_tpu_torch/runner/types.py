"""Runner request/result types (reference: mettagrid_tpu/runner/types.py)."""

from __future__ import annotations

from typing import Any, Optional

from pydantic import BaseModel, Field

from mettagrid_tpu_torch.config.game_config import MettaGridConfig
from mettagrid_tpu_torch.policy.policy import PolicySpec


class EpisodeRequest(BaseModel):
    config: MettaGridConfig
    policy_specs: list[PolicySpec]
    # agent assignment: policy index per agent (len == num_agents); None = all
    # agents on policy 0
    assignments: Optional[list[int]] = None
    seed: int = 0
    max_steps: Optional[int] = None


class EpisodeResult(BaseModel):
    steps: int = 0
    episode_rewards: list[float] = Field(default_factory=list)
    episode_stats: dict[str, Any] = Field(default_factory=dict)
    error: Optional[str] = None


class RunnerError(BaseModel):
    """Structured error-file payload (reference: runner/executor.py:27-44)."""

    kind: str
    message: str
    traceback: str = ""
