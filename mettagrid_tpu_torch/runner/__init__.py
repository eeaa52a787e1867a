"""Eval runner (reference: mettagrid_tpu/runner/)."""

from mettagrid_tpu_torch.runner.episode_runner import run_episode_isolated
from mettagrid_tpu_torch.runner.rollout import run_episode_local
from mettagrid_tpu_torch.runner.types import EpisodeRequest, EpisodeResult, RunnerError

__all__ = [
    "EpisodeRequest",
    "EpisodeResult",
    "RunnerError",
    "run_episode_isolated",
    "run_episode_local",
]
