"""Multi-episode rollouts + summaries
(reference: mettagrid_tpu/simulator/multi_episode.py)."""

from __future__ import annotations

from collections import defaultdict
from typing import Optional, Sequence

import numpy as np
from pydantic import BaseModel, Field

from mettagrid_tpu_torch.config.game_config import MettaGridConfig
from mettagrid_tpu_torch.simulator.rollout import Rollout


class MultiEpisodeRolloutResult(BaseModel):
    episode_rewards: list[list[float]] = Field(default_factory=list)  # [episode][agent]
    episode_steps: list[int] = Field(default_factory=list)
    game_stats: list[dict[str, float]] = Field(default_factory=list)
    agent_stats: list[list[dict[str, float]]] = Field(default_factory=list)


class MultiEpisodePolicySummary(BaseModel):
    """One policy's aggregate over all episodes
    (reference: multi_episode/summary.py:11-21)."""

    agent_count: int
    avg_agent_metrics: dict[str, float]


class MultiEpisodeSummary(BaseModel):
    """Aggregate over episodes (reference: multi_episode/summary.py:22-38)."""

    episodes: int
    policy_summaries: list[MultiEpisodePolicySummary]
    avg_game_stats: dict[str, float]
    per_episode_per_policy_avg_rewards: dict[int, list[Optional[float]]]


def run_multi_episode(
    config: MettaGridConfig,
    policies,  # [(policy, agent_ids)]
    episodes: int,
    seed: int = 0,
    device=None,
) -> MultiEpisodeRolloutResult:
    """``episodes`` Rollouts, seeds ``seed``, ``seed + 1``, ..., each on
    ``device`` (None means CUDA, and raises without a card unless the
    caller passes device="cpu")."""
    result = MultiEpisodeRolloutResult()
    for ep in range(episodes):
        rollout = Rollout(config, policies, seed=seed + ep, device=device)
        r = rollout.run()
        result.episode_rewards.append([float(x) for x in r.episode_rewards])
        result.episode_steps.append(r.steps)
        result.game_stats.append(r.episode_stats["game"])
        result.agent_stats.append(r.episode_stats["agent"])
    return result


def summarize(
    result: MultiEpisodeRolloutResult,
    policy_agent_ids: Sequence[Sequence[int]],
) -> MultiEpisodeSummary:
    episodes = len(result.episode_rewards)
    # avg game stats
    game_totals: dict[str, float] = defaultdict(float)
    for stats in result.game_stats:
        for k, v in stats.items():
            game_totals[k] += v
    avg_game = {k: v / max(episodes, 1) for k, v in game_totals.items()}

    policy_summaries = []
    per_ep_rewards: dict[int, list[Optional[float]]] = {}
    for pi, ids in enumerate(policy_agent_ids):
        metric_totals: dict[str, float] = defaultdict(float)
        metric_counts = 0
        for ep_stats in result.agent_stats:
            for a in ids:
                metric_counts += 1
                for k, v in ep_stats[a].items():
                    metric_totals[k] += v
        policy_summaries.append(
            MultiEpisodePolicySummary(
                agent_count=len(ids),
                avg_agent_metrics={k: v / max(metric_counts, 1) for k, v in metric_totals.items()},
            )
        )
    for ep in range(episodes):
        row: list[Optional[float]] = []
        for ids in policy_agent_ids:
            if ids:
                row.append(float(np.mean([result.episode_rewards[ep][a] for a in ids])))
            else:
                row.append(None)
        per_ep_rewards[ep] = row

    return MultiEpisodeSummary(
        episodes=episodes,
        policy_summaries=policy_summaries,
        avg_game_stats=avg_game,
        per_episode_per_policy_avg_rewards=per_ep_rewards,
    )
