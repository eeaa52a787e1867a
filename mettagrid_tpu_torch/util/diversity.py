"""Group-based diversity reward shaping
(reference: mettagrid_tpu/util/diversity.py).

Vectorized (no per-agent Python loop): each agent's scaling factor rewards
similarity to its own group's reward distribution and distance from other
groups' distributions.
"""

from __future__ import annotations

import numpy as np


def calculate_diversity_bonus(
    episode_rewards: np.ndarray,
    agent_groups: np.ndarray,
    similarity_coef: float,
    diversity_coef: float,
) -> np.ndarray:
    """Per-agent multiplicative scaling factors:
    1 + similarity_coef * exp(-d_own) + diversity_coef * mean(1 - exp(-d_other)),
    with d = |reward - group_mean| / (group_std + 1e-6)."""
    rewards = np.asarray(episode_rewards, dtype=float)
    groups = np.asarray(agent_groups)
    unique_groups = np.unique(groups)

    means = np.array([rewards[groups == g].mean() for g in unique_groups])
    stds = np.array([rewards[groups == g].std() + 1e-6 for g in unique_groups])

    # [A, G] normalized distance of every agent to every group's distribution
    dist = np.abs(rewards[:, None] - means[None, :]) / stds[None, :]
    own = groups[:, None] == unique_groups[None, :]  # [A, G]

    similarity = np.exp(-dist[own])  # [A] distance to own group
    if len(unique_groups) > 1:
        other_scores = np.where(own, 0.0, 1.0 - np.exp(-dist))
        diversity = other_scores.sum(axis=1) / (len(unique_groups) - 1)
    else:
        diversity = np.zeros_like(similarity)

    return 1.0 + similarity_coef * similarity + diversity_coef * diversity
