"""Reward phase (reference: systems/reward.hpp:55-78; the JAX engine's
engine/rewards.py).

Each agent has a static list of compiled reward entries (game-value
expressions); per step the engine adds value - prev (default) or the raw
value (accumulate mode) to the rewards, then accumulates episode rewards.
"""

from __future__ import annotations

import torch

from mettagrid_tpu_torch.engine.exec import eval_value_agents
from mettagrid_tpu_torch.engine.program import EngineProgram
from mettagrid_tpu_torch.engine.state import EnvState


def make_reward_phase(program: EngineProgram):
    def reward_phase(state: EnvState) -> EnvState:
        if program.num_reward_entries == 0:
            return state._replace(episode_rewards=state.episode_rewards + state.rewards)

        total = torch.zeros_like(state.rewards)
        new_prev = state.reward_prev.clone()

        for cfg_idx, entries in enumerate(program.reward_programs):
            cfg_mask = state.agent_cfg == cfg_idx  # [E, A]
            for j, entry in enumerate(entries):
                val = eval_value_agents(program, state, entry.value)
                prev = state.reward_prev[:, :, j]
                delta = val if entry.accumulate else val - prev
                total = total + torch.where(cfg_mask, delta, 0.0)
                # Each config updates only its own agents' column j, so
                # configs that share entry j keep each other's updates (the
                # reference rewrites the whole column from the step-start
                # value, and a later config's entry j undoes an earlier one's).
                new_prev[:, :, j] = torch.where(cfg_mask, val, new_prev[:, :, j])

        rewards = state.rewards + total
        return state._replace(
            rewards=rewards,
            reward_prev=new_prev,
            episode_rewards=state.episode_rewards + rewards,
        )

    return reward_phase
