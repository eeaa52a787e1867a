"""Batched env state: a struct of tensors with a leading env dimension E.

Field names, shapes and dtypes follow the reference engine's EnvState
(mettagrid_tpu/engine/state.py) so the two can be compared field by field.
Object slots: agents occupy slots 0..A-1 (agent_id == slot), other objects
A..N-1; grid cells store a slot index or -1.

Two fields differ in dtype: ``rng`` is int64[E, 2] (the reference holds a
uint32 PRNG key; here random draws come from a torch.Generator and the field
only records the reset seed and env index) and ``mt`` is int64[E, 0] (the
MT19937 twin is not part of this engine yet).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no CUDA device and no explicit ``device``, this raises instead of
    falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mettagrid_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


class EnvState(NamedTuple):
    # --- world ---
    grid: torch.Tensor  # int32[E, H, W]: object slot at cell, -1 = empty
    obj_type: torch.Tensor  # int32[E, N]
    obj_r: torch.Tensor  # int32[E, N]
    obj_c: torch.Tensor  # int32[E, N]
    obj_vibe: torch.Tensor  # int32[E, N]
    obj_tags: torch.Tensor  # bool[E, N, n_tags]
    obj_inv: torch.Tensor  # int32[E, N, R]
    obj_alive: torch.Tensor  # bool[E, N]

    # --- agent extras (slots 0..A-1) ---
    agent_group: torch.Tensor  # int32[E, A]
    agent_cfg: torch.Tensor  # int32[E, A]
    agent_spawn_r: torch.Tensor  # int32[E, A]
    agent_spawn_c: torch.Tensor  # int32[E, A]
    agent_prev_r: torch.Tensor  # int32[E, A]: location snapshot at step start
    agent_prev_c: torch.Tensor  # int32[E, A]
    agent_last_action: torch.Tensor  # int32[E, A]
    action_success: torch.Tensor  # bool[E, A]
    agent_action_prev_r: torch.Tensor  # int32[E, A]
    agent_action_prev_c: torch.Tensor  # int32[E, A]
    agent_swm: torch.Tensor  # int32[E, A]: steps without motion

    # bool[E, n_aoe_specs, N, A]: agent a inside source n's AOE k last tick
    # ([E, 1, 1, 1] without AOE specs)
    aoe_inside: torch.Tensor
    # int32[E, n_territories, A]: the tag owning agent a's cell, -1 = none
    # ([E, 1, 1] without territories)
    territory_inside: torch.Tensor

    # --- stats ---
    game_stats: torch.Tensor  # f32[E, Sg]
    agent_stats: torch.Tensor  # f32[E, A, Sa]
    game_stats_prev: torch.Tensor  # f32[E, Sg]
    agent_stats_prev: torch.Tensor  # f32[E, A, Sa]
    game_stats_touched: torch.Tensor  # bool[E, Sg]
    agent_stats_touched: torch.Tensor  # bool[E, A, Sa]
    auto_stats: torch.Tensor  # int32[E, A, num_auto_lanes]
    auto_stats_prev: torch.Tensor  # int32[E, A, num_auto_lanes | 0]
    obj_inv_prev: torch.Tensor  # int32[E, N | 0, R]
    visit_bitmap: torch.Tensor  # int32[E, A, ceil(H*W/32)]
    obj_visited: torch.Tensor  # int32[E, N]

    # --- rewards / episode ---
    rewards: torch.Tensor  # f32[E, A]
    episode_rewards: torch.Tensor  # f32[E, A]
    reward_prev: torch.Tensor  # f32[E, A, n_entries]
    terminals: torch.Tensor  # bool[E, A]
    truncations: torch.Tensor  # bool[E, A]
    step_count: torch.Tensor  # int32[E]

    rng: torch.Tensor  # int64[E, 2]: (reset seed, env index)
    mt: torch.Tensor  # int64[E, 0]

    map_idx: torch.Tensor  # int32[E]: which pooled map this env runs

    @property
    def num_envs(self) -> int:
        return self.grid.shape[0]


class StepOutputs(NamedTuple):
    """Per-step outputs (the reference buffer contract)."""

    observations: torch.Tensor  # uint8[E, A, T, 3]
    rewards: torch.Tensor  # f32[E, A]
    terminals: torch.Tensor  # bool[E, A]
    truncations: torch.Tensor  # bool[E, A]
    action_success: torch.Tensor  # bool[E, A]
    tokens_attempted: torch.Tensor  # int32[E, A]
