"""Supervisor (teacher) action splitting
(reference: mettagrid_tpu/policy/supervisor_actions.py).

Teachers emit canonical split-action labels: [0, P) = primary actions,
[P, P+V) = vibe actions. This splits them into the engine's dual primary /
vibe buffers in place.
"""

from __future__ import annotations

import numpy as np


def split_supervisor_actions_inplace(
    teacher_actions: np.ndarray,
    vibe_actions: np.ndarray,
    *,
    num_primary_actions: int,
    vibe_action_ids_by_index: np.ndarray,
) -> None:
    labels = teacher_actions.astype(np.int64, copy=False)
    num_vibe = int(vibe_action_ids_by_index.size)
    max_id = num_primary_actions + num_vibe - 1
    invalid = (labels < 0) | (labels > max_id)
    if np.any(invalid):
        agent = int(np.flatnonzero(invalid)[0])
        raise ValueError(
            f"Supervisor produced invalid action id {int(teacher_actions[agent])} for agent {agent}"
        )
    primary = labels < num_primary_actions
    vibe_actions.fill(0)
    vibe_actions[~primary] = vibe_action_ids_by_index[labels[~primary] - num_primary_actions]
    teacher_actions[~primary] = 0  # vibe-only labels act as primary noop


def supervisor_action_space_size(num_primary_actions: int, num_vibe_actions: int) -> int:
    return num_primary_actions + num_vibe_actions
