"""The comparison that decides ``correct``: the program's results against the
plain reference's, for the envs a run samples.

The results are the pool's maps (``pool_maps``), the state and outputs after
the last step, and the outputs of the window's steps 1, 2, 4, 8, ...
(``<name>@<step>``). Each number compared counts the elements of a group of
results in which the two disagree. GROUPS gathers the results of the arena
game; a result of the reference that no group names is a group of its own,
so none goes uncompared. Every limit is 0, since the configuration states
exact results. A result the program does not give counts whole.
"""

from __future__ import annotations

import numpy as np

GROUPS = {
    "maps": ("pool_maps",),
    "positions": ("positions", "grid"),
    "observations": ("observations", "tokens_attempted"),
    "rewards": ("rewards", "episode_rewards"),
    "episode_ends": ("terminals", "truncations", "step_count", "map_idx"),
    "actions": ("action_success", "agent_stat:action."),
    "stats": ("agent_stat:status.", "agent_stat:cell.", "game_stat:"),
}
LIMIT = 0
NOT_PER_ENV = ("pool_maps",)


def _base(key: str) -> str:
    """``<name>@<step>`` is ``<name>`` at that step."""
    return key.split("@")[0]


def groups(keys) -> dict:
    """{group: the results in it}: GROUPS' groups, then one for each result
    that none of them names."""
    out = {name: [k for k in keys if any(_base(k) == g or (g.endswith((".", ":")) and k.startswith(g))
                                         for g in group)] for name, group in GROUPS.items()}
    covered = {k for ks in out.values() for k in ks}
    for k in keys:
        if k not in covered:
            out.setdefault(_base(k), []).append(k)
    return out


def _unequal(ref, got) -> np.ndarray:
    """Elementwise disagreement of ``ref`` and ``got`` (all of ``ref`` where
    ``got`` is missing or shaped otherwise)."""
    ref = np.asarray(ref)
    if got is None or np.shape(got) != ref.shape:
        return np.ones(ref.shape, dtype=bool)
    return ref != np.asarray(got)


def compare(ref: dict, got: dict) -> dict:
    """{group: mismatched elements}."""
    return {name: sum(int(np.count_nonzero(_unequal(ref[k], got.get(k)))) for k in ks)
            for name, ks in groups(ref).items()}


def wrong_envs(ref: dict, got: dict) -> int:
    """The sampled envs in which some per-env result disagrees."""
    bad = np.zeros(len(ref["step_count"]), dtype=bool)
    for k, r in ref.items():
        if _base(k) not in NOT_PER_ENV:
            bad |= _unequal(r, got.get(k)).reshape(len(bad), -1).any(axis=1)
    return int(bad.sum())
