"""Episode stats export: state tensors -> string-keyed dicts
(reference: MettaGrid::get_episode_stats, cpp/bindings/mettagrid_py.cpp:161-179).

The reference keeps string->float maps that intern a key on first
add/set/get_ptr and export EVERY interned key — including 0.0 values —
sorted by name (StatsTracker::to_dict returns a std::map). The engine
interns the full table at compile time, so the dynamic key set is
reproduced as: key present iff (value != 0) OR its explicit touched bit is
set (construction-time interns, ".amount" writes, set-style mutations —
see engine/state.py). Engine-extension stats with no reference emission
site (program.nonref_game_stats) are excluded so the payload hashes like
the reference's.

Every call reads what it needs from the state in one device-to-host copy
(``host_rows``), and builds the dicts of any number of envs from numpy:
when 4096 envs end on one step, their stats cost one copy, not one read per
env and field.
"""

from __future__ import annotations

from itertools import compress
from typing import Any, Sequence

import numpy as np
import torch


def host_rows(fields: dict, envs: Sequence[int]) -> dict[str, np.ndarray]:
    """The rows ``envs`` of each [E, ...] tensor of ``fields`` as numpy
    arrays [len(envs), ...], read in one device-to-host copy (the rows are
    gathered on the device and packed into one byte tensor)."""
    first = next(iter(fields.values()))
    idx = torch.as_tensor(np.asarray(envs, dtype=np.int64), device=first.device)
    rows = [t.index_select(0, idx) for t in fields.values()]
    packed = torch.cat([r.reshape(-1).view(torch.uint8) for r in rows]).cpu().numpy()
    out, at = {}, 0
    for name, r in zip(fields, rows):
        n = r.numel() * r.element_size()
        dtype = torch.empty(0, dtype=r.dtype).numpy().dtype
        out[name] = packed[at:at + n].view(dtype).reshape(tuple(r.shape))
        at += n
    return out


def stat_fields(program, state) -> dict:
    """The state fields the stats dicts are built from (host_rows' input)."""
    fields = {
        "game_stats": state.game_stats,
        "game_stats_touched": state.game_stats_touched,
        "agent_stats": state.agent_stats,
        "agent_stats_touched": state.agent_stats_touched,
    }
    if program.stats_compact:
        A = program.num_agents
        fields.update(auto_stats=state.auto_stats, agent_inv=state.obj_inv[:, :A], agent_cfg=state.agent_cfg[:, :A])
    return fields


def _agent_columns(program, rows: dict) -> tuple[list, np.ndarray, np.ndarray]:
    """(names, values f64[n, A, K], touched bool[n, A, K]) of every agent
    stat: the regular f32 lanes PLUS, in compact mode (program.stats_compact
    — see engine/program.py AUTO_STAT_BASE), the int32 auto_stats lanes and
    the derived "<res>.amount" keys (value = live inventory; touched iff the
    item ever changed — gained+lost > 0 — or was construction-interned)."""
    names = list(program.agent_stat_names)
    values = [rows["agent_stats"].astype(np.float64)]
    touched = [rows["agent_stats_touched"]]
    if program.stats_compact:
        R = len(program.resource_names)
        names += (
            [f"{r}.gained" for r in program.resource_names]
            + [f"{r}.lost" for r in program.resource_names]
            + [f"{r}.deposited" for r in program.resource_names]
            + ["death", "cell.visited", "cell.unique_visited", "cell.max_distance_from_spawn"]
            + [f"{r}.amount" for r in program.resource_names]
        )
        auto, cfg = rows["auto_stats"], rows["agent_cfg"]
        lanes = len(names) - len(program.agent_stat_names) - R
        values += [auto[..., :lanes].astype(np.float64), rows["agent_inv"].astype(np.float64)]
        touched += [
            np.asarray(program.auto_init_touched, dtype=bool)[cfg][..., :lanes],
            np.asarray(program.amount_init_touched, dtype=bool)[cfg] | (auto[..., :R] > 0) | (auto[..., R:2 * R] > 0),
        ]
    return names, np.concatenate(values, axis=-1), np.concatenate(touched, axis=-1)


def _dicts(names: list, values: np.ndarray, touched: np.ndarray, keep=None) -> list:
    """One name-sorted dict per row of values [M, K]: the keys whose value
    is not 0 or whose touched bit is set (and ``keep``, where given)."""
    order = sorted(range(len(names)), key=names.__getitem__)
    present = ((values != 0.0) | touched)[:, order]
    if keep is not None:
        present &= np.asarray(keep, dtype=bool)[order]
    rows, cols = np.nonzero(present)  # row-major: each row's keys in name order
    keys = np.array([names[j] for j in order], dtype=object)[cols].tolist()
    vals = values[:, order][rows, cols].tolist()
    bounds = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=len(values)))]).tolist()
    return [dict(zip(keys[a:b], vals[a:b])) for a, b in zip(bounds, bounds[1:])]


def agent_stat_dicts(program, rows: dict) -> list:
    """[n][A] name-sorted agent stat dicts of the rows host_rows read."""
    names, values, touched = _agent_columns(program, rows)
    n, A, K = values.shape
    flat = _dicts(names, values.reshape(n * A, K), touched.reshape(n * A, K))
    return [flat[i * A:(i + 1) * A] for i in range(n)]


def game_stat_dicts(program, rows: dict) -> list:
    """[n] name-sorted game stat dicts of the rows host_rows read, without
    the engine-extension stats."""
    names = list(program.game_stat_names)
    keep = [name not in program.nonref_game_stats for name in names]
    return _dicts(names, rows["game_stats"].astype(np.float64), rows["game_stats_touched"], keep)


def merged_agent_rows(program, state, env: int) -> list:
    """Per-agent [(name, value, touched)] lists of env ``env`` (the regular
    lanes, and in compact mode the auto lanes and ".amount" keys)."""
    names, values, touched = _agent_columns(program, host_rows(stat_fields(program, state), [env]))
    return [list(zip(names, v.tolist(), t.tolist())) for v, t in zip(values[0], touched[0])]


def episode_stats(program, state, env: int = 0) -> dict[str, Any]:
    """{"game": {...}, "agent": [{...} per agent]} for one env, name-sorted
    like StatsTracker::to_dict's std::map iteration order."""
    rows = host_rows(stat_fields(program, state), [env])
    return {"game": game_stat_dicts(program, rows)[0], "agent": agent_stat_dicts(program, rows)[0]}


def episode_infos(program, state, envs: Sequence[int]) -> dict[int, dict]:
    """{env: {"stats": episode_stats, "episode_rewards": [...], "length":
    step count}} for each of ``envs``, from one device-to-host copy."""
    fields = dict(stat_fields(program, state), episode_rewards=state.episode_rewards, step_count=state.step_count)
    rows = host_rows(fields, envs)
    games, agents = game_stat_dicts(program, rows), agent_stat_dicts(program, rows)
    return {
        int(e): {
            "stats": {"game": games[i], "agent": agents[i]},
            "episode_rewards": rows["episode_rewards"][i].tolist(),
            "length": int(rows["step_count"][i]),
        }
        for i, e in enumerate(envs)
    }
