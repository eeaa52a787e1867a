"""Deterministic episode signatures
(reference: scripts/deterministic_episode_signature.py:50-120).

SHA-256 over a canonical JSON dump of the full end state: objects (type,
position, vibe, tags, inventory), per-agent episode rewards, and stats.
Canonical ordering throughout (slot index, resource id, sorted stat names)
— the reference's unordered_map orders are canonicalized the same way by
its parity harness (SURVEY.md §3.3 note). The state's fields are read in
one device-to-host copy.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

from mettagrid_tpu_torch.simulator.stats import agent_stat_dicts, game_stat_dicts, host_rows, stat_fields

_OBJECT_FIELDS = ("obj_alive", "obj_type", "obj_r", "obj_c", "obj_vibe", "obj_tags", "obj_inv")


def state_summary(program, state, env: int = 0) -> dict:
    fields = dict(stat_fields(program, state), step_count=state.step_count, episode_rewards=state.episode_rewards)
    fields.update((name, getattr(state, name)) for name in _OBJECT_FIELDS)
    rows = {name: row[0] for name, row in host_rows(fields, [env]).items()}
    objs = []
    for slot in np.nonzero(rows["obj_alive"])[0]:
        objs.append(
            {
                "slot": int(slot),
                "type": program.type_names[int(rows["obj_type"][slot])],
                "r": int(rows["obj_r"][slot]),
                "c": int(rows["obj_c"][slot]),
                "vibe": int(rows["obj_vibe"][slot]),
                "tags": [program.tag_names[t] for t in np.nonzero(rows["obj_tags"][slot])[0]],
                "inventory": {
                    program.resource_names[r]: int(q) for r, q in enumerate(rows["obj_inv"][slot]) if q != 0
                },
            }
        )
    stats = {name: row[None] for name, row in rows.items()}
    # Key-set rule mirrors StatsTracker::to_dict: every interned key exports
    # (value != 0 OR explicitly touched — see simulator/stats.py); engine
    # extension stats with no reference analog are excluded. Compact-mode
    # auto lanes + derived ".amount" merge in via agent_stat_dicts.
    return {
        "step": int(rows["step_count"]),
        "objects": objs,
        "episode_rewards": [round(float(x), 6) for x in rows["episode_rewards"]],
        "agent_stats": [
            {name: round(v, 6) for name, v in agent.items()} for agent in agent_stat_dicts(program, stats)[0]
        ],
        "game_stats": {name: round(v, 6) for name, v in game_stat_dicts(program, stats)[0].items()},
    }


def episode_signature(program, state, env: int = 0) -> str:
    payload = json.dumps(state_summary(program, state, env), sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()
