"""Step-and-report action helpers (reference:
mettagrid_tpu/test_support/actions.py).

Each helper queues one action on a Simulation, steps it, and returns a result
dict with success + position/observation details.
"""

from __future__ import annotations

from typing import Any, Dict

ORIENTATIONS = {
    "north": "move_north",
    "south": "move_south",
    "west": "move_west",
    "east": "move_east",
}


def get_agent_position(sim, agent_idx: int = 0):
    loc = sim.agent(agent_idx).location
    return (loc.r, loc.c)


def move(sim, direction: str, agent_idx: int = 0) -> Dict[str, Any]:
    """Move one step in a direction; reports success and positions."""
    direction = direction.lower()
    action = ORIENTATIONS.get(direction, f"move_{direction}")
    before = get_agent_position(sim, agent_idx)
    sim.agent(agent_idx).set_action(action)
    sim.step()
    after = get_agent_position(sim, agent_idx)
    return {
        "success": sim.agent(agent_idx).last_action_success,
        "moved": before != after,
        "position_before": before,
        "position_after": after,
    }


def noop(sim, agent_idx: int = 0) -> Dict[str, Any]:
    sim.agent(agent_idx).set_action("noop")
    sim.step()
    return {"success": sim.agent(agent_idx).last_action_success}


def use(sim, direction: str, agent_idx: int = 0) -> Dict[str, Any]:
    """Bump-use the object in a direction (move onto it)."""
    before_inv = dict(sim.agent(agent_idx).inventory)
    result = move(sim, direction, agent_idx)
    after_inv = dict(sim.agent(agent_idx).inventory)
    gained = {
        k: after_inv.get(k, 0) - before_inv.get(k, 0)
        for k in set(before_inv) | set(after_inv)
        if after_inv.get(k, 0) != before_inv.get(k, 0)
    }
    result["inventory_change"] = gained
    return result
