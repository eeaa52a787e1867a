"""Runtime observation parsing into semantic state
(reference: sdk/agent/runtime/observation.py)."""

from __future__ import annotations

from mettagrid_tpu_torch.sdk.state import (
    GridPosition,
    MettagridState,
    SelfState,
    SemanticEntity,
    TeamMemberSummary,
    TeamSummary,
)


def build_state(sim, agent_id: int, env: int = 0) -> MettagridState:
    """Build the semantic snapshot for one agent from live simulation state."""
    objs = sim.grid_objects(env)
    # grid_objects keys are 1-based object ids (0 = empty space, matching the
    # reference API); agents are found by their agent_id field.
    me = next((o for o in objs.values() if o.get("agent_id") == agent_id), None)
    assert me is not None, f"agent {agent_id} not alive"

    my_loc = sim.agent(agent_id).location
    hr = sim.config.game.obs.height // 2
    wr = sim.config.game.obs.width // 2

    self_state = SelfState(
        entity_id=f"agent_{agent_id}",
        entity_type="agent",
        position=GridPosition(x=me["c"], y=me["r"]),
        labels=me["tags"],
        inventory=dict(me["inventory"]),
    )

    visible: list[SemanticEntity] = []
    for slot, obj in objs.items():
        if slot == agent_id:
            continue
        if abs(obj["r"] - my_loc.r) > hr or abs(obj["c"] - my_loc.c) > wr:
            continue
        visible.append(
            SemanticEntity(
                entity_id=f"{obj['type_name']}_{slot}",
                entity_type=obj["type_name"],
                position=GridPosition(x=obj["c"], y=obj["r"]),
                labels=obj["tags"],
                attributes={**{f"inv:{k}": v for k, v in obj["inventory"].items()}},
            )
        )

    my_group = me.get("group", 0)
    members = [
        TeamMemberSummary(
            entity_id=f"agent_{slot}",
            role="agent",
            position=GridPosition(x=o["c"], y=o["r"]),
        )
        for slot, o in objs.items()
        if "agent_id" in o and o.get("group") == my_group
    ]
    team = TeamSummary(team_id=f"team_{my_group}", members=members)

    return MettagridState(
        game=sim.config.label,
        step=sim.current_step,
        self_state=self_state,
        visible_entities=visible,
        team_summary=team,
    )
