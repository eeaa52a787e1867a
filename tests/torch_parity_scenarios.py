"""The cross-engine scenarios of tests/test_cross_engine_parity.py as data.

    from tests.torch_parity_scenarios import SCENARIOS

SCENARIOS maps a name to the port's parity.cross_engine.Scenario:
test_contested_moves_many_seeds' layout appears once per seed, so 18
scenarios give 21 cases. tests/test_torch_cross_engine.py holds the port's
run_ours on each to the JAX package's (and to the reference C++ engine,
where it is built), and chip_smoke.py holds each on the card to the CPU.
This module imports only the port.
"""

from mettagrid_tpu_torch.parity.cross_engine import Scenario

COMBAT_MAP = [
    ["wall", "wall", "wall", "wall"],
    ["wall", "agent.agent", "agent.agent", "wall"],
    ["wall", "empty", "empty", "wall"],
    ["wall", "wall", "wall", "wall"],
]

COMBAT_RESOURCES = ["laser", "armor", "hp"]

ATTACK_HANDLER = {
    "name": "melee",
    "actor_vibe": "swords",
    "direct_attack": {"weapon": "laser", "armor": "armor", "health": "hp", "pct": 100},
}

MINE_ROOM = [
    ["wall", "wall", "wall", "wall"],
    ["wall", "agent.agent", "mine", "wall"],
    ["wall", "empty", "empty", "wall"],
    ["wall", "wall", "wall", "wall"],
]

RAY_MAP = [
    ["wall"] * 8,
    ["wall", "agent.agent", "hub", "empty", "wall", "empty", "empty", "wall"],
    ["wall"] * 8,
]


def _bloom(**extra):
    return {
        "bloom": {
            "target_type": "hub",
            "timesteps": [1],
            "mutations": [
                dict({"kind": "raycast_spawn", "object_type": "crystal", "directions": ["east"], "max_range": 4},
                     **extra)
            ],
        }
    }


SCENARIOS = {
    # Walk the perimeter of a 3x3 room, bumping walls on the way.
    "single_agent_moves_and_walls": Scenario(
        map_data=[
            ["wall", "wall", "wall", "wall", "wall"],
            ["wall", "agent.agent", "empty", "empty", "wall"],
            ["wall", "empty", "empty", "empty", "wall"],
            ["wall", "empty", "empty", "empty", "wall"],
            ["wall", "wall", "wall", "wall", "wall"],
        ],
        num_agents=1,
        scripts=[["move_north"], ["move_east"], ["move_east"], ["move_east"], ["move_south"], ["move_south"],
                 ["move_south"], ["move_west"], ["noop"], ["move_west"], ["move_north"], ["move_west"],
                 ["move_north"]],
    ),
    "mine_use_inventory_and_reward": Scenario(
        map_data=MINE_ROOM,
        num_agents=1,
        objects={"mine": {"kind": "mine", "gives": {"ore_red": 1}}},
        agent_rewards={"ore_red": 0.5},
        scripts=[["move_east"], ["move_east"], ["move_south"], ["move_east"], ["move_north"]],
    ),
    # Agents far apart with non-conflicting scripts: the agent order cannot
    # matter, so the comparison is exact without the reference shuffle.
    "two_agents_disjoint_zones": Scenario(
        map_data=[
            ["wall"] * 9,
            ["wall", "agent.agent", "empty", "empty", "wall", "empty", "empty", "agent.agent", "wall"],
            ["wall", "empty", "empty", "empty", "wall", "empty", "empty", "empty", "wall"],
            ["wall"] * 9,
        ],
        num_agents=2,
        scripts=[["move_east", "move_west"], ["move_south", "move_south"], ["move_east", "move_west"],
                 ["move_north", "move_north"], ["move_west", "move_east"], ["noop", "move_east"]],
    ),
    # Two agents racing for the same cells: the per-step MT19937 agent
    # shuffle decides each winner.
    "contested_moves_reference_shuffle": Scenario(
        map_data=[
            ["wall", "wall", "wall", "wall", "wall"],
            ["wall", "agent.agent", "empty", "agent.agent", "wall"],
            ["wall", "empty", "empty", "empty", "wall"],
            ["wall", "wall", "wall", "wall", "wall"],
        ],
        num_agents=2,
        reference_shuffle=True,
        scripts=[["move_east", "move_west"], ["move_west", "move_east"], ["move_south", "move_south"],
                 ["move_east", "move_west"], ["move_north", "move_north"], ["move_east", "move_west"],
                 ["move_south", "move_west"], ["move_west", "move_north"]],
    ),
    **{
        f"contested_moves_seed_{seed}": Scenario(
            map_data=[
                ["wall", "wall", "wall", "wall", "wall"],
                ["wall", "agent.agent", "empty", "agent.agent", "wall"],
                ["wall", "empty", "agent.agent", "empty", "wall"],
                ["wall", "wall", "wall", "wall", "wall"],
            ],
            num_agents=3,
            reference_shuffle=True,
            seed=seed,
            scripts=[["move_east", "move_west", "move_north"], ["move_south", "move_south", "move_east"],
                     ["move_east", "move_west", "move_west"], ["move_north", "move_north", "move_north"]],
        )
        for seed in (1, 7, 123, 99991)
    },
    # damage = max(0, weapon - armor) off the victim's health, attacker stays put.
    "attack_via_move_handler_lands": Scenario(
        map_data=COMBAT_MAP,
        num_agents=2,
        resources=COMBAT_RESOURCES,
        move_handlers=[ATTACK_HANDLER],
        inventories={0: {"laser": 5}, 1: {"armor": 2, "hp": 20}},
        reference_shuffle=True,
        scripts=[["change_vibe_swords", "noop"], ["move_east", "noop"], ["move_east", "noop"], ["noop", "noop"]],
    ),
    # damage = floor(7*50/100) - 2 = 1 per hit
    "attack_damage_multiplier_and_armor_absorb": Scenario(
        map_data=COMBAT_MAP,
        num_agents=2,
        resources=COMBAT_RESOURCES,
        move_handlers=[dict(ATTACK_HANDLER, direct_attack=dict(ATTACK_HANDLER["direct_attack"], pct=50))],
        inventories={0: {"laser": 7}, 1: {"armor": 2, "hp": 5}},
        reference_shuffle=True,
        scripts=[["change_vibe_swords", "noop"], ["move_east", "noop"], ["move_east", "noop"],
                 ["move_east", "noop"]],
    ),
    # Without the gating vibe the handler is skipped: a blocked move.
    "attack_requires_vibe_gate": Scenario(
        map_data=COMBAT_MAP,
        num_agents=2,
        resources=COMBAT_RESOURCES,
        move_handlers=[ATTACK_HANDLER],
        inventories={0: {"laser": 5}, 1: {"armor": 2, "hp": 20}},
        reference_shuffle=True,
        scripts=[["move_east", "noop"], ["move_east", "noop"]],
    ),
    "attack_both_directions_with_shuffle": Scenario(
        map_data=COMBAT_MAP,
        num_agents=2,
        resources=COMBAT_RESOURCES,
        move_handlers=[ATTACK_HANDLER],
        inventories={0: {"laser": 4, "armor": 1, "hp": 30}, 1: {"laser": 3, "armor": 2, "hp": 30}},
        reference_shuffle=True,
        scripts=[["change_vibe_swords", "change_vibe_swords"], ["move_east", "move_west"], ["move_east", "move_west"],
                 ["move_east", "move_west"], ["noop", "move_west"]],
    ),
    # AttackActionConfig contributes no actions in either engine: inert.
    "attack_action_config_is_inert": Scenario(
        map_data=COMBAT_MAP,
        num_agents=2,
        resources=COMBAT_RESOURCES + ["heart", "gold", "shield", "loot_bag"],
        attack={
            "vibes": ["swords"],
            "consumed_resources": {"laser": 1},
            "defense_resources": {"armor": 1},
            "weapon_resources": {"laser": 1},
            "armor_resources": {"shield": 2},
            "success": {
                "actor_inv_delta": {"loot_bag": 1},
                "target_inv_delta": {"heart": -1},
                "loot": ["gold"],
            },
        },
        inventories={0: {"laser": 3}, 1: {"heart": 2, "gold": 4}},
        reference_shuffle=True,
        scripts=[["change_vibe_swords", "noop"], ["move_east", "noop"], ["move_east", "noop"]],
    ),
    # Full token observations: global tokens, the window scan, walls,
    # agents and the mine, inventory tokens after a bump-use.
    "observation_tokens_match": Scenario(
        map_data=[
            ["wall", "wall", "wall", "wall", "wall"],
            ["wall", "agent.agent", "empty", "mine", "wall"],
            ["wall", "empty", "empty", "agent.agent", "wall"],
            ["wall", "wall", "wall", "wall", "wall"],
        ],
        num_agents=2,
        objects={"mine": {"kind": "mine", "gives": {"ore_red": 2}}},
        agent_rewards={"ore_red": 0.25},
        compare_obs=True,
        reference_shuffle=True,
        scripts=[["move_east", "noop"], ["move_east", "move_west"], ["move_south", "move_west"],
                 ["noop", "move_north"]],
    ),
    "change_vibe_and_noop": Scenario(
        map_data=[["wall", "wall", "wall"], ["wall", "agent.agent", "wall"], ["wall", "wall", "wall"]],
        num_agents=1,
        scripts=[["change_vibe_swords"], ["noop"], ["change_vibe_shield"], ["move_north"]],
    ),
    # Protocol feature ids are allocated and never emitted.
    "protocol_feature_ids_allocated_but_never_emitted": Scenario(
        map_data=MINE_ROOM,
        num_agents=1,
        objects={"mine": {"kind": "mine", "gives": {"ore_red": 1}}},
        compare_obs=True,
        scripts=[["move_east"], ["noop"]],
    ),
    # A mine pays 3 per use into a base-7 shared limit: 3, 6, 7, 7.
    "inventory_limit_clamp_cross_engine": Scenario(
        map_data=MINE_ROOM,
        num_agents=1,
        objects={"mine": {"kind": "mine", "gives": {"ore_red": 3}}},
        agent_rewards={"ore_red": 1.0},
        agent_limits={"ore": {"base": 7, "resources": ["ore_red"]}},
        scripts=[["move_east"]] * 4,
    ),
    # A modifier item raises the effective limit: gains 4, then 2.
    "modifier_raises_limit_cross_engine": Scenario(
        map_data=MINE_ROOM,
        num_agents=1,
        objects={"mine": {"kind": "mine", "gives": {"ore_red": 4}}},
        agent_limits={
            "ore": {"base": 5, "max": 20, "resources": ["ore_red"], "modifiers": {"blueprint": 6}}
        },
        inventories={0: {"blueprint": 1}},
        scripts=[["move_east"]] * 3,
    ),
    # No blocker: occupied cells are skipped but do not stop the ray.
    "raycast_spawn_skips_non_blockers_cross_engine": Scenario(
        map_data=RAY_MAP,
        num_agents=1,
        objects={"hub": {"kind": "plain"}, "crystal": {"kind": "plain"}},
        events=_bloom(),
        scripts=[["noop"], ["noop"]],
    ),
    # isA("wall") as a blocker: the ray stops at the wall.
    "raycast_spawn_blocker_stops_ray_cross_engine": Scenario(
        map_data=RAY_MAP,
        num_agents=1,
        objects={"hub": {"kind": "plain"}, "crystal": {"kind": "plain"}},
        events=_bloom(blocker_types=["wall"]),
        scripts=[["noop"], ["noop"]],
    ),
    "event_update_target_cross_engine": Scenario(
        map_data=[
            ["wall"] * 6,
            ["wall", "agent.agent", "shrine", "empty", "shrine", "wall"],
            ["wall"] * 6,
        ],
        num_agents=1,
        objects={"shrine": {"kind": "plain"}},
        events={
            "bless": {
                "target_type": "shrine",
                "timesteps": [1, 3],
                "mutations": [{"kind": "update_target", "deltas": {"heart": 2}}],
            }
        },
        scripts=[["noop"]] * 4,
    ),
}


# The seven arena families of tests/test_arena_parity.py: name -> (family
# options of parity.arena, steps, the JAX test's first (map seed, action
# seed) pair). tests/test_torch_arena_parity.py runs each on the CPU against
# the JAX package, and chip_smoke.py on the card against the CPU.
ARENA_FAMILIES = {
    "plain": ({}, 500, (0, 42)),
    "combat": ({"combat": True}, 500, (0, 5)),
    "economy": ({"economy": True}, 400, (0, 31)),
    "events": ({"events": True}, 300, (0, 13)),
    "tithe": ({"events": True, "random_query": True}, 300, (1, 29)),
    "direct_attack": ({"pure_attack": True}, 300, (2, 17)),
    "event_filter_rng": ({"events": True, "event_filter_rng": True}, 200, (2, 31)),
}
