"""The step's set-up verdicts, pinned program by program and kind by kind.

Every bench variant (tools/bench_run.VARIANTS, a pool of one map), every
cross-engine scenario and every arena family (tests/torch_parity_scenarios),
and the flagship arena with one construct more (a materialized query, an
on_after_use hook, an AOE without territory, a usable type) is compiled,
never stepped, and each set-up decision make_step takes for it
is held to a literal: the wave kinds (with and without the reference-RNG
step), the lazy grid and the lazy agent layer, the observations' static
background and static AOE mask (step.step_gates), graphs_ok on CUDA and on
the CPU, the pool fields the auto-reset merge keeps at a one-map pool and
the AOE presence bound (mutfields.maybe_written_pool_fields). Each mutation
kind's three answers (its pool fields, in a batch with and without the lazy
agent layer; whether it writes only the acting agent; whether it writes
only its target, an agent) are pinned too, the named cases included.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from mettagrid_tpu_torch.config.handler_config import AOEConfig, EntityTarget, Handler, ResourceDeltaMutation
from mettagrid_tpu_torch.config.query import Query, materializedQuery
from mettagrid_tpu_torch.config.tag import typeTag
from mettagrid_tpu_torch.engine import compile_program
from mettagrid_tpu_torch.engine.ir import CompiledMutation
from mettagrid_tpu_torch.engine.mutfields import (
    ACTOR_ONLY,
    POOL_FIELDS,
    TARGET_ONLY,
    lands_within,
    maybe_written_pool_fields,
    mutation_fields,
)
from mettagrid_tpu_torch.engine.step import graphs_ok, step_gates
from mettagrid_tpu_torch.parity import arena
from mettagrid_tpu_torch.parity.cross_engine import _Api, _build_config
from mettagrid_tpu_torch.tools import bench_run
from tests.torch_parity_scenarios import ARENA_FAMILIES, SCENARIOS

_PROGRAMS = {}


def _arena_with(extra: str):
    """The flagship config with one construct more."""
    cfg = bench_run.make_cfg("flagship")
    g = cfg.game
    gain = ResourceDeltaMutation(target=EntityTarget.TARGET, deltas={"heart": 1})
    if extra == "materialized":
        g.tags = ["near:wall"]
        g.materialize_queries = [materializedQuery("near:wall", Query(source=typeTag("wall")))]
    elif extra == "on_after_use":
        g.agent.on_after_use_handler = Handler(name="tip", mutations=[gain])
    elif extra == "aoe":
        g.objects["wall"].aoes["zap"] = AOEConfig(radius=1, mutations=[gain], presence_deltas={"armor": 1})
    else:
        g.objects["wall"].on_use_handler = Handler(name="poke", mutations=[gain])
    return cfg


def _program(name: str):
    """The compiled program of ``variant:<v>``, ``scenario:<s>``,
    ``family:<f>`` or ``arena_with:<extra>``."""
    if name not in _PROGRAMS:
        kind, key = name.split(":")
        if kind in ("variant", "arena_with"):
            cfg = bench_run.make_cfg(key) if kind == "variant" else _arena_with(key)
            program, _ = bench_run.build_pool(cfg, 1)
        elif kind == "scenario":
            cfg = _build_config(_Api(ours=True), SCENARIOS[key])
            if SCENARIOS[key].inventories:
                cfg.game.obs.full_token_bounds = True
            program = compile_program(cfg)
        else:
            family, _, (map_seed, _) = ARENA_FAMILIES[key]
            program = compile_program(arena.our_config(arena.arena_map(24, map_seed), 24, **family))
        _PROGRAMS[name] = program
    return _PROGRAMS[name]


PROGRAMS = (
    [f"variant:{v}" for v in bench_run.VARIANTS]
    + [f"scenario:{s}" for s in sorted(SCENARIOS)]
    + [f"family:{f}" for f in ARENA_FAMILIES]
    + [f"arena_with:{e}" for e in ("materialized", "on_after_use", "aoe", "usable")]
)


def _types(usable: bool = False, object_health: bool = False):
    """The type tables the mutation answers read: an agent type and an object
    type, with the object usable and starting with health (resource 0) as
    asked."""
    inv = np.zeros((2, 2), dtype=np.int32)
    inv[1, 0] = 5 if object_health else 0
    return SimpleNamespace(type_usable=np.array([False, usable]), type_is_agent=np.array([True, False]),
                           type_initial_inv=inv)


def _m(kind, **kw):
    return CompiledMutation(kind=kind, **kw)


# case: (program's type tables, mutation)
KIND_CASES = {
    "relocate": (_types(), _m("relocate")),
    "swap": (_types(), _m("swap")),
    "push_object": (_types(), _m("push_object")),
    "resource_delta_actor": (_types(), _m("resource_delta", target_is_actor=True)),
    "resource_delta_target": (_types(), _m("resource_delta")),
    "resource_transfer_actor": (_types(), _m("resource_transfer", from_is_actor=True, to_is_actor=True)),
    "resource_transfer_to_target": (_types(), _m("resource_transfer", from_is_actor=True)),
    "resource_transfer_target": (_types(), _m("resource_transfer")),
    "resource_transfer_removes": (_types(), _m("resource_transfer", from_is_actor=True, to_is_actor=True,
                                               remove_source_when_empty=True)),
    "clear_inventory_actor": (_types(), _m("clear_inventory", target_is_actor=True)),
    "clear_inventory_target": (_types(), _m("clear_inventory")),
    "attack": (_types(), _m("attack")),
    "direct_attack_no_object_health": (_types(), _m("direct_attack", health_rid=0)),
    "direct_attack_object_health": (_types(object_health=True), _m("direct_attack", health_rid=0)),
    "direct_attack_no_health": (_types(), _m("direct_attack")),
    "query_inventory": (_types(), _m("query_inventory")),
    "change_vibe_actor": (_types(), _m("change_vibe", target_is_actor=True)),
    "change_vibe_target": (_types(), _m("change_vibe")),
    "add_tag_actor": (_types(), _m("add_tag", target_is_actor=True)),
    "add_tag_target": (_types(), _m("add_tag")),
    "remove_tag_actor": (_types(), _m("remove_tag", target_is_actor=True)),
    "remove_tag_target": (_types(), _m("remove_tag")),
    "remove_tags_with_prefix_actor": (_types(), _m("remove_tags_with_prefix", target_is_actor=True)),
    "remove_tags_with_prefix_target": (_types(), _m("remove_tags_with_prefix")),
    "stats": (_types(), _m("stats")),
    "set_game_value_stat": (_types(), _m("set_game_value")),
    "set_game_value_inventory_actor": (_types(), _m("set_game_value", write_rid=0, target_is_actor=True)),
    "set_game_value_inventory_target": (_types(), _m("set_game_value", write_rid=0)),
    "use_target_nothing_usable": (_types(), _m("use_target")),
    "use_target_usable": (_types(usable=True), _m("use_target")),
    "spawn_object": (_types(), _m("spawn_object")),
    "raycast_spawn": (_types(), _m("raycast_spawn")),
    "recompute_materialized_query": (_types(), _m("recompute_materialized_query")),
    "unknown_kind": (_types(), _m("teleport")),
    "chain_actor_then_spawn": (_types(), _m("resource_delta", target_is_actor=True,
                                            on_success=(_m("spawn_object"),))),
    "chain_target_then_stats": (_types(), _m("add_tag", on_success=(_m("stats"),))),
}

# Shorthands of the field lists below: every object table, every pool field.
_SHORT = {"OBJ": "grid obj_alive obj_c obj_inv obj_r obj_tags obj_type obj_vibe", "POOL": " ".join(sorted(POOL_FIELDS))}
# The fields the step writes whatever the program.
_ALWAYS = frozenset({"game_stats", "agent_stats_touched", "visit_bitmap", "agent_action_prev_r", "agent_action_prev_c"})


def _fields(names: str) -> frozenset:
    return frozenset(" ".join(_SHORT.get(n, n) for n in names.split()).split())


# program: (verdicts, the merge's pool fields beside _ALWAYS at a one-map
# pool). Verdicts, one digit each: waves, pure-move waves | the same under
# the reference-RNG step | lazy grid, lazy agent layer | static background,
# static AOE mask | graphs_ok on CUDA, on the CPU | the AOE presence bound.
VERDICTS = {
    "variant:flagship": ("11 11 11 10 10 0", "obj_c obj_r"),
    "variant:combat": ("10 10 01 10 00 0", "obj_alive obj_c obj_inv obj_r obj_vibe"),
    "variant:general": ("10 10 01 00 00 0", "grid obj_alive obj_c obj_inv obj_r obj_vibe"),
    "variant:arena_lp": ("11 11 11 10 10 0", "obj_c obj_r"),
    "variant:arena_values": ("11 11 11 10 10 0", "obj_c obj_r"),
    "variant:general_lp": ("10 10 01 00 00 0", "grid obj_alive obj_c obj_inv obj_r obj_vibe"),
    "variant:arena_128": ("11 11 11 10 10 0", "obj_c obj_r"),
    "variant:territory": ("11 11 00 11 00 1", "grid obj_alive obj_c obj_inv obj_r"),
    "variant:flagship_v3": ("11 11 11 10 10 0", "obj_c obj_r"),
    "variant:arena_mood": ("11 11 00 00 00 0", "grid obj_c obj_r obj_vibe"),
    "variant:arena_mood_v3": ("11 11 00 00 00 0", "grid obj_c obj_r obj_vibe"),
    "variant:tithe_rrng": ("00 00 00 00 00 0", "grid obj_alive obj_c obj_inv obj_r"),
    "variant:full_combat": ("10 10 00 00 00 0", "grid obj_alive obj_c obj_inv obj_r obj_vibe"),
    "variant:network": ("00 00 00 00 00 0", "agent_cfg agent_group agent_spawn_c agent_spawn_r OBJ"),
    "variant:assembly_lines": ("11 11 11 10 10 0", "obj_c obj_r"),
    "variant:bsp_arena": ("11 11 11 10 10 0", "obj_c obj_r"),
    "scenario:attack_action_config_is_inert": ("11 11 11 10 10 0", "obj_c obj_r obj_vibe"),
    "scenario:attack_both_directions_with_shuffle": ("10 10 01 10 00 0", "obj_alive obj_c obj_inv obj_r obj_vibe"),
    "scenario:attack_damage_multiplier_and_armor_absorb": ("10 10 01 10 00 0", "obj_alive obj_c obj_inv obj_r obj_vibe"),
    "scenario:attack_requires_vibe_gate": ("10 10 01 10 00 0", "obj_alive obj_c obj_inv obj_r obj_vibe"),
    "scenario:attack_via_move_handler_lands": ("10 10 01 10 00 0", "obj_alive obj_c obj_inv obj_r obj_vibe"),
    "scenario:change_vibe_and_noop": ("11 11 11 10 10 0", "obj_c obj_r obj_vibe"),
    "scenario:contested_moves_reference_shuffle": ("11 11 11 10 10 0", "obj_c obj_r obj_vibe"),
    "scenario:contested_moves_seed_1": ("11 11 11 10 10 0", "obj_c obj_r obj_vibe"),
    "scenario:contested_moves_seed_123": ("11 11 11 10 10 0", "obj_c obj_r obj_vibe"),
    "scenario:contested_moves_seed_7": ("11 11 11 10 10 0", "obj_c obj_r obj_vibe"),
    "scenario:contested_moves_seed_99991": ("11 11 11 10 10 0", "obj_c obj_r obj_vibe"),
    "scenario:event_update_target_cross_engine": ("11 11 00 00 00 0", "grid obj_alive obj_c obj_inv obj_r obj_vibe"),
    "scenario:inventory_limit_clamp_cross_engine": ("10 10 01 00 00 0", "obj_alive obj_c obj_inv obj_r obj_vibe"),
    "scenario:mine_use_inventory_and_reward": ("10 10 01 00 00 0", "obj_alive obj_c obj_inv obj_r obj_vibe"),
    "scenario:modifier_raises_limit_cross_engine": ("10 10 01 00 00 0", "obj_alive obj_c obj_inv obj_r obj_vibe"),
    "scenario:observation_tokens_match": ("10 10 01 00 00 0", "obj_alive obj_c obj_inv obj_r obj_vibe"),
    "scenario:protocol_feature_ids_allocated_but_never_emitted": ("10 10 01 00 00 0", "obj_alive obj_c obj_inv obj_r obj_vibe"),
    "scenario:raycast_spawn_blocker_stops_ray_cross_engine": ("11 11 00 00 00 0", "OBJ"),
    "scenario:raycast_spawn_skips_non_blockers_cross_engine": ("11 11 00 00 00 0", "OBJ"),
    "scenario:single_agent_moves_and_walls": ("11 11 11 10 10 0", "obj_c obj_r obj_vibe"),
    "scenario:two_agents_disjoint_zones": ("11 11 11 10 10 0", "obj_c obj_r obj_vibe"),
    "family:plain": ("11 11 11 10 10 0", "obj_c obj_r"),
    "family:combat": ("10 10 00 00 00 0", "grid obj_alive obj_c obj_inv obj_r obj_vibe"),
    "family:economy": ("10 10 01 00 00 0", "obj_alive obj_c obj_inv obj_r"),
    "family:events": ("11 11 00 00 00 0", "grid obj_alive obj_c obj_inv obj_r"),
    "family:tithe": ("00 00 00 00 00 0", "grid obj_alive obj_c obj_inv obj_r"),
    "family:direct_attack": ("10 10 01 10 00 0", "obj_alive obj_c obj_inv obj_r obj_vibe"),
    "family:event_filter_rng": ("11 11 00 00 00 0", "grid obj_alive obj_c obj_inv obj_r"),
    "arena_with:materialized": ("11 11 00 00 10 0", "grid obj_c obj_r"),
    "arena_with:on_after_use": ("11 11 11 10 10 0", "grid obj_alive obj_c obj_inv obj_r"),
    "arena_with:aoe": ("11 11 00 10 00 1", "grid obj_alive obj_c obj_inv obj_r"),
    "arena_with:usable": ("10 10 01 00 00 0", "obj_alive obj_c obj_inv obj_r"),
}

# case: (pool fields in a batch, the same with a lazy agent layer, writes
# only the acting agent, writes only its target).
KINDS = {
    "relocate": ("grid obj_c obj_r", "obj_c obj_r", True, False),
    "swap": ("grid obj_c obj_r", "grid obj_c obj_r", True, False),
    "push_object": ("grid obj_c obj_r", "grid obj_c obj_r", False, False),
    "resource_delta_actor": ("grid obj_alive obj_inv", "obj_alive obj_inv", True, False),
    "resource_delta_target": ("grid obj_alive obj_inv", "obj_alive obj_inv", False, True),
    "resource_transfer_actor": ("grid obj_alive obj_inv", "obj_alive obj_inv", True, False),
    "resource_transfer_to_target": ("grid obj_alive obj_inv", "obj_alive obj_inv", False, False),
    "resource_transfer_target": ("grid obj_alive obj_inv", "obj_alive obj_inv", False, False),
    "resource_transfer_removes": ("grid obj_alive obj_inv", "grid obj_alive obj_inv", True, False),
    "clear_inventory_actor": ("grid obj_alive obj_inv", "obj_alive obj_inv", True, False),
    "clear_inventory_target": ("grid obj_alive obj_inv", "obj_alive obj_inv", False, True),
    "attack": ("grid obj_alive obj_inv", "obj_alive obj_inv", False, False),
    "direct_attack_no_object_health": ("grid obj_alive obj_inv", "obj_alive obj_inv", True, False),
    "direct_attack_object_health": ("grid obj_alive obj_inv", "obj_alive obj_inv", False, False),
    "direct_attack_no_health": ("grid obj_alive obj_inv", "obj_alive obj_inv", False, False),
    "query_inventory": ("grid obj_alive obj_inv", "obj_alive obj_inv", False, False),
    "change_vibe_actor": ("obj_vibe", "obj_vibe", True, False),
    "change_vibe_target": ("obj_vibe", "obj_vibe", False, True),
    "add_tag_actor": ("obj_tags", "obj_tags", True, False),
    "add_tag_target": ("obj_tags", "obj_tags", False, True),
    "remove_tag_actor": ("obj_tags", "obj_tags", True, False),
    "remove_tag_target": ("obj_tags", "obj_tags", False, True),
    "remove_tags_with_prefix_actor": ("obj_tags", "obj_tags", True, False),
    "remove_tags_with_prefix_target": ("obj_tags", "obj_tags", False, True),
    "stats": ("", "", True, True),
    "set_game_value_stat": ("", "", True, True),
    "set_game_value_inventory_actor": ("grid obj_alive obj_inv", "obj_alive obj_inv", True, False),
    "set_game_value_inventory_target": ("grid obj_alive obj_inv", "obj_alive obj_inv", False, True),
    "use_target_nothing_usable": ("", "", True, False),
    "use_target_usable": ("grid obj_alive obj_inv", "obj_alive obj_inv", False, False),
    "spawn_object": ("OBJ", "OBJ", False, False),
    "raycast_spawn": ("OBJ", "OBJ", False, False),
    "recompute_materialized_query": ("POOL", "POOL", False, False),
    "unknown_kind": ("POOL", "POOL", False, False),
    "chain_actor_then_spawn": ("OBJ", "OBJ", False, False),
    "chain_target_then_stats": ("obj_tags", "obj_tags", False, True),
}


def _bits(*flags) -> str:
    return "".join("1" if f else "0" for f in flags)


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_verdicts(name):
    """Every set-up verdict of the program, against the literals recorded
    from the predicates the write analysis replaced."""
    program = _program(name)
    gates = step_gates(program)
    rrng = step_gates(program, reference_rng=True)
    presence = any(spec.presence for spec in program.aoe_specs)
    got = " ".join([
        _bits(gates.waves, gates.pure_move),
        _bits(rrng.waves, rrng.pure_move),
        _bits(gates.lazy_grid, gates.lazy_agent_layer),
        _bits(gates.static_bg, gates.static_mask),
        _bits(graphs_ok(program, "cuda"), graphs_ok(program, "cpu")),
        _bits(presence and "obj_type" not in maybe_written_pool_fields(program)),
    ])
    verdicts, fields = VERDICTS[name]
    assert got == verdicts
    assert maybe_written_pool_fields(program, lazy_grid=gates.lazy_agent_layer) == _ALWAYS | _fields(fields)


@pytest.mark.parametrize("case", list(KIND_CASES))
def test_mutation_kind_answers(case):
    """Each kind's three answers, the named cases apart: set_game_value
    with and without an inventory write, use_target with and without a
    usable type, direct_attack with and without a non-agent's starting
    health, resource_transfer by its ends, and an unknown kind."""
    program, m = KIND_CASES[case]
    fields, lazy_fields, actor_only, target_only = KINDS[case]
    assert mutation_fields(program, m) == _fields(fields)
    assert mutation_fields(program, m, lazy=True) == _fields(lazy_fields)
    assert lands_within(program, m, ACTOR_ONLY) is actor_only
    assert lands_within(program, m, TARGET_ONLY) is target_only
