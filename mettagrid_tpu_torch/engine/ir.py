"""Compiled handler/value IR: config variants flattened to numeric tables.

The reference interprets config variants at runtime through std::variant
dispatch (core/filter_config.hpp:68-79, core/mutation_config.hpp:129-146,
core/game_value_config.hpp:49-77). Here every variant is compiled host-side
into one of these frozen dataclasses; the jitted step closes over them, so
the dispatch disappears into the XLA graph.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


# =====================================================================
# Game values (reference: core/game_value.cpp:14-120)
# =====================================================================


@dataclass(frozen=True)
class CompiledValue:
    """One game-value expression node.

    kinds: inventory | stat | const | sum | ratio | max | min
         | query_inventory | query_count
    """

    kind: str
    rid: int = -1  # inventory resource id
    stat_id: int = -1  # interned stat id (in the scope's table)
    stat_is_game: bool = False
    delta: bool = False  # stat delta mode (value - step-start snapshot)
    value: float = 0.0  # const
    weights: tuple[float, ...] = ()
    log: bool = False  # per-term log1p before weighting (game_value.cpp:88-96)
    clamp_min: Optional[float] = None  # extension: clamp after sum
    clamp_max: Optional[float] = None
    children: tuple["CompiledValue", ...] = ()
    query: Optional["CompiledQuery"] = None


# =====================================================================
# Queries (reference: core/query_config.hpp:41-79)
# =====================================================================


@dataclass(frozen=True)
class CompiledQuery:
    """Declarative object query, compiled.

    kinds: tag | filtered | closure | raycast
    """

    kind: str
    tag_id: int = -1
    filters: tuple["CompiledFilter", ...] = ()
    # closure: BFS from source seeds through candidate pool
    source: Optional["CompiledQuery"] = None
    candidates: Optional["CompiledQuery"] = None
    edge_filters: tuple["CompiledFilter", ...] = ()  # binary (actor=src, target=cand)
    max_hops: int = 8
    max_distance2: int = 2  # squared adjacency radius for closure edges
    # max_items: 0 = unlimited (static); max_items_value resolves at runtime
    # (query_config.hpp:25 GameValue max_items, -1 = unlimited)
    max_items: int = 0
    max_items_value: Optional["CompiledValue"] = None
    order_random: bool = False
    # compile-time-stable RNG salt so distinct order_by=random queries draw
    # independent (but build-deterministic) ranks from the per-env stream
    rng_salt: int = 0
    # raycast; max_range_value resolves the per-step range at runtime
    # (query_config.hpp:75 GameValue max_range), bounded by grid max(H, W)
    directions: tuple[int, ...] = ()
    include_blocker: bool = False
    max_range_value: Optional["CompiledValue"] = None


# =====================================================================
# Filters (reference: handler/filters/)
# =====================================================================


@dataclass(frozen=True)
class CompiledFilter:
    """One filter, flattened to numeric ids. kind is the config filter_type."""

    kind: str
    target_is_actor: bool = False
    vibe_id: int = 0
    tag_id: int = -1
    tag_mask: Optional[np.ndarray] = None  # bool[n_tags] for prefix filters
    resource_mins: tuple[tuple[int, int], ...] = ()  # (resource_id, min_amount)
    radius: int = 0
    inner: tuple["CompiledFilter", ...] = ()  # for or/not filters
    period: int = 1
    start_on: int = 0
    value: Optional[CompiledValue] = None  # game_value filter
    threshold: Optional[CompiledValue] = None
    query: Optional[CompiledQuery] = None  # max_distance unary / query_resource


# =====================================================================
# Mutations (reference: handler/mutations/)
# =====================================================================


@dataclass(frozen=True)
class CompiledMutation:
    """One mutation, flattened to numeric ids. kind is the config mutation_type."""

    kind: str
    target_is_actor: bool = False
    from_is_actor: bool = False
    to_is_actor: bool = False
    deltas: tuple[tuple[int, int], ...] = ()  # (resource_id, delta); -1 amount = all
    vibe_id: int = 0
    tag_id: int = -1
    tag_mask: Optional[np.ndarray] = None  # bool[n_tags] for prefix removal
    remove_source_when_empty: bool = False
    # attack (DSL semantics: config/mutation/attack_mutation.py)
    defense: tuple[tuple[int, int], ...] = ()  # (rid, amount)
    armor: tuple[tuple[int, int], ...] = ()  # (rid, weight)
    weapon: tuple[tuple[int, int], ...] = ()  # (rid, weight)
    vibe_bonus: Optional[np.ndarray] = None  # int32[n_vibes]
    vibe_matches_resource: Optional[np.ndarray] = None  # bool[n_vibes, R]
    on_success: tuple["CompiledMutation", ...] = ()
    # direct_attack (the C++-executable attack_mutation.hpp:16-42)
    weapon_rid: int = -1
    armor_rid: int = -1
    health_rid: int = -1
    damage_pct: int = 100
    # stats / set_game_value
    stat_id: int = -1
    stat_is_game: bool = False
    entity_is_actor: bool = False
    source: Optional[CompiledValue] = None
    delta_const: float = 0.0
    write_rid: int = -1  # set_game_value on an inventory item
    # clear_inventory: per-type member mask of the named limit group
    clear_mask: Optional[np.ndarray] = None  # bool[n_types, R]
    # spawn / raycast_spawn
    spawn_type_id: int = -1
    directions: tuple[int, ...] = ()
    max_range: int = 0
    max_range_value: Optional[CompiledValue] = None  # dynamic GameValue range
    blocker: tuple[CompiledFilter, ...] = ()
    # query_inventory
    query: Optional[CompiledQuery] = None
    transfer_mode: bool = False  # inverse deltas hit the source entity
    transfer_stats: tuple[tuple[int, int], ...] = ()  # (rid, game_stat_id)


@dataclass(frozen=True)
class CompiledHandler:
    """Filter chain + mutation chain (reference: handler/handler.hpp:30-55)."""

    name: str
    filters: tuple[CompiledFilter, ...]
    mutations: tuple[CompiledMutation, ...]


@dataclass(frozen=True)
class CompiledMultiHandler:
    """FirstMatch or All dispatch over children
    (reference: handler/multi_handler.hpp:24-49)."""

    handlers: tuple["AnyCompiledHandler", ...]
    first_match: bool = True


AnyCompiledHandler = CompiledHandler | CompiledMultiHandler


@dataclass(frozen=True)
class CompiledMoveHandler:
    """A handler in the move chain plus its line-scan parameters
    (reference: actions/move.hpp:26-46)."""

    handler: CompiledHandler
    max_range: int = 1
    accepts_empty: bool = False


@dataclass(frozen=True)
class CompiledAOE:
    """One (object type, AOE config) pair
    (reference: handler/handler_config.hpp:57-65 AOEConfig)."""

    name: str
    type_id: int
    radius: int
    is_static: bool
    effect_self: bool
    presence: tuple[tuple[int, int], ...]  # (rid, delta) on enter/exit
    filters: tuple[CompiledFilter, ...]
    mutations: tuple[CompiledMutation, ...]


@dataclass(frozen=True)
class CompiledTerritory:
    """One game-level territory type
    (reference: handler/territory_config.hpp:10-22)."""

    name: str
    prefix_tag_ids: tuple[int, ...]  # tag ids under the prefix, ascending
    type_strength: np.ndarray  # int32[n_types] influence strength (0 = no control)
    type_decay: np.ndarray  # int32[n_types]
    on_enter: Optional[CompiledHandler] = None
    on_exit: Optional[CompiledHandler] = None
    presence: Optional[CompiledHandler] = None


@dataclass(frozen=True)
class CompiledEvent:
    """Clock-triggered handler (reference: handler/event_scheduler.hpp:31-62,
    src/.../handler/event.cpp:34-63)."""

    name: str
    handler: CompiledHandler
    target_query: CompiledQuery
    timesteps: tuple[int, ...]
    max_targets: int = 0  # 0 = unlimited
    fallback: int = -1  # event index, -1 = none
    stat_id: int = -1  # game stat "event.<name>" id


@dataclass(frozen=True)
class CompiledRewardEntry:
    """One reward entry (reference: systems/reward.hpp:55-78)."""

    value: CompiledValue
    accumulate: bool


def reaches(root, pred: Callable) -> bool:
    """True when ``pred`` holds for a node reachable from ``root`` through
    dataclass fields, lists, tuples and dicts (a compiled program, handler,
    query, ...); arrays, strings and numbers are leaves."""
    seen = set()

    def walk(node) -> bool:
        if node is None or isinstance(node, (str, bytes, int, float, np.ndarray)) or id(node) in seen:
            return False
        seen.add(id(node))
        if pred(node):
            return True
        if isinstance(node, dict):
            node = list(node.values())
        if isinstance(node, (list, tuple)):
            return any(walk(x) for x in node)
        if dataclasses.is_dataclass(node):
            return any(walk(getattr(node, f.name)) for f in dataclasses.fields(node))
        return False

    return walk(root)
