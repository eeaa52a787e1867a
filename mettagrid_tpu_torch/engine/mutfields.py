"""Static analysis: what can this program's phases write, and on which objects?

One table classifies each mutation kind (the pool-reset fields it writes,
and where they land); one function, mutation_sites, lists the program's
mutation sites, each with its context. From both:

* maybe_written_pool_fields: the pool-reset fields any step phase can
  write. With a single pooled map (P == 1) every env's fresh value for a
  pool field IS the template row, which is also the value the field was
  initialized with; a field no phase can write merges as the identity, so
  step.make_step's auto-reset merge skips it (the r5 merge measured
  ~0.49 ms/step at E=4096, mostly bandwidth over fields like `grid` and
  `obj_inv` that pure-move programs never touch). aoe.make_aoe_phase bounds
  every spec's sources from the pool where no phase writes `obj_type`.
* static_background and static_mask: the observations' pooled background
  and AOE-mask source (obs.build_static_bg, obs.build_static_mask).

step.py combines them with the action phase's own gates (actions_fast) and
reads mutation_sites for the phases whose loops read the host (graphs_ok).

Soundness contract: the table is a WHITELIST. A kind not listed writes
every pool field on any object; a new kind that writes state must be
classified below or accept that. tests/test_torch_program_analysis.py pins
each kind's answers and each program's verdicts.

Caveat (documented, not load-bearing today): the merge skip assumes nothing
OUTSIDE the compiled step writes skipped fields between steps. The only
host-mutation surface (simulator.set_inventory) lives on Simulation, which
builds its step with auto_reset=False and therefore never takes this path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from mettagrid_tpu_torch.engine.ir import CompiledHandler
from mettagrid_tpu_torch.engine.program import EngineProgram

# The candidate set — must mirror step._POOL_RESET_FIELDS (asserted there).
POOL_FIELDS = frozenset(
    {
        "grid", "obj_type", "obj_r", "obj_c", "obj_vibe", "obj_tags",
        "obj_inv", "obj_alive", "agent_group", "agent_cfg", "agent_spawn_r",
        "agent_spawn_c", "agent_action_prev_r", "agent_action_prev_c",
        "agent_stats_touched", "visit_bitmap", "game_stats",
    }
)

# Written unconditionally by the step itself, independent of config:
# game_stats (token accounting each obs pass), visit_bitmap + the touched
# masks (coverage / action success-fail stats), and the action-move
# last-position records. All small; never worth proving otherwise.
_ALWAYS_MUTABLE = frozenset(
    {
        "game_stats", "agent_stats_touched", "visit_bitmap",
        "agent_action_prev_r", "agent_action_prev_c",
    }
)

# agent_group / agent_cfg / agent_spawn_r / agent_spawn_c have no engine
# write site at all (per-map constants, init-only): no classification below
# ever produces them, so any program with a single pooled map skips them.

# The grid's agent layer: relocate's vacate/occupy and the remove-when-empty
# cell clear honor Ctx.lazy_grid, so a batch under the lazy grid or the
# gridless batch skips them. Anywhere else they write `grid`.
AGENT_LAYER = "agent_layer"
_MOVE_FIELDS = frozenset({"obj_r", "obj_c", "grid"})
# Inventory writes can cascade to object removal (remove_when_empty clears
# the object AND its grid cell — handlers.py clear path), so they taint
# aliveness and the grid's agent layer conservatively.
_INV_FIELDS = frozenset({"obj_inv", "obj_alive", AGENT_LAYER})
_OBJ_FIELDS = frozenset({"grid", "obj_type", "obj_r", "obj_c", "obj_vibe", "obj_tags", "obj_inv", "obj_alive"})

# Where a kind's writes land. NOWHERE: no object (stats are agent/game
# arrays, never object tokens). ACTOR, TARGET: that entity alone. ENTITY:
# the actor where target_is_actor, else the target. AGENTS: agents alone,
# by an argument made for an action, whose actor is the acting agent. ANY:
# any object.
NOWHERE, ACTOR, TARGET, ENTITY, AGENTS, ANY = "nowhere", "actor", "target", "entity", "agents", "any"
# What a context admits. ACTOR_ONLY: only agents, from an action (the actor
# is the acting agent). TARGET_ONLY: only the target, from an AOE or a
# territory, where the target is always an agent (aoe.py, territory.py) and
# the actor is the AOE's source or the territory's proxy.
ACTOR_ONLY, TARGET_ONLY = (NOWHERE, ACTOR, AGENTS), (NOWHERE, TARGET)

_KINDS = {
    "relocate": (frozenset({"obj_r", "obj_c", AGENT_LAYER}), ACTOR),
    "swap": (_MOVE_FIELDS, AGENTS),  # no-ops unless BOTH entities are agents (handlers.py:119-128)
    "push_object": (_MOVE_FIELDS, ANY),
    "resource_delta": (_INV_FIELDS, ENTITY),
    "clear_inventory": (_INV_FIELDS, ENTITY),
    "attack": (_INV_FIELDS, ANY),  # legacy loot/defense transfers
    "query_inventory": (_INV_FIELDS, ANY),
    "change_vibe": (frozenset({"obj_vibe"}), ENTITY),
    "add_tag": (frozenset({"obj_tags"}), ENTITY),
    "remove_tag": (frozenset({"obj_tags"}), ENTITY),
    "remove_tags_with_prefix": (frozenset({"obj_tags"}), ENTITY),
    "stats": (frozenset(), NOWHERE),  # game/agent stat tables are _ALWAYS_MUTABLE
    "spawn_object": (_OBJ_FIELDS, ANY),
    "raycast_spawn": (_OBJ_FIELDS, ANY),
    # recompute_materialized_query rewrites query caches carried in state;
    # treat as fully tainting until someone needs the precision.
    "recompute_materialized_query": (POOL_FIELDS, ANY),
}


def _writes(program: EngineProgram, m) -> tuple:
    """(pool fields, where they land) of ``m`` alone, its on_success chain
    aside; the fields may name AGENT_LAYER."""
    k = m.kind
    if k == "set_game_value":
        # A stat write is covered by _ALWAYS_MUTABLE; an inventory write
        # (write_rid >= 0) lands on the entity.
        fields, lands = (_INV_FIELDS, ENTITY) if m.write_rid >= 0 else (frozenset(), NOWHERE)
    elif k == "use_target":
        # The always-appended default UseTarget handler
        # (action_handler_factory.cpp:33-45) fires a usable target type's
        # on_use chain, a site of its own; with no usable type it provably
        # no-ops, from an action.
        fields, lands = (_INV_FIELDS, ANY) if np.asarray(program.type_usable).any() else (frozenset(), AGENTS)
    elif k == "direct_attack":
        # Writes only the TARGET's health (decrement-only, clamped at 0 —
        # handlers.py direct_attack). A non-agent target's health therefore
        # never changes IF no non-agent starts with any: within a program
        # whose actions write only agents nothing else can grant inventory
        # to a non-agent, so health stays 0 -> zero-valued writes -> tokens
        # unchanged. (Maps bind cells to types; initial inventory is
        # per-type — engine/init.py.)
        non_agent = ~np.asarray(program.type_is_agent)
        inert = m.health_rid >= 0 and not np.asarray(program.type_initial_inv)[non_agent, m.health_rid].any()
        fields, lands = _INV_FIELDS, AGENTS if inert else ANY
    elif k == "resource_transfer":
        # remove_source_when_empty clears a non-agent source's cell even
        # under the lazy grid.
        fields = _INV_FIELDS | {"grid"} if m.remove_source_when_empty else _INV_FIELDS
        lands = ACTOR if m.from_is_actor and m.to_is_actor else ANY
    else:
        fields, lands = _KINDS.get(k, (POOL_FIELDS, ANY))  # unknown kind => all, anywhere
    if lands == ENTITY:
        lands = ACTOR if m.target_is_actor else TARGET
    return fields, lands


def _grid(fields, lazy: bool) -> frozenset:
    """``fields`` with the agent layer skipped (``lazy``) or written as `grid`."""
    if AGENT_LAYER not in fields:
        return frozenset(fields)
    return frozenset(fields - {AGENT_LAYER}) | (frozenset() if lazy else {"grid"})


def mutation_fields(program: EngineProgram, m, lazy: bool = False) -> frozenset:
    """The pool fields ``m`` and its on_success chain can write, run by a
    batch whose agent layer is lazy where ``lazy``."""
    out = set(_writes(program, m)[0])
    for s in m.on_success:
        out |= mutation_fields(program, s, lazy)
    return _grid(out, lazy)


def lands_within(program: EngineProgram, m, admitted) -> bool:
    """True when ``m`` and its on_success chain write only where ``admitted``
    (ACTOR_ONLY or TARGET_ONLY) lets them."""
    return _writes(program, m)[1] in admitted and all(
        lands_within(program, s, admitted) for s in m.on_success)


# A mutation site's context: where it runs, and so who its actor is.
MOVE = "move"  # move handlers, and change_vibe's action streams
ON_USE = "on_use"  # a target type's on_use chain, fired by UseTarget
ON_AFTER_USE = "on_after_use"  # an agent config's hook after a use succeeded
AGENT_TICK, GAME_TICK, EVENT, AOE = "agent_tick", "game_tick", "event", "aoe"
TERRITORY = "territory"  # a territory's enter, exit and presence handlers
MATERIALIZED = "materialized"  # a materialized query's tags, computed at reset
BATCH = (MOVE, ON_USE)  # the action batch, whose agent layer may be lazy


class Site(NamedTuple):
    """A mutation site: its context, the mutations it can run (each with its
    on_success chain), and what it writes outside any mutation."""

    context: str
    mutations: tuple = ()
    fields: frozenset = frozenset()
    lands: str = NOWHERE


def _mutations(h) -> tuple:
    if h is None:
        return ()
    if isinstance(h, CompiledHandler):
        return tuple(h.mutations)
    return sum((_mutations(c) for c in h.handlers), ())


def mutation_sites(program: EngineProgram) -> list:
    """Every mutation site of the program: one per move handler, on_use and
    on_after_use chain, agent on_tick, game on_tick, event, AOE spec,
    territory and materialized query."""
    sites = [Site(MOVE, _mutations(mh.handler)) for mh in program.move_handlers]
    if any(n.startswith("change_vibe") for n in program.action_names):
        sites.append(Site(MOVE, fields=frozenset({"obj_vibe"}), lands=ACTOR))
    for context, handlers in ((ON_USE, program.on_use_handlers), (ON_AFTER_USE, program.on_after_use_handlers),
                              (AGENT_TICK, program.on_tick_handlers), (GAME_TICK, (program.game_on_tick,))):
        sites += [Site(context, _mutations(h)) for h in handlers if h is not None]
    sites += [Site(EVENT, _mutations(ev.handler)) for ev in program.events]
    # Presence deltas change the agents' inventories.
    sites += [Site(AOE, spec.mutations, _INV_FIELDS if spec.presence else frozenset(), TARGET)
              for spec in program.aoe_specs]
    sites += [Site(TERRITORY, sum((_mutations(h) for h in (t.on_enter, t.on_exit, t.presence)), ()))
              for t in program.territories]
    # Materialized tags are computed at reset, where the merge's template
    # holds them; a step recomputes them only by recompute_materialized_query.
    sites += [Site(MATERIALIZED) for _ in program.materialized]
    return sites


def maybe_written_pool_fields(program: EngineProgram, lazy_grid: bool = False) -> frozenset:
    """Upper bound on the pool-reset fields any step phase can write.

    lazy_grid: batch contexts (move waves + their on_use chains) skip every
    agent-layer grid write — the pure-move lazy invariant or the gridless
    batch (actions_fast.gridless_batch_ok). Only BATCH-site grid taint is
    discarded; events/ticks/AOE keep writing the grid's static layer and
    keep it in the merge.
    """
    out = set(_ALWAYS_MUTABLE)
    for site in mutation_sites(program):
        lazy = lazy_grid and site.context in BATCH
        out |= _grid(site.fields, lazy)
        for m in site.mutations:
            out |= mutation_fields(program, m, lazy)
    return frozenset(out & POOL_FIELDS)


def _writes_within(program: EngineProgram, site: Site, admitted) -> bool:
    return (not site.fields or site.lands in admitted) and all(
        lands_within(program, m, admitted) for m in site.mutations)


def static_background(program: EngineProgram, pure_move: bool) -> bool:
    """True when every non-agent object is provably inert for the whole
    episode — tokens, position, and aliveness can never change — so its cell
    image can be precomputed once per pooled map and gathered per env.

    Sufficient conditions: no usable type (UseTarget could fire on_use
    chains at objects; without one, no on_use or on_after_use chain runs);
    every move handler writes only agents — pure relocation (``pure_move``,
    the action phase's actions_fast.pure_move_ok) or ACTOR_ONLY writes
    (e.g. vibe-gated DirectAttack arenas qualify); every AOE spec and every
    territory TARGET_ONLY (AOE presence deltas land on agents too); and no
    events / on_tick handlers / materialized queries. The JAX engine's
    gate refuses any AOE or territory; the port widens it here.
    """
    if np.asarray(program.type_usable).any():
        return False
    for site in mutation_sites(program):
        if site.context == MOVE:
            ok = pure_move or _writes_within(program, site, ACTOR_ONLY)
        elif site.context in (AOE, TERRITORY):
            ok = _writes_within(program, site, TARGET_ONLY)
        else:
            ok = site.context in (ON_USE, ON_AFTER_USE)
        if not ok:
            return False
    return True


def has_aoe_mask(program: EngineProgram) -> bool:
    """The observations carry the AOE mask."""
    return program.feature_ids.aoe_mask != 0 and bool(program.territories)


def static_mask(program: EngineProgram, static_bg: bool) -> bool:
    """True when each cell's AOE-mask source, its winning territory tag, is
    a function of the pooled map alone: the observations carry the mask,
    the background is static (``static_bg``) and no agent type has
    territory strength, so every emitter is an inert object."""
    is_agent = np.asarray(program.type_is_agent, dtype=bool)
    return has_aoe_mask(program) and static_bg and not any(
        (np.asarray(t.type_strength)[is_agent] > 0).any() for t in program.territories)
