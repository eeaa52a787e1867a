"""Static analysis: which pool-reset state fields can this program write?

Used by the auto-reset merge in step.make_step: with a single pooled map
(P == 1) every env's fresh value for a pool field IS the template row, which
is also the value the field was initialized with. If NO phase of the
compiled program can ever write the field, current == initial == fresh, so
the per-step masked-select merge for it is the identity and is skipped
entirely (the r5 merge measured ~0.49 ms/step at E=4096 — mostly bandwidth
over fields like `grid` and `obj_inv` that pure-move programs never touch).

Soundness contract (same shape as obs._mutation_bg_inert): this is a
WHITELIST. A mutation kind not listed here marks EVERY pool field mutable —
adding a new kind that writes state must either be classified below or
accept the conservative default. tests/test_merge_skip.py pins both the
classification and step-level bit-equivalence across reset boundaries.

Caveat (documented, not load-bearing today): the skip assumes nothing
OUTSIDE the compiled step writes skipped fields between steps. The only
host-mutation surface (simulator.set_inventory) lives on Simulation, which
builds its step with auto_reset=False and therefore never takes this path.
"""

from __future__ import annotations

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

_OBJ_FIELDS = frozenset(
    {"grid", "obj_type", "obj_r", "obj_c", "obj_vibe", "obj_tags", "obj_inv", "obj_alive"}
)
# Inventory writes can cascade to object removal (remove_when_empty clears
# the object AND its grid cell — handlers.py clear path), so they taint
# aliveness and the grid conservatively.
_INV_FIELDS = frozenset({"obj_inv", "obj_alive", "grid"})
_MOVE_FIELDS = frozenset({"obj_r", "obj_c", "grid"})

_MUTATION_FIELDS = {
    "relocate": _MOVE_FIELDS,
    "swap": _MOVE_FIELDS,
    "push_object": _MOVE_FIELDS,
    "resource_delta": _INV_FIELDS,
    "resource_transfer": _INV_FIELDS,
    "clear_inventory": _INV_FIELDS,
    "attack": _INV_FIELDS,
    "direct_attack": _INV_FIELDS,
    "query_inventory": _INV_FIELDS,
    "change_vibe": frozenset({"obj_vibe"}),
    "add_tag": frozenset({"obj_tags"}),
    "remove_tag": frozenset({"obj_tags"}),
    "remove_tags_with_prefix": frozenset({"obj_tags"}),
    "stats": frozenset(),  # game/agent stat tables are _ALWAYS_MUTABLE
    "spawn_object": _OBJ_FIELDS,
    "raycast_spawn": _OBJ_FIELDS,
    # recompute_materialized_query rewrites query caches carried in state;
    # treat as fully tainting until someone needs the precision.
    "recompute_materialized_query": POOL_FIELDS,
}
# Kinds whose only grid taint is the batch-skippable agent-layer write
# (relocate vacate/occupy, remove-when-empty cell clear — both honor
# Ctx.lazy_grid). set_game_value/use_target resolve their base dynamically,
# so they are listed here rather than matched on `base`.
_INV_KINDS = frozenset(
    k for k, v in _MUTATION_FIELDS.items() if v is _INV_FIELDS
) | frozenset({"set_game_value", "use_target"})


def _mutation_fields(m, any_usable: bool = True, lazy: bool = False) -> frozenset:
    base = _MUTATION_FIELDS.get(m.kind, POOL_FIELDS)  # unknown kind => all
    if m.kind == "set_game_value":
        # A stat write is covered by _ALWAYS_MUTABLE; an inventory write
        # (write_rid >= 0) taints the inventory family.
        base = _INV_FIELDS if getattr(m, "write_rid", -1) >= 0 else frozenset()
    elif m.kind == "use_target":
        # The always-appended default UseTarget handler can only fire a
        # target type's on_use chain (walked separately); with no usable
        # types it provably no-ops (same argument as obs._mutation_bg_inert).
        base = _INV_FIELDS if any_usable else frozenset()
    removes_object = m.kind == "resource_transfer" and m.remove_source_when_empty
    if lazy and (m.kind == "relocate" or base is _INV_FIELDS or m.kind in _INV_KINDS) and not removes_object:
        # Batch contexts under the lazy/gridless gates skip every
        # agent-layer grid write (relocate honors Ctx.lazy_grid); swap/push
        # keep theirs and stay tainting, and so does remove-when-empty,
        # which clears a non-agent source's cell even there.
        base = base - {"grid"}
    out = set(base)
    for s in getattr(m, "on_success", ()) or ():
        out |= _mutation_fields(s, any_usable, lazy)
    return frozenset(out)


def _handler_fields(h, any_usable: bool = True, lazy: bool = False) -> frozenset:
    if h is None:
        return frozenset()
    if isinstance(h, CompiledHandler):
        out = set()
        for m in h.mutations:
            out |= _mutation_fields(m, any_usable, lazy)
        return frozenset(out)
    out = set()
    for c in getattr(h, "handlers", ()):
        out |= _handler_fields(c, any_usable, lazy)
    return frozenset(out)


def maybe_written_pool_fields(program: EngineProgram, lazy_grid: bool = False) -> frozenset:
    """Upper bound on the pool-reset fields any step phase can write.

    lazy_grid: batch contexts (move waves + their on_use chains) skip every
    agent-layer grid write — the pure-move lazy invariant or the gridless
    batch (actions_fast.gridless_batch_ok). Only BATCH-site grid taint is
    discarded; events/ticks/AOE keep writing the grid's static layer and
    keep it in the merge.
    """
    import numpy as np

    any_usable = bool(np.asarray(program.type_usable).any())
    out = set(_ALWAYS_MUTABLE)
    # Batch sites: move handlers + on_use chains fired from them.
    for mh in program.move_handlers:
        out |= _handler_fields(mh.handler, any_usable, lazy_grid)
    for h in program.on_use_handlers or ():
        out |= _handler_fields(h, any_usable, lazy_grid)
    # Non-batch sites: grid writes are never skipped there.
    sites = list(program.on_tick_handlers or ())
    sites += list(getattr(program, "on_after_use_handlers", ()) or ())
    sites += [getattr(program, "game_on_tick", None)]
    sites += [ev.handler for ev in (program.events or ())]
    # Territory enter / exit / presence handlers run mutations too (an
    # inventory income, an armor change on entry).
    for spec in program.territories or ():
        sites += [spec.on_enter, spec.on_exit, spec.presence]
    for h in sites:
        out |= _handler_fields(h, any_usable)
    for spec in program.aoe_specs or ():
        for m in spec.mutations:
            out |= _mutation_fields(m, any_usable)
        if spec.presence:  # presence deltas change the agents' inventories
            out |= _INV_FIELDS
    # change_vibe ACTION streams write agent vibes outside any handler.
    if any(n.startswith("change_vibe") for n in program.action_names):
        out.add("obj_vibe")
    return frozenset(out & POOL_FIELDS)
