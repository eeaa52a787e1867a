"""Vectorized handler execution: filters give bool masks, mutations give
masked updates.

Counterpart of the reference's engine/handlers.py. The reference interprets
handler chains per object (cpp/src/mettagrid/handler/handler.cpp:76-93
try_apply: all filters pass, then mutations apply in order until one fails);
here a handler runs for a whole batch at once. Mutations that can fail
(use_target, push_object, spawn_object) return per-entry ok masks. Every
function works out of place.
"""

from __future__ import annotations

import numpy as np
import torch

from mettagrid_tpu_torch.engine.exec import (
    Ctx,
    _env_gate,
    agent_slot_ok,
    device_table,
    eval_filters,
    eval_query_mask,
    eval_value,
    gather,
    grid_read,
    grid_write,
    inv_enforce_limits,
    inv_update,
    scatter,
    type_select,
)
from mettagrid_tpu_torch.engine.ir import CompiledHandler, CompiledMultiHandler, CompiledValue
from mettagrid_tpu_torch.engine.program import AMOUNT_STAT_BASE, AUTO_STAT_BASE, DIR_DC, DIR_DR

_I32 = torch.int32


def _agent_rows(program, slot, rows, mask, dense_identity, actor_prefix):
    """Route per-entry [B, R] rows to per-agent [E, A, R] rows (slots are
    unique per call, so at most one entry lands on an agent)."""
    A = program.num_agents
    if dense_identity or actor_prefix:
        # The slot is the identity over its axis; agents are the first A lanes.
        return torch.where(mask[:, :A, None], rows[:, :A], 0)
    E = slot.shape[0]
    s2 = slot.reshape(E, -1)
    ok = (mask & agent_slot_ok(slot, A)).reshape(s2.shape)
    rows2 = torch.where(ok[..., None], rows.reshape(s2.shape + (-1,)), 0)
    oh = (s2[..., None] == torch.arange(A, dtype=_I32, device=slot.device)) & ok[..., None]  # [E, K, A]
    return torch.where(oh[..., None], rows2[:, :, None, :], 0).sum(dim=1, dtype=rows.dtype)


class InvStatBatch:
    """Inventory-stat emissions of one wave batch, accumulated per agent and
    applied to auto_stats once (flush_inv_stat_batch). The reference keeps
    this in a module global scoped by try/finally (handlers._INV_BATCH); here
    the batch rides the wave's Ctx. Valid only while no filter or value in
    the batch reads an auto-stat lane (inv_stat_batch_ok): the reference
    applies writes at once."""

    __slots__ = ("g", "l", "dep", "death")

    def __init__(self):
        self.g = self.l = self.dep = self.death = None


def flush_inv_stat_batch(program, state, batch):
    """Apply a batch's accumulated emissions as one auto_stats update."""
    if batch is None or (batch.g is None and batch.dep is None and batch.death is None):
        return state
    R = program.num_resources
    au = state.auto_stats.clone()
    if batch.g is not None:
        au[..., 0 : 2 * R] += torch.cat([batch.g, batch.l], dim=-1)
    if batch.dep is not None:
        au[..., 2 * R : 3 * R] += batch.dep
    if batch.death is not None:
        au[..., 3 * R] += batch.death
    return state._replace(auto_stats=au)


def _ir_reads_auto(node, seen) -> bool:
    """Walk compiled IR for a game-value leaf that reads an auto-stat lane."""
    if node is None or id(node) in seen:
        return False
    seen.add(id(node))
    if isinstance(node, CompiledValue):
        if node.kind == "stat" and not node.stat_is_game and AUTO_STAT_BASE <= node.stat_id < AMOUNT_STAT_BASE:
            return True
        return any(_ir_reads_auto(c, seen) for c in node.children)
    if isinstance(node, (list, tuple)):
        return any(_ir_reads_auto(x, seen) for x in node)
    if hasattr(node, "__dataclass_fields__"):
        return any(_ir_reads_auto(getattr(node, f), seen) for f in node.__dataclass_fields__)
    return False


def inv_stat_batch_ok(program, handlers_to_scan) -> bool:
    """True when emissions inside these handlers may be batched: compact
    stat storage and no auto-lane Stat read in their filters and values."""
    return bool(program.stats_compact) and not any(
        _ir_reads_auto(h, set()) for h in handlers_to_scan if h is not None
    )


def emit_inv_stats(program, state, slot, delta_rows, new_rows, mask,
                   dense_identity=False, actor_prefix=False, batch=None):
    """Auto-emitted inventory stats on an agent inventory change (reference:
    Agent::on_inventory_change, objects/agent.cpp:100-120): per resource,
    ".gained"/".lost" accumulate the clamped actual deltas, and "death"
    counts when the "hp" resource is driven to 0 by a negative delta. With
    compact stat storage these are auto_stats lanes and ".amount" is derived
    from the live inventory at export; without it they are agent_stats
    entries, and ".amount" is set to the new amount where the delta is not 0,
    with its touched bit (the key then exports even at 0). Only agent slots
    emit.

    delta_rows/new_rows: [B, R] actual deltas and resulting amounts."""
    R = program.num_resources
    if R == 0:
        return state
    if not program.stats_compact:
        return _emit_inv_stats_full(program, state, slot, delta_rows, new_rows, mask, dense_identity, actor_prefix)
    hp = program.hp_rid
    rows = delta_rows
    if hp >= 0:
        rows = torch.cat([delta_rows, new_rows[..., hp : hp + 1]], dim=-1)
    routed = _agent_rows(program, slot, rows, mask, dense_identity, actor_prefix)
    if routed.shape[1] == 0:
        return state
    d = routed[..., :R]
    died = ((d[..., hp] < 0) & (routed[..., R] == 0)).to(_I32) if hp >= 0 else None
    g, l = d.clamp(min=0), (-d).clamp(min=0)
    if batch is not None:
        batch.g = g if batch.g is None else batch.g + g
        batch.l = l if batch.l is None else batch.l + l
        if died is not None:
            batch.death = died if batch.death is None else batch.death + died
        return state
    au = state.auto_stats.clone()
    au[..., 0 : 2 * R] += torch.cat([g, l], dim=-1)
    if died is not None:
        au[..., 3 * R] += died
    return state._replace(auto_stats=au)


def _emit_inv_stats_full(program, state, slot, delta_rows, new_rows, mask, dense_identity, actor_prefix):
    """emit_inv_stats into agent_stats, for programs without compact stat
    storage (reference handlers.py:213-233)."""
    R = program.num_resources
    d = _agent_rows(program, slot, delta_rows, mask, dense_identity, actor_prefix)
    if d.shape[1] == 0:
        return state
    n = _agent_rows(program, slot, new_rows, mask, dense_identity, actor_prefix)
    changed = d != 0  # [E, A, R]
    g0, l0, a0 = (int(ids[0]) for ids in (program.stat_inv_gained, program.stat_inv_lost, program.stat_inv_amount))
    stats = state.agent_stats.clone()
    fd = d.to(stats.dtype)
    stats[..., g0 : g0 + R] += fd.clamp(min=0)
    stats[..., l0 : l0 + R] += (-fd).clamp(min=0)
    stats[..., a0 : a0 + R] = torch.where(changed, n.to(stats.dtype), stats[..., a0 : a0 + R])
    touched = state.agent_stats_touched.clone()
    touched[..., a0 : a0 + R] |= changed
    hp = program.hp_rid
    if hp >= 0:
        stats[..., program.stat_death] += ((d[..., hp] < 0) & (n[..., hp] == 0)).to(stats.dtype)
    return state._replace(agent_stats=stats, agent_stats_touched=touched)


def entity_inv_update(program, state, slot, rid: int, delta, mask,
                      dense_identity=False, actor_prefix=False, batch=None):
    """Per-slot clamped inventory update; returns (state, actual_delta[B]).

    Applies the shared-limit math (inventory.cpp:38-88) and the
    enforce-on-modifier-removal pass, then emits the agent auto-stat
    families for the change (objects/agent.cpp:100-120). dense_identity:
    the slot is the full-axis identity (event contexts); actor_prefix: the
    slot is the agent-prefix identity (move waves)."""
    if dense_identity:
        inv, tid = state.obj_inv, state.obj_type
    elif actor_prefix:
        Ap = slot.shape[1]
        inv, tid = state.obj_inv[:, :Ap], state.obj_type[:, :Ap]
    else:
        inv, tid = gather(state.obj_inv, slot), gather(state.obj_type, slot)
    new_inv, actual = inv_update(program, tid, inv, rid, delta, mask)
    if program.resource_is_modifier[rid]:
        shrink = mask & (actual < 0)
        new_inv = torch.where(shrink[..., None], inv_enforce_limits(program, tid, new_inv, shrink), new_inv)
    if dense_identity:
        obj_inv = new_inv
    elif actor_prefix:
        obj_inv = state.obj_inv.clone()
        obj_inv[:, :Ap] = new_inv
    else:
        obj_inv = scatter(state.obj_inv, slot, new_inv, mask)
    state = state._replace(obj_inv=obj_inv)
    # The rid update and any enforcement drops (new_inv holds both).
    delta_rows = torch.where(mask[..., None], new_inv - inv, 0)
    state = emit_inv_stats(
        program, state, slot, delta_rows, new_inv, mask,
        dense_identity=dense_identity, actor_prefix=actor_prefix, batch=batch,
    )
    return state, actual


def set_agent_stat(state, slot, stat_id: int, value, mask, *, mode: str = "set", touch=None):
    """Write an agent stat (slots that are not agents are no-ops).

    touch: maintain the interned-key bit (stats_tracker.hpp get_or_create_id);
    by default True for "set" (a set can leave 0.0, which must still export)
    and False for "add"."""
    assert stat_id < AUTO_STAT_BASE, "auto-stat id reached the generic stat writer"
    A = state.agent_stats.shape[1]
    ok = mask & agent_slot_ok(slot, A)
    sl = slot.clamp(0, A - 1)
    cur = gather(state.agent_stats, sl)  # [B, Sa]
    v = value if mode == "set" else cur[..., stat_id] + value
    new = cur.clone()
    new[..., stat_id] = torch.where(ok, v, cur[..., stat_id])
    state = state._replace(agent_stats=scatter(state.agent_stats, sl, new, ok))
    if touch if touch is not None else (mode == "set"):
        oh = (slot[..., None] == torch.arange(A, dtype=_I32, device=slot.device)) & ok[..., None]
        while oh.dim() > 2:
            oh = oh.any(dim=1)
        touched = state.agent_stats_touched.clone()
        touched[..., stat_id] |= oh
        state = state._replace(agent_stats_touched=touched)
    return state


def set_game_stat(state, env_mask, stat_id: int, value, *, mode: str = "set", touch=None):
    """Write a game stat under a per-env mask. value: [E] or a scalar."""
    cur = state.game_stats[:, stat_id]
    v = value if mode == "set" else cur + value
    gs = state.game_stats.clone()
    gs[:, stat_id] = torch.where(env_mask, v, cur)
    state = state._replace(game_stats=gs)
    if touch if touch is not None else (mode == "set"):
        touched = state.game_stats_touched.clone()
        touched[:, stat_id] |= env_mask
        state = state._replace(game_stats_touched=touched)
    return state


def incr_agent_stat(state, slot, stat_id: int, mask):
    return set_agent_stat(state, slot, stat_id, 1.0, mask, mode="add")


# =====================================================================
# Mutations
# =====================================================================


def apply_mutation(program, state, ctx: Ctx, m, mask: torch.Tensor, mtd=None):
    """Apply one mutation under mask. Returns (state, ok[B]), ok False where
    the mutation failed (reference ctx.mutation_failed). mtd: the draw
    source of order_by=random queries (exec.MtThread or exec.RankDraws)."""
    ok = torch.ones_like(mask)

    if m.kind == "relocate":
        if ctx.actor_prefix:
            Ap = ctx.actor.shape[1]
            ar, ac = state.obj_r[:, :Ap], state.obj_c[:, :Ap]
        else:
            ar, ac = gather(state.obj_r, ctx.actor), gather(state.obj_c, ctx.actor)
        H, W = state.grid.shape[1], state.grid.shape[2]
        tr = ctx.target_r.clamp(0, H - 1)
        tc = ctx.target_c.clamp(0, W - 1)
        grid = state.grid
        if not ctx.lazy_grid:
            grid = grid_write(grid, ar, ac, -1, mask)
            grid = grid_write(grid, tr, tc, ctx.actor, mask)
        if ctx.actor_prefix:
            obj_r, obj_c = state.obj_r.clone(), state.obj_c.clone()
            obj_r[:, :Ap] = torch.where(mask, tr, ar)
            obj_c[:, :Ap] = torch.where(mask, tc, ac)
        else:
            obj_r = scatter(state.obj_r, ctx.actor, tr, mask)
            obj_c = scatter(state.obj_c, ctx.actor, tc, mask)
        return state._replace(grid=grid, obj_r=obj_r, obj_c=obj_c), ok

    if m.kind == "resource_delta":
        slot = ctx.actor if m.target_is_actor else ctx.target
        valid = mask & (slot >= 0)
        for rid, delta in m.deltas:
            state, _ = entity_inv_update(
                program, state, slot, rid, torch.full_like(slot, delta), valid,
                dense_identity=ctx.dense_identity,
                actor_prefix=ctx.actor_prefix and m.target_is_actor,
                batch=ctx.inv_batch,
            )
        return state, ok

    if m.kind == "direct_attack":
        # Flat weapon-vs-armor damage to a health resource
        # (attack_mutation.hpp:20-38).
        valid = mask & (ctx.actor >= 0) & (ctx.target >= 0)
        if ctx.dense_identity:
            weapon = state.obj_inv[..., m.weapon_rid]
            armor = state.obj_inv[..., m.armor_rid]
            damage = (torch.div(weapon * m.damage_pct, 100, rounding_mode="floor") - armor).clamp(min=0)
            state, _ = entity_inv_update(
                program, state, ctx.target, m.health_rid, -damage, valid & (damage > 0),
                dense_identity=True, batch=ctx.inv_batch,
            )
            return state, ok
        if m.armor_rid == m.health_rid:
            return _direct_attack_in_order(program, state, ctx, m, valid), ok
        if ctx.actor_prefix:
            weapon = state.obj_inv[:, : ctx.actor.shape[1], m.weapon_rid]
        else:
            weapon = gather(state.obj_inv, ctx.actor)[..., m.weapon_rid]
        # Targets route densely, which reads every target's armor once before
        # any hit: exact where the valid targets are pairwise distinct per env
        # (batch callers guarantee it) or armor is not the health resource
        # (then a hit leaves armor as it was, and the summed damage clamps as
        # sequential hits do). Each damage value lands on its slot lane and
        # the update runs over the full [E, N] object axis.
        N = state.obj_inv.shape[1]
        iota_n = torch.arange(N, dtype=_I32, device=mask.device)
        t_oh = valid[..., None] & (ctx.target[..., None] == iota_n)  # [E(, B), N]
        armor_col = state.obj_inv[..., m.armor_rid]  # [E, N]
        ac_b = armor_col[:, None, :] if ctx.target.dim() == 2 else armor_col
        armor = torch.where(t_oh, ac_b, 0).sum(dim=-1, dtype=_I32)
        damage = (torch.div(weapon * m.damage_pct, 100, rounding_mode="floor") - armor).clamp(min=0)
        hit = (valid & (damage > 0))[..., None] & t_oh
        if ctx.target.dim() == 2:
            delta_dense = torch.where(hit, -damage[..., None], 0).sum(dim=1, dtype=_I32)
            mask_dense = hit.any(dim=1)
        else:
            delta_dense = torch.where(hit, -damage[..., None], 0)
            mask_dense = hit
        state, _ = entity_inv_update(
            program, state, iota_n[None, :].expand(mask_dense.shape), m.health_rid, delta_dense,
            mask_dense, dense_identity=True, batch=ctx.inv_batch,
        )
        return state, ok

    if m.kind == "change_vibe":
        slot = ctx.actor if m.target_is_actor else ctx.target
        valid = mask & (slot >= 0)
        if ctx.dense_identity:
            return state._replace(obj_vibe=torch.where(valid, m.vibe_id, state.obj_vibe)), ok
        return state._replace(obj_vibe=scatter(state.obj_vibe, slot, torch.full_like(slot, m.vibe_id), valid)), ok

    if m.kind == "use_target":
        return apply_use_target(program, state, ctx, mask, mtd)

    if m.kind == "swap":
        # Both entities must be agents, else a no-op; the actor logs
        # "actions.swap" on success (swap_mutation.hpp:16-21). The grid and
        # the positions are written actor first, then target.
        A = program.num_agents
        ar, ac = gather(state.obj_r, ctx.actor), gather(state.obj_c, ctx.actor)
        tr, tc = gather(state.obj_r, ctx.target), gather(state.obj_c, ctx.target)
        valid = mask & agent_slot_ok(ctx.actor, A) & agent_slot_ok(ctx.target, A)
        if m.stat_id >= 0:
            state = set_agent_stat(state, ctx.actor, m.stat_id, 1.0, valid, mode="add")
        grid = grid_write(state.grid, ar, ac, ctx.target, valid)
        grid = grid_write(grid, tr, tc, ctx.actor, valid)
        obj_r = scatter(scatter(state.obj_r, ctx.actor, tr, valid), ctx.target, ar, valid)
        obj_c = scatter(scatter(state.obj_c, ctx.actor, tc, valid), ctx.target, ac, valid)
        return state._replace(grid=grid, obj_r=obj_r, obj_c=obj_c), ok

    if m.kind == "resource_transfer":
        return _resource_transfer(program, state, ctx, m, mask), ok

    if m.kind == "clear_inventory":
        # Each cleared item goes through Inventory::update, so the agent
        # auto-stat families fire for every removed amount
        # (resource_mutation.hpp:111-128).
        slot = ctx.actor if m.target_is_actor else ctx.target
        valid = mask & (slot >= 0)
        if ctx.dense_identity:
            tid, inv = state.obj_type, state.obj_inv
        else:
            tid, inv = gather(state.obj_type, slot), gather(state.obj_inv, slot)
        rmask = type_select(program, tid, np.asarray(m.clear_mask, dtype=np.int32)) > 0  # [B, R]
        new_inv = torch.where(rmask & valid[..., None], 0, inv)
        obj_inv = new_inv if ctx.dense_identity else scatter(state.obj_inv, slot, new_inv, valid)
        state = emit_inv_stats(
            program, state._replace(obj_inv=obj_inv), slot, torch.where(valid[..., None], new_inv - inv, 0),
            new_inv, valid, dense_identity=ctx.dense_identity, batch=ctx.inv_batch,
        )
        return state, ok

    if m.kind == "attack":
        return apply_attack(program, state, ctx, m, mask, mtd)

    if m.kind in ("add_tag", "remove_tag", "remove_tags_with_prefix"):
        slot = ctx.actor if m.target_is_actor else ctx.target
        valid = mask & (slot >= 0)
        tags = state.obj_tags if ctx.dense_identity else gather(state.obj_tags, slot)
        if m.kind == "remove_tags_with_prefix":
            tags = torch.where(valid[..., None] & device_table(program, m.tag_mask, slot.device), False, tags)
        else:
            tags = tags.clone()
            tags[..., m.tag_id] = torch.where(valid, m.kind == "add_tag", tags[..., m.tag_id])
        obj_tags = tags if ctx.dense_identity else scatter(state.obj_tags, slot, tags, valid)
        return state._replace(obj_tags=obj_tags), ok

    if m.kind == "stats":
        slot = ctx.actor if m.entity_is_actor else ctx.target
        value = eval_value(program, state, m.source, slot, ctx, mtd)
        if m.stat_is_game:
            # A game stat is written once per env: only [E] contexts.
            assert mask.dim() == 1, "a game stats mutation needs a per-env context"
            return set_game_stat(state, mask, m.stat_id, value), ok
        return set_agent_stat(state, slot, m.stat_id, value, mask), ok

    if m.kind == "set_game_value":
        slot = ctx.actor if m.target_is_actor else ctx.target
        valid = mask & (slot >= 0)
        if m.source is not None:
            delta = eval_value(program, state, m.source, slot, ctx, mtd)
        else:
            delta = torch.full(mask.shape, m.delta_const, dtype=torch.float32, device=mask.device)
        if m.write_rid >= 0:
            state, _ = entity_inv_update(program, state, slot, m.write_rid, delta.to(_I32), valid, batch=ctx.inv_batch)
        elif m.stat_is_game:
            assert mask.dim() == 1, "a game set_game_value mutation needs a per-env context"
            # touch: the reference resolves the stat's pointer at apply time,
            # which interns it even for a zero delta (game_value.cpp).
            state = set_game_stat(state, valid, m.stat_id, delta, mode="add", touch=True)
        else:
            state = set_agent_stat(state, slot, m.stat_id, delta, valid, mode="add", touch=True)
        return state, ok

    if m.kind == "query_inventory":
        return _query_inventory(program, state, ctx, m, mask, mtd), ok

    if m.kind == "recompute_materialized_query":
        return recompute_materialized(program, state, _env_gate(mask, "any"), m.tag_mask, mtd), ok

    if m.kind == "push_object":
        # The target moves one cell along the actor -> target direction,
        # each component clamped to [-1, 1]; it fails where that cell is off
        # the grid or occupied (push_object_mutation.hpp).
        H, W = state.grid.shape[1], state.grid.shape[2]
        ar, ac = gather(state.obj_r, ctx.actor), gather(state.obj_c, ctx.actor)
        tr, tc = gather(state.obj_r, ctx.target), gather(state.obj_c, ctx.target)
        nr, nc = tr + (tr - ar).clamp(-1, 1), tc + (tc - ac).clamp(-1, 1)
        inb = (nr >= 0) & (nr < H) & (nc >= 0) & (nc < W)
        can = mask & (ctx.target >= 0) & inb & (grid_read(state.grid, nr, nc) < 0)
        nr, nc = nr.clamp(0, H - 1), nc.clamp(0, W - 1)
        grid = grid_write(grid_write(state.grid, tr, tc, -1, can), nr, nc, ctx.target, can)
        state = state._replace(
            grid=grid, obj_r=scatter(state.obj_r, ctx.target, nr, can), obj_c=scatter(state.obj_c, ctx.target, nc, can)
        )
        return state, torch.where(mask, can, ok)

    if m.kind == "spawn_object":
        return apply_spawn(program, state, ctx, m, mask)

    if m.kind == "raycast_spawn":
        return _raycast_spawn(program, state, ctx, m, mask, mtd), ok

    raise NotImplementedError(f"mutation kind {m.kind!r}")


def _raycast_spawn(program, state, ctx: Ctx, m, mask, mtd=None):
    """Rays from the target entity: each direction walks max_range cells (a
    game-value range: max(H, W) cells, masked past the range resolved per
    entry) and spawns at every empty cell until the grid's edge or an
    occupied cell where a blocker filter passes. Without blocker filters
    occupied cells are skipped and never stop the ray
    (raycast_spawn_mutation.cpp:38-68, mutation_config.hpp:121-126). Works
    in [E] and dense [E, N] contexts; each hop's spawns see the earlier
    hops'."""
    H, W = state.grid.shape[1], state.grid.shape[2]
    tr, tc = gather(state.obj_r, ctx.target), gather(state.obj_c, ctx.target)
    valid = mask & (ctx.target >= 0)
    if m.max_range_value is not None:
        rv = torch.floor(eval_value(program, state, m.max_range_value, ctx.target, ctx, mtd)).to(_I32)
        hops = max(H, W)
    else:
        rv, hops = None, m.max_range
    for d in m.directions:
        dr, dc = int(DIR_DR[d]), int(DIR_DC[d])
        blocked = torch.zeros_like(valid)
        for i in range(1, hops + 1):
            rr, cc = tr + dr * i, tc + dc * i
            blocked = blocked | ~((rr >= 0) & (rr < H) & (cc >= 0) & (cc < W))
            if rv is not None:
                blocked = blocked | (rv < i)
            slot_here = grid_read(state.grid, rr, cc)
            occupied = slot_here >= 0
            hits_blocker = torch.zeros_like(occupied)
            if m.blocker:
                bctx = Ctx(actor=ctx.actor, target=torch.where(occupied, slot_here, -1), target_r=rr, target_c=cc,
                           distance=torch.full_like(rr, i), timestep=ctx.timestep)
                if mtd is None:
                    hits_blocker = occupied & eval_filters(program, state, bctx, m.blocker)
                else:
                    # The C++ walk evaluates blockers only at occupied cells
                    # of a ray still running (raycast_spawn_mutation.cpp:50-68).
                    with mtd.narrowed(_env_gate(valid & ~blocked & occupied, "any")):
                        hits_blocker = occupied & eval_filters(program, state, bctx, m.blocker, mtd)
            state, _ = apply_spawn(program, state, ctx._replace(target_r=rr, target_c=cc), m,
                                   valid & ~blocked & ~occupied)
            blocked = blocked | hits_blocker
    return state


def apply_spawn(program, state, ctx: Ctx, m, mask):
    """Spawn objects of m.spawn_type_id at the cells (ctx.target_r,
    ctx.target_c) where mask and the cell is empty, each in a dead slot past
    the agents: in an [E] context the first such slot, in a dense [E, M]
    context the r-th request of an env (in flat order) takes its r-th such
    slot. A request without a free slot fails. The requests of one call
    name distinct cells (one hop of rays from distinct sources), so the
    reference's same-cell collision (handlers.py:833-838) cannot arise.
    Returns (state, ok)."""
    H, W = state.grid.shape[1], state.grid.shape[2]
    E, N = state.obj_alive.shape
    dev = mask.device
    tid = m.spawn_type_id
    tr, tc = ctx.target_r.clamp(0, H - 1), ctx.target_c.clamp(0, W - 1)
    can = mask & (grid_read(state.grid, tr, tc) < 0)
    iota = torch.arange(N, dtype=_I32, device=dev)
    free = ~state.obj_alive & (iota >= program.num_agents)  # [E, N]
    order = torch.where(free, iota, N).sort(dim=1).values  # free slots ascending
    if mask.dim() == 1:
        rank = torch.zeros((E, 1), dtype=_I32, device=dev)
    else:
        flat = can.reshape(E, -1).to(_I32)
        rank = flat.cumsum(dim=1, dtype=_I32) - 1
    has_free = (rank >= 0) & (rank < free.sum(dim=1, dtype=_I32)[:, None])
    slot = order.gather(1, rank.clamp(0, N - 1).long()).to(_I32).reshape(can.shape)
    can = can & has_free.reshape(can.shape)
    state = state._replace(
        grid=grid_write(state.grid, tr, tc, slot, can),
        obj_type=scatter(state.obj_type, slot, tid, can),
        obj_r=scatter(state.obj_r, slot, tr, can),
        obj_c=scatter(state.obj_c, slot, tc, can),
        obj_vibe=scatter(state.obj_vibe, slot, int(program.type_initial_vibe[tid]), can),
        obj_tags=scatter(state.obj_tags, slot, device_table(program, np.asarray(program.type_tags)[tid], dev), can),
        obj_inv=scatter(state.obj_inv, slot, device_table(program, np.asarray(program.type_initial_inv)[tid], dev),
                        can),
        obj_alive=scatter(state.obj_alive, slot, True, can),
    )
    return state, torch.where(mask, can, True)


def recompute_materialized(program, state, env_mask=None, tag_mask=None, mtd=None):
    """Recompute the materialized queries' tags in declaration order
    (query_system.cpp compute_all): env_mask bool[E] limits the envs,
    tag_mask bool[n_tags] the tags."""
    for tag_id, query in program.materialized:
        if tag_mask is not None and not tag_mask[tag_id]:  # a numpy mask of the program
            continue
        bit = eval_query_mask(program, state, query, None, mtd)  # [E, N]
        tags = state.obj_tags.clone()
        tags[:, :, tag_id] = bit if env_mask is None else torch.where(env_mask[:, None], bit, tags[:, :, tag_id])
        state = state._replace(obj_tags=tags)
    return state


def _resource_transfer(program, state, ctx: Ctx, m, mask):
    """Move resources from one entity to the other: the receiver accepts up
    to its capacity and the source loses what was accepted; a negative
    amount moves all the source holds (resource_mutation.hpp:60-86). An
    agent source logs "<res>.deposited". remove_source_when_empty kills an
    emptied source and clears its cell; under the lazy grid only agent
    sources keep their cell, as nothing reads the grid's agent layer there
    (the reference skips the clear for every source, leaving a non-agent
    source's cell stale)."""
    src = ctx.actor if m.from_is_actor else ctx.target
    dst = ctx.actor if m.to_is_actor else ctx.target
    valid = mask & (src >= 0) & (dst >= 0)
    A, R = program.num_agents, program.num_resources
    iota_a = torch.arange(A, dtype=_I32, device=mask.device)
    for rid, amount in m.deltas:
        src_inv = gather(state.obj_inv, src)[..., rid]
        want = src_inv if amount < 0 else src_inv.clamp(max=amount)
        state, accepted = entity_inv_update(program, state, dst, rid, want, valid, batch=ctx.inv_batch)
        state, _ = entity_inv_update(program, state, src, rid, -accepted, valid, batch=ctx.inv_batch)
        dep_ok = valid & agent_slot_ok(src, A) & (accepted > 0)
        add = torch.where((src[..., None] == iota_a) & dep_ok[..., None], accepted[..., None], 0)
        while add.dim() > 2:  # [E, K, A] -> [E, A]: slots are unique per call
            add = add.sum(dim=1, dtype=_I32)
        if ctx.inv_batch is not None:
            row = torch.zeros(add.shape + (R,), dtype=_I32, device=add.device)
            row[..., rid] = add
            b = ctx.inv_batch
            b.dep = row if b.dep is None else b.dep + row
        elif program.stats_compact:
            au = state.auto_stats.clone()
            au[..., int(program.stat_inv_deposited[rid]) - AUTO_STAT_BASE] += add
            state = state._replace(auto_stats=au)
        else:
            stats = state.agent_stats.clone()
            stats[..., int(program.stat_inv_deposited[rid])] += add.to(stats.dtype)
            state = state._replace(agent_stats=stats)
    if m.remove_source_when_empty:
        rm = valid & (gather(state.obj_inv, src).sum(dim=-1) == 0)
        clear = rm & (src >= A) if ctx.lazy_grid else rm
        grid = grid_write(state.grid, gather(state.obj_r, src), gather(state.obj_c, src), -1, clear)
        state = state._replace(grid=grid, obj_alive=scatter(state.obj_alive, src, False, rm))
    return state


def _query_inventory(program, state, ctx: Ctx, m, mask, mtd=None):
    """Inventory deltas across a query's results; in transfer mode the net
    applied amount leaves the source entity, and transfer stats log the
    moved quantity (mutation_config.hpp:94-103)."""
    env_any = _env_gate(mask, "any")
    targets = eval_query_mask(program, state, m.query, None, mtd) & env_any[:, None]  # [E, N]
    E, N = targets.shape
    src = ctx.actor if m.from_is_actor else ctx.target
    if src.dim() > 1:  # a batch context has no single source
        src = torch.full((E,), -1, dtype=_I32, device=mask.device)
    slots_n = torch.arange(N, dtype=_I32, device=mask.device)[None, :].expand(E, N)
    for rid, delta in m.deltas:
        inv_all = state.obj_inv
        new_inv, actual = inv_update(program, state.obj_type, inv_all, rid, torch.full_like(state.obj_type, delta), targets)
        # Agent targets change through the notifying update path, so the
        # auto-stat families fire for them (agent.cpp:100-120).
        state = emit_inv_stats(
            program, state._replace(obj_inv=new_inv), slots_n, torch.where(targets[..., None], new_inv - inv_all, 0),
            new_inv, targets, dense_identity=True, batch=ctx.inv_batch,
        )
        net = actual.sum(dim=1, dtype=_I32)  # [E]
        if m.transfer_mode:
            state, _ = entity_inv_update(program, state, src, rid, -net, env_any & (src >= 0), batch=ctx.inv_batch)
        for srid, stat_id in m.transfer_stats:
            if srid == rid:
                state = set_game_stat(state, env_any, stat_id, net.abs().to(torch.float32), mode="add")
    return state


def apply_attack(program, state, ctx: Ctx, m, mask, mtd=None):
    """The DSL attack (config attack_mutation; actions/attack.hpp:146-237):
    weapon power against armor power (vibe bonuses included); a target that
    can pay every defense cost plus the excess blocks and pays it, otherwise
    the on_success mutations apply. Never fails."""
    actor, target = ctx.actor, ctx.target
    valid = mask & (actor >= 0) & (target >= 0)
    a_inv = state.obj_inv[:, : actor.shape[1]] if ctx.actor_prefix else gather(state.obj_inv, actor)
    t_inv = gather(state.obj_inv, target)
    weapon = torch.zeros(mask.shape, dtype=_I32, device=mask.device)
    for rid, w in m.weapon:
        weapon = weapon + a_inv[..., rid] * w
    armor = torch.zeros_like(weapon)
    bonus_by_vibe = None
    if m.vibe_bonus is not None and m.vibe_matches_resource is not None:
        t_vibe = gather(state.obj_vibe, target).long()
        vb = device_table(program, m.vibe_bonus, mask.device)
        vm = device_table(program, m.vibe_matches_resource, mask.device)
        bonus_by_vibe = vb[t_vibe], vm[t_vibe]  # [B], [B, R]
    for rid, w in m.armor:
        amount = t_inv[..., rid]
        if bonus_by_vibe is not None:
            amount = amount + torch.where(bonus_by_vibe[1][..., rid], bonus_by_vibe[0], 0)
        armor = armor + amount * w
    damage_bonus = (weapon - armor).clamp(min=0)
    can_defend = valid if m.defense else torch.zeros_like(valid)
    for rid, amount in m.defense:
        can_defend = can_defend & (t_inv[..., rid] >= amount + damage_bonus)
    for rid, amount in m.defense:
        state, _ = entity_inv_update(program, state, target, rid, -(amount + damage_bonus), can_defend,
                                     batch=ctx.inv_batch)
    hit = valid & ~can_defend
    for sub in m.on_success:
        if mtd is None:
            state, _ = apply_mutation(program, state, ctx, sub, hit)
        else:
            with mtd.narrowed(_env_gate(hit, "any")):
                state, _ = apply_mutation(program, state, ctx, sub, hit, mtd)
    return state, torch.ones_like(mask)


def _direct_attack_in_order(program, state, ctx: Ctx, m, valid):
    """direct_attack where armor is the health resource: one gather/scatter
    hit per batch column, in column order, each reading the weapon and armor
    that earlier hits left, as sequential application does (a repeated
    target meets the armor the previous hit lowered)."""
    E = ctx.target.shape[0]
    actors, targets = ctx.actor.expand(ctx.target.shape).reshape(E, -1), ctx.target.reshape(E, -1)
    valid = valid.reshape(E, -1)
    for b in range(targets.shape[1]):
        actor, target, v = actors[:, b], targets[:, b], valid[:, b]
        weapon = gather(state.obj_inv, actor)[..., m.weapon_rid]
        armor = gather(state.obj_inv, target)[..., m.armor_rid]
        damage = (torch.div(weapon * m.damage_pct, 100, rounding_mode="floor") - armor).clamp(min=0)
        state, _ = entity_inv_update(program, state, target, m.health_rid, -damage, v & (damage > 0), batch=ctx.inv_batch)
    return state


def apply_use_target(program, state, ctx: Ctx, mask: torch.Tensor, mtd=None):
    """Run the target's per-type on_use handler chain (reference:
    use_target_mutation.hpp + grid_object.cpp onUse), then the actor's
    on_after_use hook where the use succeeded."""
    ttype = gather(state.obj_type, ctx.target)
    ok = torch.zeros_like(mask)
    for tid, handler in enumerate(program.on_use_handlers):
        if handler is None:
            continue
        state, applied = try_apply(program, state, ctx, handler, mask & (ctx.target >= 0) & (ttype == tid), mtd)
        ok = ok | applied
    A = program.num_agents
    for cfg_idx, hooks in enumerate(program.on_after_use_handlers):
        if hooks is None:
            continue
        acfg = gather(state.agent_cfg, ctx.actor.clamp(0, A - 1))
        state, _ = try_apply(program, state, ctx, hooks, ok & agent_slot_ok(ctx.actor, A) & (acfg == cfg_idx), mtd)
    return state, ok


def apply_mutations(program, state, ctx: Ctx, handler: CompiledHandler, mask: torch.Tensor, mtd=None):
    """Apply the mutation chain in order; a failed mutation stops the later
    ones for that entry, earlier ones stay applied (handler.cpp:82-89). With
    a draw source, a mutation's draws are gated on the chain still running."""
    still_ok = mask
    for m in handler.mutations:
        if mtd is None:
            state, ok = apply_mutation(program, state, ctx, m, still_ok)
        else:
            with mtd.narrowed(_env_gate(still_ok, "any")):
                state, ok = apply_mutation(program, state, ctx, m, still_ok, mtd)
        still_ok = still_ok & ok
    return state, still_ok


def try_apply(program, state, ctx: Ctx, handler, mask: torch.Tensor, mtd=None):
    """Filters gate, then mutations. Returns (state, succeeded[B]).
    A multi-handler dispatches FirstMatch or All (multi_handler.hpp:24-49).
    With a draw source (reference handlers.py:947-989), FirstMatch gates a
    handler's draws on no earlier handler having applied, filters
    short-circuit (exec.eval_filters) and mutation draws are gated on the
    filters having passed."""
    if isinstance(handler, CompiledMultiHandler):
        done = torch.zeros_like(mask)
        for h in handler.handlers:
            sub = mask & ~done if handler.first_match else mask
            if mtd is None or not handler.first_match:
                state, applied = try_apply(program, state, ctx, h, sub, mtd)
            else:
                with mtd.narrowed(_env_gate(~done, "any")):
                    state, applied = try_apply(program, state, ctx, h, sub, mtd)
            done = done | applied
        return state, done
    if mtd is None:
        passed = mask & eval_filters(program, state, ctx, handler.filters)
        return apply_mutations(program, state, ctx, handler, passed)
    with mtd.narrowed(_env_gate(mask, "any")):
        passed = mask & eval_filters(program, state, ctx, handler.filters, mtd)
        with mtd.narrowed(_env_gate(passed, "any")):
            return apply_mutations(program, state, ctx, handler, passed, mtd)
