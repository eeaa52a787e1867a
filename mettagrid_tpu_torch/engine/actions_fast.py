"""Wave-based parallel action resolution — sequential-equivalent, vectorized.

Counterpart of the reference's engine/actions_fast.py. The reference applies
actions sequentially in shuffled order with immediate effect
(mettagrid_c.cpp:957-998); the wave phase resolves the same semantics in
waves of agents whose effects are provably disjoint.

This module ports the static gates (numpy over the compiled program, copied
from the reference), the pure-relocation wave loop of the arena preset, the
exact footprint-schedule wave loop whose batches run handler chains
(DirectAttack, relocate, UseTarget) for the combat and general presets, and
the conservative Chebyshev wave loop that programs with a reachable swap or
move handlers of range above 1 take.
"""

from __future__ import annotations

import numpy as np
import torch

from mettagrid_tpu_torch.engine import step_graphs
from mettagrid_tpu_torch.engine.exec import Ctx, eval_filters, grid_read, grid_write
from mettagrid_tpu_torch.engine.handlers import (
    InvStatBatch,
    apply_mutations,
    flush_inv_stat_batch,
    inv_stat_batch_ok,
)
from mettagrid_tpu_torch.engine.ir import CompiledFilter, CompiledHandler, CompiledMutation, CompiledQuery, reaches
from mettagrid_tpu_torch.engine.program import (
    DIR_DC,
    DIR_DR,
    KIND_CHANGE_VIBE,
    KIND_MOVE,
    KIND_NOOP,
    EngineProgram,
)
from mettagrid_tpu_torch.engine.state import EnvState
from mettagrid_tpu_torch.profiling import trace

# Waves run before the first host check of "any agent unsettled": with random
# actions at arena densities the per-env wave count is small, so the common
# step pays one device-to-host sync for the loop.
PURE_UNROLL_WAVES = 2

_LOCAL_FILTERS = {
    "target_loc_empty",
    "target_is_usable",
    "vibe",
    "resource",
    "tag",
    "tag_prefix",
    "shared_tag_prefix",
    "max_distance",
    "periodic",
    "not",
    "or",
}
_LOCAL_MUTATIONS = {
    "relocate",
    "use_target",
    "swap",
    "resource_delta",
    "resource_transfer",
    "clear_inventory",
    "attack",
    "direct_attack",
    "change_vibe",
    "add_tag",
    "remove_tag",
    "remove_tags_with_prefix",
    "stats",
}


def _value_local(v) -> bool:
    """A game value is wave-local when it reads only the bound entity (or
    constants): query-bearing kinds read arbitrary objects, so an earlier
    agent's same-wave mutation could change their result mid-order."""
    if v is None:
        return True
    if v.kind in ("sum", "ratio", "max", "min"):
        return all(_value_local(c) for c in v.children)
    # Whitelist the known entity-local leaves; any other kind (the query
    # kinds today, anything added later) defaults to NOT wave-local — the
    # repo convention for classification gates (cf. mutfields._KINDS).
    return v.kind in ("const", "inventory", "stat")


def _filter_local(f: CompiledFilter) -> bool:
    if f.kind not in _LOCAL_FILTERS:
        return False
    if f.kind == "max_distance" and f.query is not None:
        return False
    return all(_filter_local(i) for i in f.inner)


def _mutation_local(m: CompiledMutation) -> bool:
    if m.kind not in _LOCAL_MUTATIONS:
        return False
    if m.kind == "stats":
        # Game-scope stat writes are per-env shared state (two same-wave
        # writers would race), and query-bearing sources read arbitrary
        # objects — both break the per-agent footprint argument.
        if m.stat_is_game or not _value_local(m.source):
            return False
    return all(_mutation_local(s) for s in m.on_success)


def _handler_local(h) -> bool:
    if isinstance(h, CompiledHandler):
        return all(_filter_local(f) for f in h.filters) and all(
            _mutation_local(m) for m in h.mutations
        )
    return all(_handler_local(c) for c in h.handlers)


def fast_mode_ok(program: EngineProgram) -> bool:
    """True when the wave-based phase is provably sequential-equivalent."""
    for mh in program.move_handlers:
        if not _handler_local(mh.handler):
            return False
    for h in program.on_use_handlers:
        if h is not None and not _handler_local(h):
            return False
    for h in program.on_after_use_handlers:
        if h is not None and not _handler_local(h):
            return False
    return True


def _mutation_has_swap(m: CompiledMutation) -> bool:
    return m.kind == "swap" or any(_mutation_has_swap(s) for s in m.on_success)


def _handler_has_swap(h) -> bool:
    if h is None:
        return False
    if isinstance(h, CompiledHandler):
        return any(_mutation_has_swap(m) for m in h.mutations)
    return any(_handler_has_swap(c) for c in h.handlers)


def footprint_schedule_ok(program: EngineProgram) -> bool:
    """True when the exact two-cell footprint wave schedule applies (requires
    fast_mode_ok). Argument: with max_range == 1 every local handler's reads
    and writes are confined to {actor cell, target cell} (filters/mutations
    touch only the actor entity, the target entity, and the target cell's
    occupancy), and with no reachable `swap` an agent's position cannot
    change before it acts. Two movers whose cell pairs are disjoint therefore
    commute, so x need only wait for an earlier unsettled y when
    t_y == t_x (y may arrive at / mutate the occupant of x's target),
    p_y == t_x (y may vacate or be x's target), or p_x == t_y (y targets x).
    Every unsettled position is the phase-start position, so the whole wave
    schedule is computable up-front from [E, A] cell ids — the expensive
    mutation batch then runs exactly max-wave-count times instead of once
    per conservative Chebyshev wave."""
    if not all(mh.max_range == 1 for mh in program.move_handlers):
        return False
    for mh in program.move_handlers:
        if _handler_has_swap(mh.handler):
            return False
    for h in list(program.on_use_handlers) + list(program.on_after_use_handlers):
        if _handler_has_swap(h):
            return False
    return True


def pure_move_ok(program: EngineProgram) -> bool:
    """True when moves reduce to pure relocation: exactly the two default
    move handlers (action_handler_factory.cpp:33-45) and no usable object
    type, so the UseTarget handler can never pass. Then the whole move
    phase is [E, A] arithmetic over agent cell ids: agents are the only
    movable objects, each agent's target cell is fixed at phase start, and
    success is just an occupancy test at settle time."""
    mhs = program.move_handlers
    if len(mhs) != 2:
        return False
    h0, h1 = mhs
    if not (isinstance(h0.handler, CompiledHandler) and h0.max_range == 1 and h0.accepts_empty):
        return False
    if [f.kind for f in h0.handler.filters] != ["target_loc_empty"]:
        return False
    if [m.kind for m in h0.handler.mutations] != ["relocate"]:
        return False
    if not (isinstance(h1.handler, CompiledHandler) and h1.max_range == 1):
        return False
    if [f.kind for f in h1.handler.filters] != ["target_is_usable"]:
        return False
    if [m.kind for m in h1.handler.mutations] != ["use_target"]:
        return False
    if np.asarray(program.type_usable).any():
        return False
    return True


# Kinds proven to neither read the grid nor move any object (WHITELIST —
# unknown kinds are unsafe, the repo's classification-gate convention):
# anything else outside a move-handler relocate disqualifies the gridless
# batch (position-compare resolution requires non-agent positions frozen).
_GRIDSAFE_MUTATIONS = {
    "direct_attack", "resource_delta", "resource_transfer", "clear_inventory",
    "change_vibe", "add_tag", "remove_tag", "remove_tags_with_prefix",
    "stats", "set_game_value", "use_target", "query_inventory",
}


# Mutation kinds that test a cell's occupancy in state.grid.
_GRID_READING_MUTATIONS = frozenset({"push_object", "spawn_object", "raycast_spawn"})


def reads_grid(program: EngineProgram) -> bool:
    """True when a construct that reads grid cells is reachable from
    anywhere in the program (move, on_use, on_tick and territory handlers,
    events, AOE, rewards, value observations, materialized queries): a
    raycast query, the one query kind that scans cells, or a mutation that
    tests a cell's occupancy. Such a program keeps the grid's agent layer
    current: make_step sets neither the lazy grid nor the gridless batch
    for it. (The reference turns its lazy grid on without asking, so a
    raycast reached from a reward or a value observation reads agents where
    they were placed; ROADMAP Queue 3.)"""
    return reaches(program, lambda node: (isinstance(node, CompiledQuery) and node.kind == "raycast")
                   or (isinstance(node, CompiledMutation) and node.kind in _GRID_READING_MUTATIONS))


def _m_gridsafe(m, move_ctx: bool) -> bool:
    if m.kind == "relocate":
        ok = move_ctx  # batch relocates move the ACTOR agent and honor
        # ctx.lazy_grid; anywhere else they move arbitrary targets
    else:
        ok = m.kind in _GRIDSAFE_MUTATIONS  # position/spawn/push/unknown: unsafe default
    return ok and all(_m_gridsafe(s, move_ctx) for s in m.on_success)


def _h_gridsafe(h, move_ctx: bool) -> bool:
    if h is None:
        return True
    if isinstance(h, CompiledHandler):
        return all(_m_gridsafe(m, move_ctx) for m in h.mutations)
    return all(_h_gridsafe(c, move_ctx) for c in h.handlers)


def gridless_batch_ok(program: EngineProgram) -> bool:
    """True when the wave batch can run WITHOUT the grid: target resolution
    by position-compare and no agent-layer grid maintenance at all.

    Argument: when no reachable construct can move/spawn/remove-and-respawn
    a NON-agent object (position mutations confined to move-handler
    relocates of the actor agent), "slot at cell" is exactly "the alive
    object whose obj_r/obj_c equals the cell" — an [E, A, N] compare
    replaces the [E, A] grid gather (the XLA:TPU penalty class). And when
    nothing reachable reads the grid (reads_grid: every engine phase — obs,
    events, AOE, territory, coverage, visited — derives from positions,
    never grid values), the agent-layer grid writes are dead code and are
    skipped via Ctx.lazy_grid (relocate + remove-when-empty honor it). The
    reference walks handlers, events, AOE and rewards for raycasts but not
    value observations; reads_grid walks everything. exec.true_grid remains
    the canonical reconstruction, and non-batch contexts (events, ticks)
    keep writing the grid's static layer so it stays correct for external
    readers.
    """
    if not footprint_schedule_ok(program) or reads_grid(program):
        return False
    for mh in program.move_handlers:
        if not (_handler_local(mh.handler) and _h_gridsafe(mh.handler, True)):
            return False
    # on_use chains execute inside the batch (use_target), same ctx.
    for h in list(program.on_use_handlers or ()):
        if not _h_gridsafe(h, True):
            return False
    for h in (
        list(program.on_tick_handlers or ())
        + list(getattr(program, "on_after_use_handlers", ()) or ())
        + [getattr(program, "game_on_tick", None)]
        + [h for spec in program.territories or () for h in (spec.on_enter, spec.on_exit, spec.presence)]
        + [ev.handler for ev in program.events or ()]
    ):
        if not _h_gridsafe(h, False):
            return False
    return all(_m_gridsafe(m, False) for spec in program.aoe_specs or () for m in spec.mutations)


# Mutation kinds that can fail (ctx.mutation_failed in the reference).
_FAILABLE = {"use_target", "push_object", "spawn_object"}


def _no_failable(m) -> bool:
    return m.kind not in _FAILABLE and all(_no_failable(s) for s in m.on_success)


def _all_or_nothing(h) -> bool:
    """The handler fails only through its filters: no mutation of it fails,
    so a failed attempt has changed nothing."""
    if isinstance(h, CompiledHandler):
        return all(_no_failable(m) for m in h.mutations)
    return all(_all_or_nothing(c) for c in h.handlers)


def shared_read_ok(program: EngineProgram) -> bool:
    """True when one read of each mover's adjacent cell serves every move
    handler of a wave batch: every handler has range 1, and every handler
    but the last is all-or-nothing, so a handler that fails has not moved
    anything another handler would read."""
    mhs = program.move_handlers
    return all(mh.max_range == 1 for mh in mhs) and all(_all_or_nothing(mh.handler) for mh in mhs[:-1])


def batch_gridless(program: EngineProgram) -> bool:
    """True when wave batches run without the grid's agent layer: they
    resolve targets by position compare and write no agent-layer cell.

    The reference keys its batch on gridless_batch_ok AND the shared read
    (actions_fast.py:428-436), but its auto-reset merge skip on
    gridless_batch_ok alone (step.py:733), so a program that passes the
    one and not the other keeps a stale grid across resets. The port keys
    both on this predicate."""
    return shared_read_ok(program) and gridless_batch_ok(program)


def make_apply_move_batch(program: EngineProgram):
    """Returns apply_move_batch(state, active, dr, dc) -> (state, success
    bool[E, A]): one wave batch, every move handler in order for the agents
    in ``active`` (bool[E, A]), which are pairwise non-interacting, so all
    their reads and writes are disjoint. dr, dc: int32[E, A] move direction.

    Inventory-stat emissions of the batch accumulate in one InvStatBatch and
    reach auto_stats once, where inv_stat_batch_ok allows."""
    shared_ok = shared_read_ok(program)
    gridless = batch_gridless(program)
    batch_ok = inv_stat_batch_ok(program, [mh.handler for mh in program.move_handlers])

    def apply_move_batch(state: EnvState, active, dr, dc):
        batch = InvStatBatch() if batch_ok else None
        E, A = active.shape
        H, W = state.grid.shape[1], state.grid.shape[2]
        dev = active.device
        slots = torch.arange(A, dtype=torch.int32, device=dev)[None, :].expand(E, A)
        ar = state.obj_r[:, :A]
        ac = state.obj_c[:, :A]
        ones = torch.ones((E, A), dtype=torch.int32, device=dev)

        shared = None
        if shared_ok:
            cr1, cc1 = ar + dr, ac + dc
            inb1 = (cr1 >= 0) & (cr1 < H) & (cc1 >= 0) & (cc1 < W)
            if gridless:
                # Position compare: cells hold one live object each, so the
                # largest matching slot is THE slot (-1 = empty).
                N = state.obj_type.shape[1]
                ocell = torch.where(state.obj_alive, state.obj_r * W + state.obj_c, -7)
                tc1 = torch.where(inb1, cr1 * W + cc1, -1)
                eqm = tc1[:, :, None] == ocell[:, None, :]
                iota_n = torch.arange(N, dtype=torch.int32, device=dev)
                slot1 = torch.where(eqm, iota_n, -1).amax(dim=-1)
            else:
                slot1 = torch.where(inb1, grid_read(state.grid, cr1, cc1), -1)
            shared = (cr1, cc1, inb1, slot1)

        success = torch.zeros((E, A), dtype=torch.bool, device=dev)
        for mh in program.move_handlers:
            if shared is not None:
                cand_r, cand_c, inb1, slot1 = shared
                cand_dist = ones
                found = active & inb1 if mh.accepts_empty else active & inb1 & (slot1 >= 0)
                target = torch.where(found, slot1, -1)
            elif mh.accepts_empty:
                cand_r, cand_c = ar + dr, ac + dc
                cand_dist = ones
                found = active & (cand_r >= 0) & (cand_r < H) & (cand_c >= 0) & (cand_c < W)
                target = torch.where(found, grid_read(state.grid, cand_r, cand_c), -1)
            else:
                # Line scan to the first occupied cell (move.hpp:81-115).
                found = torch.zeros((E, A), dtype=torch.bool, device=dev)
                blocked = torch.zeros_like(found)
                cand_r = torch.zeros_like(ar)
                cand_c = torch.zeros_like(ac)
                cand_dist = ones
                for i in range(1, mh.max_range + 1):
                    cr, cc = ar + dr * i, ac + dc * i
                    inb = (cr >= 0) & (cr < H) & (cc >= 0) & (cc < W)
                    blocked = blocked | ~inb
                    newly = inb & ~blocked & (grid_read(state.grid, cr, cc) >= 0) & ~found
                    cand_r = torch.where(newly, cr, cand_r)
                    cand_c = torch.where(newly, cc, cand_c)
                    cand_dist = torch.where(newly, i, cand_dist)
                    found = found | newly
                found = found & active
                target = torch.where(found, grid_read(state.grid, cand_r, cand_c), -1)
            ctx = Ctx(
                actor=slots, target=target, target_r=cand_r, target_c=cand_c, distance=cand_dist,
                timestep=state.step_count, actor_prefix=True, lazy_grid=gridless, inv_batch=batch,
            )
            passed = found & ~success & eval_filters(program, state, ctx, mh.handler.filters)
            state, applied = apply_mutations(program, state, ctx, mh.handler, passed)
            success = success | applied
        return flush_inv_stat_batch(program, state, batch), success

    return apply_move_batch


def make_action_phase_fast(program: EngineProgram, pure_move: bool = False, lazy_grid: bool = False):
    """Wave-parallel action phase. Requires fast_mode_ok(program).

    pure_move (requires pure_move_ok): the move waves are [E, A] cell-id
    arithmetic, with no per-wave grid gathers or scatters. lazy_grid
    (requires pure_move; step.step_gates decides it) then skips the writes
    of the grid's agent layer: nothing reads that layer (collisions resolve
    from the position vector, static occupancy only tests ``slot >= A``),
    so the grid keeps its reset value, as in the reference engine.

    Otherwise the moves run the exact footprint schedule where
    footprint_schedule_ok holds: wave indices come from the phase-start
    cells, and each wave runs the handler chains for its agents
    (make_apply_move_batch). Where it does not (a reachable swap, or a move
    handler of range above 1), they run the Chebyshev waves: each wave
    settles the unsettled movers with no earlier-ranked unsettled mover
    within Chebyshev distance 2 * max_range of their current cells, so their
    scans and writes cannot touch, and distances are taken anew each wave
    (a swap moves its target before the target's own turn).

    Returns action_phase(state, actions, vibe_actions, perm) -> state, out of
    place (the input state's tensors are not written). Each loop adds its
    waves to the counter ``actions.waves`` and reads its end through
    ``trace.host_read`` (profiling/trace.py)."""
    sched_ok = footprint_schedule_ok(program)
    # Chebyshev interaction radius: two agents farther apart cannot reach a
    # common cell or object with their line scans and moves.
    r_int = 2 * max((mh.max_range for mh in program.move_handlers), default=1)
    # A reachable swap can move an agent that does not move itself (noop)
    # before its turn; the waves then book such agents at their turn.
    swaps = any(_handler_has_swap(h) for h in [mh.handler for mh in program.move_handlers]
                + list(program.on_use_handlers) + list(program.on_after_use_handlers))
    apply_move_batch = make_apply_move_batch(program)
    n_actions = len(program.action_names)
    kind_np = np.asarray(program.action_kind)
    arg_np = np.asarray(program.action_arg)
    dir_dr = np.asarray(DIR_DR)
    dir_dc = np.asarray(DIR_DC)
    argc = np.clip(arg_np, 0, len(dir_dr) - 1)
    # Action table, one row per action: kind, arg, is_vibe, priority,
    # succ_stat, fail_stat, move dr, move dc.
    table_np = np.stack(
        [
            kind_np,
            arg_np,
            np.asarray(program.action_is_vibe).astype(np.int32),
            np.asarray(program.action_priority),
            np.asarray(program.action_success_stat),
            np.asarray(program.action_fail_stat),
            np.where(kind_np == KIND_MOVE, dir_dr[argc], 0),
            np.where(kind_np == KIND_MOVE, dir_dc[argc], 0),
        ],
        axis=1,
    ).astype(np.int32)
    vibe_np = np.asarray(program.action_is_vibe, dtype=bool)
    prio_np = np.asarray(program.action_priority)
    A = program.num_agents
    Sa = max(len(program.agent_stat_names), 1)
    tables = {}  # device -> action table tensor

    def one_hot(idx, n, like):
        """jax.nn.one_hot: out-of-range indices give an all-zero row."""
        lanes = torch.arange(n, dtype=idx.dtype, device=idx.device)
        return (idx[..., None] == lanes).to(like.dtype)

    def bookkeeping(state: EnvState, active, a, success, ar, ac, sstat, fstat):
        """Stats + last-action updates for a batch of agents
        (action_handler.hpp:78-105)."""
        stats = state.agent_stats  # [E, A, Sa]
        sid = torch.where(success, sstat, fstat)
        stats = stats + torch.where(active[..., None], one_hot(sid, Sa, stats), 0.0)
        failed = (active & ~success).to(stats.dtype)
        stats = stats.clone()
        stats[..., program.stat_action_failed] += failed

        same = (ar == state.agent_action_prev_r) & (ac == state.agent_action_prev_c)
        new_swm = torch.where(same, state.agent_swm + 1, 0).to(torch.int32)
        max_swm = stats[..., program.stat_max_swm]
        stats[..., program.stat_max_swm] = torch.where(
            active & same & (new_swm > max_swm), new_swm.to(stats.dtype), max_swm
        )
        return state._replace(
            agent_stats=stats,
            agent_swm=torch.where(active, new_swm, state.agent_swm),
            agent_action_prev_r=torch.where(active, ar, state.agent_action_prev_r),
            agent_action_prev_c=torch.where(active, ac, state.agent_action_prev_c),
            agent_last_action=torch.where(active & success, a, state.agent_last_action),
            action_success=state.action_success | (active & success),
        )

    def pure_waves(tcell, pos0, can, move_mask, earlier):
        """Settle movers in waves. x waits while an earlier unsettled mover y
        exists that affects x's target (t_y == t_x: may arrive; p_y == t_x:
        may vacate) or would be affected by x's move (p_x == t_y). Each wave
        settles at least the earliest unsettled agent of every env. Under a
        CUDA graph capture (engine/step_graphs.py) the loop after the
        unrolled waves is cut at its reads."""
        ty = tcell[:, None, :]  # [E, x, y]
        tx = tcell[:, :, None]

        def wave(pos, unsettled, success):
            py = pos[:, None, :]
            px = pos[:, :, None]
            dep = (unsettled[:, None, :] & earlier & ((ty == tx) | (py == tx) | (px == ty))).any(dim=-1)
            settle = unsettled & ~dep
            occ = (py == tx).any(dim=-1)
            succ = settle & can & ~occ
            return torch.where(succ, tcell, pos), unsettled & ~settle, success | succ

        carry = (pos0, move_mask, torch.zeros_like(move_mask))
        for _ in range(PURE_UNROLL_WAVES):
            carry = wave(*carry)
        recorder = step_graphs.capturing()
        if recorder is not None:
            pos, _, success = recorder.wave_loop(
                wave, carry, lambda c: c[1].any(), "actions.pure_waves", "actions.waves", PURE_UNROLL_WAVES
            )
            return pos, success
        waves = PURE_UNROLL_WAVES
        while trace.host_read(carry[1].any(), "actions.pure_waves"):
            carry = wave(*carry)
            waves += 1
        trace.count("actions.waves", waves)
        return carry[0], carry[2]

    def action_phase(state: EnvState, actions, vibe_actions, perm) -> EnvState:
        E = actions.shape[0]
        dev = actions.device
        if dev not in tables:
            tables[dev] = torch.from_numpy(table_np).to(dev)
        TB = tables[dev]
        iota_a = torch.arange(A, dtype=torch.int32, device=dev)
        # rank[e, agent] = position of the agent in the shuffled order.
        rank = torch.where(perm[:, :, None] == iota_a[None, None, :], iota_a[None, :, None], 0).sum(dim=1)

        def decode(acts_in):
            valid_ = (acts_in >= 0) & (acts_in < n_actions)
            a_ = acts_in.clamp(0, n_actions - 1).to(torch.int32)
            return valid_, a_, TB[a_.long()]

        dec = {False: decode(actions), True: decode(vibe_actions)}

        # Invalid action indices: the reference increments the stat once per
        # priority level per stream (mettagrid_c.cpp:914-918, 966-998).
        f32 = state.agent_stats.dtype
        inv_count = ((~dec[False][0]).to(f32) + (~dec[True][0]).to(f32)) * float(program.num_priority_levels)
        stats = state.agent_stats.clone()
        stats[..., program.stat_action_invalid] += inv_count
        state = state._replace(agent_stats=stats)

        for prio in program.priorities_desc:
            for vibe_stream in (False, True):
                sel = (vibe_np == vibe_stream) & (prio_np == prio)
                stream_has_move = bool(np.any(kind_np[sel] == KIND_MOVE))
                stream_has_noop = bool(np.any(kind_np[sel] == KIND_NOOP))
                stream_has_cv = bool(np.any(kind_np[sel] == KIND_CHANGE_VIBE))
                if not (stream_has_move or stream_has_noop or stream_has_cv) and vibe_stream:
                    continue

                valid, a, f = dec[vibe_stream]
                stream_ok = f[..., 2] == (1 if vibe_stream else 0)
                active = valid & stream_ok & (f[..., 3] == prio)
                sstat, fstat = f[..., 4], f[..., 5]
                kind, arg = f[..., 0], f[..., 1]

                # --- non-interacting kinds settle immediately ---
                settled_now = torch.zeros_like(active)
                succ_now = torch.zeros_like(active)
                if stream_has_cv:
                    cv_mask = active & (kind == KIND_CHANGE_VIBE)
                    vibe = state.obj_vibe.clone()
                    vibe[:, :A] = torch.where(cv_mask, arg, vibe[:, :A])
                    state = state._replace(obj_vibe=vibe)
                    settled_now = settled_now | cv_mask
                    succ_now = succ_now | cv_mask
                if stream_has_noop:
                    noop_mask = active & (kind == KIND_NOOP)
                    settled_now = settled_now | noop_mask
                    succ_now = succ_now | noop_mask

                r_base = state.obj_r[:, :A]
                c_base = state.obj_c[:, :A]
                H, W = state.grid.shape[1], state.grid.shape[2]
                if program.move_handlers and stream_has_move and pure_move:
                    # --- pure relocation: each agent's target cell is fixed at
                    # phase start, so the waves are [E, A] cell-id arithmetic;
                    # the grid is read once (static occupancy) ---
                    move_mask = active & (kind == KIND_MOVE)
                    tr = r_base + f[..., 6]
                    tc = c_base + f[..., 7]
                    inb = (tr >= 0) & (tr < H) & (tc >= 0) & (tc < W)
                    static_occ = inb & (grid_read(state.grid, tr, tc) >= A)
                    tcell = torch.where(move_mask & inb, tr * W + tc, -1)
                    alive_a = state.obj_alive[:, :A]
                    pos0 = torch.where(alive_a, r_base * W + c_base, -2)
                    can = move_mask & inb & ~static_occ & alive_a
                    earlier = rank[:, None, :] < rank[:, :, None]  # [E, i, j]
                    pos, move_succ = pure_waves(tcell, pos0, can, move_mask, earlier)

                    new_r = torch.where(move_succ, torch.div(pos, W, rounding_mode="floor"), r_base)
                    new_c = torch.where(move_succ, torch.remainder(pos, W), c_base)
                    obj_r = state.obj_r.clone()
                    obj_c = state.obj_c.clone()
                    obj_r[:, :A] = new_r
                    obj_c[:, :A] = new_c
                    grid = state.grid
                    if not lazy_grid:
                        grid = grid_write(grid, r_base, c_base, -1, move_succ)
                        grid = grid_write(grid, new_r, new_c, iota_a.expand(E, A), move_succ)
                    state = state._replace(grid=grid, obj_r=obj_r, obj_c=obj_c)
                    settled_all = settled_now | move_mask
                    succ_all = succ_now | move_succ
                    r_at = torch.where(move_mask, new_r, r_base)
                    c_at = torch.where(move_mask, new_c, c_base)
                elif program.move_handlers and stream_has_move and sched_ok:
                    # --- exact footprint schedule: wave indices from the
                    # phase-start cells ([E, A, A] boolean math), then one
                    # handler-chain batch per wave. x waits for an earlier
                    # unsettled y when t_y == t_x, p_y == t_x or p_x == t_y
                    # (footprint_schedule_ok) ---
                    move_mask = active & (kind == KIND_MOVE)
                    dr, dc = f[..., 6], f[..., 7]
                    tr = r_base + dr
                    tc = c_base + dc
                    inb = (tr >= 0) & (tr < H) & (tc >= 0) & (tc < W)
                    # Distinct negative sentinels for off-grid targets, so two
                    # such movers do not wait on t_y == t_x.
                    tcell = torch.where(move_mask & inb, tr * W + tc, -2 - iota_a[None, :])
                    pcell = r_base * W + c_base
                    ty, tx = tcell[:, None, :], tcell[:, :, None]  # [E, x, y]
                    py, px = pcell[:, None, :], pcell[:, :, None]
                    earlier = rank[:, None, :] < rank[:, :, None]
                    conflict = earlier & ((ty == tx) | (py == tx) | (px == ty))
                    # One host read per wave: the loop ends when every mover
                    # has a wave (each wave settles the earliest unsettled
                    # mover of every env).
                    unsettled = move_mask
                    wave_idx = torch.zeros((E, A), dtype=torch.int32, device=dev)
                    n_waves = 0
                    while trace.host_read(unsettled.any(), "actions.footprint_waves"):
                        settle = unsettled & ~(conflict & unsettled[:, None, :]).any(dim=-1)
                        wave_idx = torch.where(settle, n_waves, wave_idx)
                        unsettled = unsettled & ~settle
                        n_waves += 1
                    move_succ = torch.zeros_like(move_mask)
                    r_rec, c_rec = r_base, c_base
                    for w in range(n_waves):
                        settle = move_mask & (wave_idx == w)
                        state, succ = apply_move_batch(state, settle, dr, dc)
                        r_rec = torch.where(settle, state.obj_r[:, :A], r_rec)
                        c_rec = torch.where(settle, state.obj_c[:, :A], c_rec)
                        move_succ = move_succ | succ
                    trace.count("actions.waves", n_waves)
                    settled_all = settled_now | move_mask
                    succ_all = succ_now | move_succ
                    r_at = torch.where(move_mask, r_rec, r_base)
                    c_at = torch.where(move_mask, c_rec, c_base)
                elif program.move_handlers and stream_has_move:
                    # --- Chebyshev waves (reference actions_fast.py:837-877):
                    # an agent settles once no earlier-ranked unsettled agent
                    # lies within r_int of it, distances taken from the
                    # current cells; one host read per wave. Where a swap
                    # is reachable the agents that act without moving
                    # (noop) wait their turn too, as a swap can move them
                    # before it, and their cell is recorded at it, as the
                    # sequential phase records it (the reference records
                    # their phase-start cell) ---
                    move_mask = active & (kind == KIND_MOVE)
                    dr, dc = f[..., 6], f[..., 7]
                    earlier = rank[:, None, :] < rank[:, :, None]  # [E, x, y]
                    unsettled = move_mask | settled_now if swaps else move_mask
                    move_succ = torch.zeros_like(move_mask)
                    r_rec, c_rec = r_base, c_base
                    while trace.host_read(unsettled.any(), "actions.chebyshev_waves"):
                        ar, ac = state.obj_r[:, :A], state.obj_c[:, :A]
                        near = torch.maximum(
                            (ar[:, :, None] - ar[:, None, :]).abs(), (ac[:, :, None] - ac[:, None, :]).abs()
                        ) <= r_int
                        settle = unsettled & ~(near & earlier & unsettled[:, None, :]).any(dim=-1)
                        state, succ = apply_move_batch(state, settle & move_mask, dr, dc)
                        r_rec = torch.where(settle, state.obj_r[:, :A], r_rec)
                        c_rec = torch.where(settle, state.obj_c[:, :A], c_rec)
                        unsettled = unsettled & ~settle
                        move_succ = move_succ | succ
                        trace.count("actions.waves")
                    settled_all = settled_now | move_mask
                    succ_all = succ_now | move_succ
                    r_at, c_at = r_rec, c_rec
                else:
                    settled_all, succ_all, r_at, c_at = settled_now, succ_now, r_base, c_base

                state = bookkeeping(state, settled_all, a, succ_all, r_at, c_at, sstat, fstat)
        return state

    return action_phase
