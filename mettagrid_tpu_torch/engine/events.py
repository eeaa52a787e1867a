"""Timestep-triggered events (reference: handler/event_scheduler.hpp:31-62,
src/.../handler/event.cpp:34-96).

Counterpart of the reference's engine/events.py. Each event's firing
schedule is a static boolean table indexed by step_count; the event applies
to all query targets at once: an [E, N] target mask, filters evaluated with
actor = target = the object, mutations applied densely. max_targets keeps
the targets of smallest random rank among the filter-passing ones.

Under the reference-RNG step the events draw from the MT19937 twin
(engine/mt19937.py) as Event::execute does (event.cpp:38-56): an
order_by=random target query shuffles its results, then a target list
longer than max_targets is shuffled and the first max_targets targets whose
filters pass apply. A handler that itself draws walks its targets one at a
time (_apply_event_sequential).
"""

from __future__ import annotations

import numpy as np
import torch

from mettagrid_tpu_torch.engine.exec import (
    Ctx,
    MtThread,
    device_table,
    eval_filters,
    eval_query_mask,
    eval_query_mask_unlimited,
    gather,
    query_cap,
)
from mettagrid_tpu_torch.engine.handlers import apply_mutation, set_game_stat
from mettagrid_tpu_torch.engine.mt19937 import shuffle_perm
from mettagrid_tpu_torch.engine.rng_dep import handler_consumes
from mettagrid_tpu_torch.engine.program import EngineProgram
from mettagrid_tpu_torch.engine.state import EnvState
from mettagrid_tpu_torch.profiling import trace


def _fire_table(program: EngineProgram, timesteps: tuple[int, ...]) -> np.ndarray:
    """Static bool[max_steps+2] table: does this event fire at step t?"""
    horizon = (program.max_steps if program.max_steps > 0 else 100000) + 2
    table = np.zeros(horizon, dtype=bool)
    for t in timesteps:
        if 0 <= t < horizon:
            table[t] = True
    return table


def _apply_query_limits_mt(program, state: EnvState, q, mask: torch.Tensor, active: torch.Tensor):
    """The reference-RNG twin of exec._apply_query_limits for an event's
    target query (reference events.py:34-78): with order_by=random, a
    std::shuffle of the result vector from the MT19937 twin where active,
    then the max_items resize (query_system.cpp:75-87).

    Returns (state, mask, order): order[e, s] is slot s's position in the
    reference's result vector (the event's own shuffle permutes that
    vector); the surviving positions are 0..count-1."""
    E, N = mask.shape
    m = mask.to(torch.int32)
    rank = m.cumsum(dim=1, dtype=torch.int32) - m  # registration-order rank
    if not q.order_random:
        cap = query_cap(program, state, q, E, N, None, None)
        return state, mask if cap is None else mask & (rank < cap[:, None]), rank
    # The C++ order: the shuffle first (even uncapped), then max_items.
    mt, perm = shuffle_perm(state.mt, m.sum(dim=1), N, active)
    mtd = MtThread(mt, active)
    cap = query_cap(program, state, q, E, N, None, mtd)
    state = state._replace(mt=mtd.mt)
    if cap is None:
        cap = torch.full((E,), N, dtype=torch.int32, device=mask.device)
    pos = perm.argsort(dim=1).to(torch.int32).gather(1, rank.long())  # slot -> shuffled position
    return state, mask & (pos < cap[:, None]), pos


def _targets_mt(program, state: EnvState, ev, env_fire: torch.Tensor):
    """The event's targets under the reference-RNG step: (state, targets
    bool[E, N], order int32[E, N]). The query's nested queries draw first,
    where the event fires (a filtered, closure or raycast source evaluates
    them before the top-level shuffle), then its own limits."""
    mtd = MtThread(state.mt, env_fire)
    raw = eval_query_mask_unlimited(program, state, ev.target_query, None, mtd)
    state = state._replace(mt=mtd.mt)
    return _apply_query_limits_mt(program, state, ev.target_query, raw, env_fire)


def _event_order(state: EnvState, ev, targets, order, env_fire):
    """The max_targets shuffle of the target vector (event.cpp:41-44: only
    when it is longer than max_targets): (state, pos int32[E, N]), each
    target slot's position in application order."""
    N = targets.shape[1]
    pos = torch.where(targets, order, N - 1)
    if ev.max_targets > 0:
        n_t = targets.sum(dim=1, dtype=torch.int32)
        do_shuf = env_fire & (n_t > ev.max_targets)
        mt, perm = shuffle_perm(state.mt, n_t, N, do_shuf)
        state = state._replace(mt=mt)
        inv = perm.argsort(dim=1).to(torch.int32)
        pos = torch.where(do_shuf[:, None], inv.gather(1, pos.long()), pos)
    return state, pos


def _apply_event_sequential(program, state: EnvState, ev, env_fire: torch.Tensor):
    """The reference-RNG path for an event whose handler draws (reference
    events.py:80-150): the C++ engine walks the target vector and runs
    try_apply per target (event.cpp:46-55), so the handler draws once per
    visited target in application order, and targets past the max_targets
    cap are never visited. A loop over application positions with [E]
    contexts threading the twin. Returns (state, applied[E])."""
    E, N = state.obj_type.shape
    dev = state.obj_type.device
    state, targets, order = _targets_mt(program, state, ev, env_fire)
    state, pos = _event_order(state, ev, targets, order, env_fire)
    # The slot at each application position, -1 where none.
    slots_i = torch.arange(N, dtype=torch.int32, device=dev)
    at = targets[:, :, None] & (pos[:, :, None] == slots_i[None, None, :])  # [E, slot, position]
    order_slots = torch.where(at, slots_i[None, :, None] + 1, 0).sum(dim=1, dtype=torch.int32) - 1  # [E, position]
    applied = torch.zeros((E,), dtype=torch.int32, device=dev)
    for p in range(N):
        slot = order_slots[:, p]
        can = env_fire & (slot >= 0)
        if ev.max_targets > 0:
            can = can & (applied < ev.max_targets)
        if not trace.host_read(can.any(), "events.mt_visit"):
            continue  # no env visits a target here: nothing applies or draws
        s = slot.clamp(0, N - 1)
        ctx = Ctx(
            actor=s, target=s, target_r=gather(state.obj_r, s), target_c=gather(state.obj_c, s),
            distance=torch.zeros((E,), dtype=torch.int32, device=dev), timestep=state.step_count,
        )
        mtd = MtThread(state.mt, can)
        passed = can & eval_filters(program, state, ctx, ev.handler.filters, mtd)
        with mtd.narrowed(passed):
            for m in ev.handler.mutations:
                state, _ = apply_mutation(program, state, ctx, m, passed, mtd)
        state = state._replace(mt=mtd.mt)
        applied = applied + passed.to(torch.int32)
    return state, applied


def _apply_event(program, state: EnvState, ev, ranks, env_fire: torch.Tensor, reference_rng: bool = False, draws=None):
    """Apply one event where env_fire[e]. ranks: f32[E, N] random ranks of
    the targets (used when max_targets > 0, outside the reference-RNG step);
    draws: the draw source of an order_by=random target query there
    (exec.RankDraws). Returns (state, applied[E])."""
    E, N = state.obj_type.shape
    dev = state.obj_type.device
    if reference_rng and handler_consumes(ev.handler, program):
        return _apply_event_sequential(program, state, ev, env_fire)
    if reference_rng:
        draws = None
        state, targets, order = _targets_mt(program, state, ev, env_fire)
    else:
        targets = eval_query_mask(program, state, ev.target_query, None, draws)  # [E, N]
    slots = torch.arange(N, dtype=torch.int32, device=dev)[None, :].expand(E, N)
    ctx = Ctx(
        actor=slots,
        target=slots,
        target_r=state.obj_r,
        target_c=state.obj_c,
        distance=torch.zeros((E, N), dtype=torch.int32, device=dev),
        timestep=state.step_count,
        dense_identity=True,
    )
    # Under reference_rng this handler does not draw (else the sequential
    # path above); otherwise its random queries draw from ``draws``.
    passed = targets & env_fire[:, None] & eval_filters(program, state, ctx, ev.handler.filters, draws)
    if ev.max_targets > 0 and reference_rng:
        # Walk the shuffled target vector, applying the first max_targets
        # targets whose filters pass (failures do not count against the cap).
        state, pos = _event_order(state, ev, targets, order, env_fire)
        at = (pos[:, :, None] == torch.arange(N, dtype=torch.int32, device=dev)) & targets[:, :, None]  # [E, s, p]
        pass_at_pos = (at & passed[:, :, None]).sum(dim=1, dtype=torch.int32)  # [E, p]
        kept_at_pos = (pass_at_pos > 0) & (pass_at_pos.cumsum(dim=1) <= ev.max_targets)
        passed = passed & kept_at_pos.gather(1, pos.long())
    elif ev.max_targets > 0:
        # Keep the max_targets passing targets of smallest rank; a strict
        # compare, as the reference's (ties keep both).
        r = torch.where(passed, ranks, float("inf"))
        before = (r[:, :, None] > r[:, None, :]).sum(dim=-1)  # [E, N]
        passed = passed & (before < ev.max_targets)
    # Every mutation applies to every selected target (event.cpp:65-84 has
    # no failure checks).
    for m in ev.handler.mutations:
        state, _ = apply_mutation(program, state, ctx, m, passed, draws)
    return state, passed.sum(dim=1, dtype=torch.int32)


def make_event_phase(program: EngineProgram, reference_rng: bool = False):
    """Returns event_phase(state, ranks, draws=None) -> state, or None
    without events.

    ranks: f32[E, n_ev * (depth + 1), N] with values in [0, 1): the target
    ranks of event i at fallback level l in column l * n_ev + i (depth: the
    longest fallback chain). event_phase.num_rank_rows gives the middle
    size; the step draws them, or takes them from its caller. draws: the
    draw source of order_by=random target queries (exec.RankDraws).

    reference_rng: the events draw from the MT19937 twin (state.mt) in the
    reference's stream order (the agent shuffle first, then events in
    declaration order), and ranks and draws are None. The reference's known
    deviation holds here too (its events.py:245-250): the C++ engine runs a
    fallback event inside the failing one, so its draws land before the next
    declared event's, while this unroll runs every level-0 event first."""
    if not program.events:
        return None
    tables = [_fire_table(program, ev.timesteps) for ev in program.events]
    horizon = tables[0].shape[0]
    n_ev = len(program.events)

    # Fallback chains recurse in the reference (event.cpp:57-60); unroll to
    # the longest acyclic fallback path so N-deep chains fire in one step.
    depth = 0
    for i in range(n_ev):
        d, j, seen = 0, program.events[i].fallback, set()
        while j >= 0 and j not in seen and d < n_ev:
            seen.add(j)
            d += 1
            j = program.events[j].fallback
        depth = max(depth, d)

    def event_phase(state: EnvState, ranks, draws=None) -> EnvState:
        E = state.obj_type.shape[0]
        dev = state.obj_type.device
        t = state.step_count.clamp(0, horizon - 1).long()
        pending = [torch.zeros(E, dtype=torch.bool, device=dev) for _ in range(n_ev)]
        for level in range(depth + 1):
            cur = pending
            pending = [torch.zeros(E, dtype=torch.bool, device=dev) for _ in range(n_ev)]
            for i, ev in enumerate(program.events):
                fire = device_table(program, tables[i], dev)[t] if level == 0 else cur[i]
                rank = None if reference_rng else ranks[:, level * n_ev + i]
                state, applied = _apply_event(program, state, ev, rank, fire, reference_rng, draws)
                state = set_game_stat(state, fire, ev.stat_id, applied.to(torch.float32), mode="add")
                if ev.fallback >= 0:
                    pending[ev.fallback] = pending[ev.fallback] | (fire & (applied == 0))
        return state

    event_phase.num_rank_rows = n_ev * (depth + 1)
    return event_phase
