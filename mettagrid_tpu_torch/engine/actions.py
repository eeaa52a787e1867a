"""The sequential action phase: one agent rank at a time, across all envs.

Counterpart of the reference's engine/actions.py. The C++ engine applies
actions in shuffled order with immediate effect (mettagrid_c.cpp:957-998):
later agents see earlier agents' moves. Here a Python loop walks the A
ranks of the permutation; each iteration applies one agent's action in
every env at once, so the conflict semantics are exact while the env axis
stays batched. Priority levels run from highest to lowest; within each
level, the primary stream and then the vibe stream.

The step takes this phase where the wave phase (engine/actions_fast.py)
cannot prove itself sequential-equivalent (actions_fast.fast_mode_ok
fails), and under the reference-RNG step where action handlers draw from
the MT19937 twin (rng_dep.actions_consume_rng): the twin's draws must come
in the reference's per-agent order.
"""

from __future__ import annotations

import numpy as np
import torch

from mettagrid_tpu_torch.engine.exec import Ctx, MtThread, device_table, eval_filters, gather, grid_read, scatter
from mettagrid_tpu_torch.engine.handlers import apply_mutations
from mettagrid_tpu_torch.engine.program import DIR_DC, DIR_DR, KIND_CHANGE_VIBE, KIND_MOVE, KIND_NOOP, EngineProgram
from mettagrid_tpu_torch.engine.state import EnvState
from mettagrid_tpu_torch.profiling import trace

_I32 = torch.int32


def apply_move(program: EngineProgram, state: EnvState, agent_slot, arg, active, mtd=None):
    """One agent's move per env through the compiled move-handler chain
    (reference: actions/move.hpp:81-115). Per handler, a line scan in the
    move direction: accepts_empty handlers take the first in-bounds cell,
    the others the first occupied cell within max_range (scanning past empty
    cells, stopping at the map's edge). The first handler whose filters pass
    and whose mutations apply wins. Returns (state, success bool[E]).

    mtd: the draw source (exec.MtThread or exec.RankDraws); a handler's
    draws are gated on its chain being tried for that env (a cell found and
    no earlier handler succeeded), as the C++ per-agent walk."""
    E = state.grid.shape[0]
    H, W = state.grid.shape[1], state.grid.shape[2]
    dev = state.grid.device
    ar = gather(state.obj_r, agent_slot)
    ac = gather(state.obj_c, agent_slot)
    a = arg.clamp(0, len(DIR_DR) - 1).long()
    dr = device_table(program, DIR_DR, dev)[a]
    dc = device_table(program, DIR_DC, dev)[a]

    success = torch.zeros(E, dtype=torch.bool, device=dev)
    for mh in program.move_handlers:
        if mh.accepts_empty:
            cand_r, cand_c = ar + dr, ac + dc
            found = active & (cand_r >= 0) & (cand_r < H) & (cand_c >= 0) & (cand_c < W)
            cand_dist = torch.ones(E, dtype=_I32, device=dev)
        else:
            found = torch.zeros(E, dtype=torch.bool, device=dev)
            blocked = torch.zeros(E, dtype=torch.bool, device=dev)
            cand_r = torch.zeros(E, dtype=_I32, device=dev)
            cand_c = torch.zeros(E, dtype=_I32, device=dev)
            cand_dist = torch.ones(E, dtype=_I32, device=dev)
            for i in range(1, mh.max_range + 1):
                cr, cc = ar + dr * i, ac + dc * i
                inb = (cr >= 0) & (cr < H) & (cc >= 0) & (cc < W)
                blocked = blocked | ~inb
                occupied = inb & ~blocked & (grid_read(state.grid, cr, cc) >= 0)
                newly = occupied & ~found
                cand_r = torch.where(newly, cr, cand_r)
                cand_c = torch.where(newly, cc, cand_c)
                cand_dist = torch.where(newly, i, cand_dist).to(_I32)
                found = found | newly
            found = found & active

        target = torch.where(found, grid_read(state.grid, cand_r, cand_c), -1)
        ctx = Ctx(
            actor=agent_slot, target=target, target_r=cand_r, target_c=cand_c, distance=cand_dist,
            timestep=state.step_count,
        )
        try_mask = found & ~success
        if mtd is None:
            passed = try_mask & eval_filters(program, state, ctx, mh.handler.filters)
            state, applied = apply_mutations(program, state, ctx, mh.handler, passed)
        else:
            with mtd.narrowed(try_mask):
                passed = try_mask & eval_filters(program, state, ctx, mh.handler.filters, mtd)
                with mtd.narrowed(passed):
                    state, applied = apply_mutations(program, state, ctx, mh.handler, passed, mtd)
        success = success | applied
    return state, success


def make_action_phase(program: EngineProgram, reference_rng: bool = False):
    """Returns action_phase(state, actions, vibe_actions, perm, draws=None)
    -> state over every priority level and both streams.

    reference_rng: every handler evaluation threads the MT19937 twin
    (state.mt) in an exec.MtThread, so order_by=random queries in action
    filters, values and mutations draw in the reference's sequential order
    (core/query_system.cpp:78-79 via HandlerContext::rng). Otherwise
    ``draws`` (an exec.RankDraws, or None where no action handler draws)
    serves them."""
    n_actions = len(program.action_names)
    dev_tables = {}
    A = program.num_agents
    Sa = max(len(program.agent_stat_names), 1)

    def tables(dev):
        if dev not in dev_tables:
            dev_tables[dev] = {
                name: torch.from_numpy(np.asarray(getattr(program, name)).copy()).to(dev)
                for name in ("action_kind", "action_arg", "action_is_vibe", "action_priority",
                             "action_success_stat", "action_fail_stat")
            }
        return dev_tables[dev]

    def apply_one(state: EnvState, agent_slot, action, prio: int, vibe_stream: bool, draws):
        """One (agent, action) per env (reference process_action_stream,
        mettagrid_c.cpp:969-991)."""
        E = state.grid.shape[0]
        t = tables(state.grid.device)
        valid = (action >= 0) & (action < n_actions)
        a = action.clamp(0, n_actions - 1).long()
        active = valid & (t["action_is_vibe"][a] == vibe_stream) & (t["action_priority"][a] == prio)
        if not trace.host_read(active.any(), "actions.sequential_active"):
            return state  # no env acts: every write below is masked off
        kind = t["action_kind"][a]
        arg = t["action_arg"][a]
        mtd = MtThread(state.mt, torch.ones((E,), dtype=torch.bool, device=state.grid.device)) if reference_rng else draws

        success = active & (kind == KIND_NOOP)
        state, move_succ = apply_move(program, state, agent_slot, arg, active & (kind == KIND_MOVE), mtd)
        success = success | move_succ
        if reference_rng:
            state = state._replace(mt=mtd.mt)

        cv_mask = active & (kind == KIND_CHANGE_VIBE)
        state = state._replace(obj_vibe=scatter(state.obj_vibe, agent_slot, arg, cv_mask))
        success = success | cv_mask  # ChangeVibe always succeeds (actions/change_vibe.hpp:25-60)

        # --- per-invocation bookkeeping (action_handler.hpp:78-105) ---
        stats = gather(state.agent_stats, agent_slot)  # [E, Sa]
        sid = torch.where(success, t["action_success_stat"][a], t["action_fail_stat"][a]).long()
        onehot = torch.nn.functional.one_hot(sid, Sa).to(stats.dtype)
        stats = stats + torch.where(active[:, None], onehot, 0.0)
        stats[:, program.stat_action_failed] += (active & ~success).to(stats.dtype)
        ar = gather(state.obj_r, agent_slot)
        ac = gather(state.obj_c, agent_slot)
        pr = gather(state.agent_action_prev_r, agent_slot)
        pc = gather(state.agent_action_prev_c, agent_slot)
        swm = gather(state.agent_swm, agent_slot)
        same = (ar == pr) & (ac == pc)
        new_swm = torch.where(same, swm + 1, 0).to(_I32)
        max_swm = stats[:, program.stat_max_swm]
        stats[:, program.stat_max_swm] = torch.where(
            active & same & (new_swm > max_swm), new_swm.to(stats.dtype), max_swm
        )
        last = gather(state.agent_last_action, agent_slot)
        return state._replace(
            agent_stats=scatter(state.agent_stats, agent_slot, stats, active),
            agent_swm=scatter(state.agent_swm, agent_slot, new_swm, active),
            agent_action_prev_r=scatter(state.agent_action_prev_r, agent_slot, ar, active),
            agent_action_prev_c=scatter(state.agent_action_prev_c, agent_slot, ac, active),
            agent_last_action=scatter(state.agent_last_action, agent_slot, torch.where(success, a.to(_I32), last), active),
            action_success=scatter(
                state.action_success, agent_slot, gather(state.action_success, agent_slot) | success, active
            ),
        )

    def action_phase(state: EnvState, actions, vibe_actions, perm, draws=None) -> EnvState:
        """actions/vibe_actions: int32[E, A]; perm: int32[E, A], the agent
        acting at each rank."""
        # An invalid index counts once per priority level (always >= 2:
        # Attack registers at priority 1 even disabled) per stream
        # (mettagrid_c.cpp:914-918, 966-998).
        f = state.agent_stats.dtype
        bad = ((actions < 0) | (actions >= n_actions)).to(f) + ((vibe_actions < 0) | (vibe_actions >= n_actions)).to(f)
        stats = state.agent_stats.clone()
        stats[..., program.stat_action_invalid] += bad * float(program.num_priority_levels)
        state = state._replace(agent_stats=stats)
        for prio in program.priorities_desc:
            for vibe_stream, acts in ((False, actions), (True, vibe_actions)):
                for i in range(A):
                    agent = perm[:, i].contiguous()
                    state = apply_one(state, agent, acts.gather(1, agent[:, None].long())[:, 0], prio, vibe_stream, draws)
        return state

    return action_phase
