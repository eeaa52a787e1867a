"""Reset and step: E envs stepping in lockstep on one device.

Counterpart of the reference's engine/step.py. Phase order follows the
reference MettaGrid::_step (cpp/bindings/mettagrid_c.cpp:921-1102):
auto-reset (PufferEnv level) -> snapshot prev locations -> zero
rewards/success -> step++ -> shuffled action streams by priority -> events
-> agent on_tick -> AOE effects -> territory effects -> game on_tick ->
observations -> coverage, visited and token stats -> rewards -> truncation.

The action phase is the wave phase (engine/actions_fast.py: pure-move waves
or footprint-scheduled handler-chain waves) where it is provably
sequential-equivalent, else the sequential phase (engine/actions.py).
Events, agent and game on_tick handlers, AOE and territories
(engine/aoe.py, engine/territory.py) follow, and observations over a static
or a mutable background through every route of engine/obs.py (the fused
tails, the opt-in v3 tails, and the non-fused path for the AOE mask and
window rows wider than 128 lanes).

reference_rng=True is the reference's reference-RNG step: a per-env
MT19937 twin (engine/mt19937.py, state.mt) draws the agent order, the
events' shuffles and the order_by=random queries in the C++ engine's
stream order. Every phase works out of place: an eager step never writes
the tensors of the state it was given (the one exception is the carried
observation buffer, see make_step).

Each phase runs in a span of profiling/trace.py (``step.auto_reset``,
``step.actions``, ... ``step.rewards``, also torch.profiler ranges); make_reset,
make_step, the first reset and the first step are the set-up spans
``setup.make_reset``, ``setup.make_step``, ``setup.reset`` and
``setup.first_step``, and every later step call is counted as ``step.calls``.

On a CUDA device, a program that graphs_ok admits (the pure-move waves and
no phase or query that reads the host or draws) replays its step as CUDA
graphs, one or more per phase span, captured once in the set-up span
``setup.graph_capture`` (engine/step_graphs.py): the same kernels and
results, each replayed call counted as ``step.graph_replays``. **On that
path the state and outputs a step returns are the graphs' own buffers,
valid until the step's next call** (as the carried observation buffer
always is); the step writes them in place, and a caller that keeps one
across calls clones it. make_step's docstring says which calls replay.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from mettagrid_tpu_torch.engine import step_graphs
from mettagrid_tpu_torch.engine.actions import make_action_phase
from mettagrid_tpu_torch.engine.actions_fast import (
    batch_gridless,
    fast_mode_ok,
    make_action_phase_fast,
    pure_move_ok,
    reads_grid,
)
from mettagrid_tpu_torch.engine.aoe import make_aoe_phase
from mettagrid_tpu_torch.engine.events import make_event_phase
from mettagrid_tpu_torch.engine.exec import Ctx, MtThread, RankDraws
from mettagrid_tpu_torch.engine.handlers import recompute_materialized, try_apply
from mettagrid_tpu_torch.engine.init import EnvInit, stat_dims
from mettagrid_tpu_torch.engine.ir import CompiledQuery, reaches
from mettagrid_tpu_torch.engine.mt19937 import mt_init, shuffle_perm
from mettagrid_tpu_torch.engine import mutfields
from mettagrid_tpu_torch.engine.mutfields import POOL_FIELDS, maybe_written_pool_fields
from mettagrid_tpu_torch.engine.obs import build_static_bg, build_static_mask, make_obs_fn
from mettagrid_tpu_torch.engine.program import AUTO_STAT_BASE, EngineProgram
from mettagrid_tpu_torch.engine.rewards import make_reward_phase
from mettagrid_tpu_torch.engine.rng_dep import actions_consume_rng, handler_consumes, reference_rng_unsupported
from mettagrid_tpu_torch.engine.state import EnvState, StepOutputs, resolve_device
from mettagrid_tpu_torch.engine.territory import make_territory_phase
from mettagrid_tpu_torch.profiling import trace

# In-step auto-reset merge classes (reference step.py:46-76): fields whose
# fresh value is a broadcastable constant, and the map-derived pool tables.
# Every other field is dead at the merge point (the reset phase overwrites it
# before any read), handled specially (rng, map_idx, stats), or carried (mt).
_CONST_RESETS = dict(
    agent_swm=0,
    episode_rewards=0.0,
    reward_prev=0.0,
    obj_visited=0,
    terminals=False,
    truncations=False,
    step_count=0,
    aoe_inside=False,
    territory_inside=-1,
)
_POOL_RESET_FIELDS = (
    "grid", "obj_type", "obj_r", "obj_c", "obj_vibe", "obj_tags", "obj_inv",
    "obj_alive", "agent_group", "agent_cfg", "agent_spawn_r", "agent_spawn_c",
    "agent_action_prev_r", "agent_action_prev_c", "agent_stats_touched",
    "visit_bitmap", "game_stats",
)
_DEAD_AT_RESET_MERGE = (
    "rewards", "action_success", "agent_last_action", "agent_prev_r",
    "agent_prev_c", "game_stats_prev", "agent_stats_prev", "auto_stats_prev",
    "obj_inv_prev",
)


def _device_init(program: EngineProgram, init: EnvInit, device) -> dict:
    """Upload the map pool (P maps) and the tables of the stats a fresh
    state starts touched to the device once."""
    pool = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in init.__dict__.items()
        if isinstance(v, np.ndarray)
    }
    for name in ("agent_stats_init_touched", "game_stats_init_touched"):
        pool[name] = torch.from_numpy(np.asarray(getattr(program, name))).to(device)
    return pool


class StepGates(NamedTuple):
    """make_step's set-up decisions for one program: the action phase from
    actions_fast's gates, the observations' static background and mask from
    the write analysis (engine/mutfields.py), and the lazy grid from both."""

    waves: bool  # the wave phase (actions_fast), else the sequential phase
    pure_move: bool  # the wave phase's pure-move waves
    lazy_grid: bool  # the pure-move waves skip the grid's agent layer
    lazy_agent_layer: bool  # the action phase leaves the agent layer stale
    static_bg: bool  # build_static_bg's pooled image serves the observations
    static_mask: bool  # build_static_mask's pooled AOE-mask source serves them


def step_gates(program: EngineProgram, action_mode: str = "auto", reference_rng: bool = False) -> StepGates:
    """make_step's gates for ``program`` under ``action_mode`` and
    ``reference_rng``. The action phase is the reference's choice
    (step.py:595-629)."""
    auto = action_mode == "auto"
    acts_consume = reference_rng and actions_consume_rng(program)
    waves = (action_mode in ("fast", "pure") or (auto and fast_mode_ok(program))) and not acts_consume
    pure = waves and (action_mode == "pure" or (auto and pure_move_ok(program)))
    static_bg = mutfields.static_background(program, pure_move_ok(program))
    # The lazy grid keeps the reference's gate: a static background with no
    # AOE or territory. A program that reads the grid (a raycast) keeps its
    # agent layer current; the reference's lazy grid ignores queries
    # (ROADMAP Queue 3).
    lazy_grid = pure and static_bg and not program.aoe_specs and not program.territories and not reads_grid(program)
    # Pure-move waves with the lazy grid, or handler-chain waves whose
    # batches run gridless.
    lazy_agent_layer = waves and (lazy_grid if pure else batch_gridless(program))
    return StepGates(waves, pure, lazy_grid, lazy_agent_layer, static_bg, mutfields.static_mask(program, static_bg))


def step_obs_fn(program: EngineProgram, init: EnvInit, device, obs_tail: str = "auto", draws=None, gates=None):
    """make_step's and make_reset's observation function: over the pooled
    static background and AOE-mask source where ``gates`` (make_step's, by
    default step_gates(program)) admit them."""
    gates = gates or step_gates(program)
    static_bg = build_static_bg(program, init, device) if gates.static_bg else None
    mask = build_static_mask(program, init, device) if gates.static_mask else None
    return make_obs_fn(program, static_bg, device, obs_tail, draws, static_mask=mask)


def _bit_words(cell: torch.Tensor, NW: int) -> torch.Tensor:
    """int32[..., NW]: bit (cell & 31) set in word (cell >> 5), as the
    reference's int32 left shift (bit 31 is the sign bit)."""
    bit = torch.bitwise_left_shift(torch.ones_like(cell, dtype=torch.int64), (cell & 31).long()).to(torch.int32)
    lanes = torch.arange(NW, dtype=cell.dtype, device=cell.device)
    return torch.where((cell >> 5)[..., None] == lanes, bit[..., None], 0)


def _fresh_state_from_pool(
    program: EngineProgram,
    pool: dict,
    map_idx: torch.Tensor,
    rng: torch.Tensor,
    init_token_stats: torch.Tensor = None,
    mt: torch.Tensor = None,
    draws: RankDraws = None,
) -> EnvState:
    """Per-env initial state gathered from the map pool (map_idx: int32[E];
    ``pool`` as _device_init gives it), with the materialized queries' tags
    computed on it (mettagrid_c.cpp:163, QuerySystem::compute_all;
    reference step.py:237-242).

    init_token_stats: optional f32[P, 3] (written, dropped, free) token sums
    of each pooled map's construction observation (mettagrid_c.cpp:271-319,
    655-661). mt: the MT19937 twin's state int64[E, 625] under the
    reference-RNG step, else none (an [E, 0] field). draws: the draw source
    of order_by=random materialized queries (exec.RankDraws; the twin is
    not drawn at construction, as in the reference)."""
    E = map_idx.shape[0]
    A = program.num_agents
    Sa, Sg = stat_dims(program)
    dev = map_idx.device
    idx = map_idx.long()

    def pick(name):
        return pool[name][idx]

    agent_r = pick("agent_r")
    agent_c = pick("agent_c")
    agent_cfg = pick("agent_cfg")
    H, W = pool["grid"].shape[1], pool["grid"].shape[2]
    NW = max((H * W + 31) // 32, 1)
    # Coverage: spawn cell pre-visited (objects/agent.cpp:41-47).
    bit_word = _bit_words(agent_r * W + agent_c, NW)
    obj_inv0 = pick("obj_inv")
    agent_stats0 = torch.zeros((E, A, Sa), dtype=torch.float32, device=dev)
    auto_stats0 = torch.zeros((E, A, program.num_auto_lanes), dtype=torch.int32, device=dev)
    if program.stats_compact:
        auto_stats0[..., program.stat_cell_unique - AUTO_STAT_BASE] = 1
    else:
        agent_stats0[..., program.stat_cell_unique] = 1.0
        R = program.num_resources
        if R:
            a0 = int(program.stat_inv_amount[0])
            agent_stats0[..., a0 : a0 + R] = obj_inv0[:, :A].to(torch.float32)
    init_t = pool["agent_stats_init_touched"]  # [n_cfg, Sa]
    if init_t.shape[0] == 1:
        agent_touched0 = init_t[0].expand(E, A, init_t.shape[1]).clone()
    else:
        agent_touched0 = init_t[agent_cfg.long()] > 0
    game_stats0 = pick("init_game_stats")
    if init_token_stats is not None:
        pts = init_token_stats[idx]  # [E, 3]
        game_stats0[:, program.stat_tokens_written] = pts[:, 0]
        game_stats0[:, program.stat_tokens_dropped] = pts[:, 1]
        game_stats0[:, program.stat_tokens_free] = pts[:, 2]
    game_touched0 = pool["game_stats_init_touched"].expand(E, Sg).clone()
    N = pool["obj_type"].shape[1]
    state = EnvState(
        grid=pick("grid"),
        obj_type=pick("obj_type"),
        obj_r=pick("obj_r"),
        obj_c=pick("obj_c"),
        obj_vibe=pick("obj_vibe"),
        obj_tags=pick("obj_tags"),
        obj_inv=obj_inv0,
        obj_alive=pick("obj_alive"),
        agent_group=pick("agent_group"),
        agent_cfg=agent_cfg,
        agent_spawn_r=agent_r,
        agent_spawn_c=agent_c,
        agent_prev_r=agent_r.clone(),
        agent_prev_c=agent_c.clone(),
        agent_last_action=torch.zeros((E, A), dtype=torch.int32, device=dev),
        action_success=torch.zeros((E, A), dtype=torch.bool, device=dev),
        agent_action_prev_r=agent_r.clone(),
        agent_action_prev_c=agent_c.clone(),
        agent_swm=torch.zeros((E, A), dtype=torch.int32, device=dev),
        aoe_inside=torch.zeros(
            (E, len(program.aoe_specs), N, A) if program.aoe_specs else (E, 1, 1, 1), dtype=torch.bool, device=dev
        ),
        territory_inside=torch.full(
            (E, len(program.territories), A) if program.territories else (E, 1, 1), -1, dtype=torch.int32, device=dev
        ),
        game_stats=game_stats0,
        agent_stats=agent_stats0,
        game_stats_prev=torch.zeros((E, Sg), dtype=torch.float32, device=dev),
        agent_stats_prev=torch.zeros((E, A, Sa), dtype=torch.float32, device=dev),
        game_stats_touched=game_touched0,
        agent_stats_touched=agent_touched0,
        auto_stats=auto_stats0,
        auto_stats_prev=auto_stats0.clone() if program.needs_auto_prev else auto_stats0[:, :, :0],
        obj_inv_prev=obj_inv0.clone() if program.needs_inv_prev else obj_inv0[:, :0],
        visit_bitmap=bit_word,
        obj_visited=torch.zeros((E, N), dtype=torch.int32, device=dev),
        rewards=torch.zeros((E, A), dtype=torch.float32, device=dev),
        episode_rewards=torch.zeros((E, A), dtype=torch.float32, device=dev),
        reward_prev=torch.zeros((E, A, max(program.num_reward_entries, 1)), dtype=torch.float32, device=dev),
        terminals=torch.zeros((E, A), dtype=torch.bool, device=dev),
        truncations=torch.zeros((E, A), dtype=torch.bool, device=dev),
        step_count=torch.zeros((E,), dtype=torch.int32, device=dev),
        rng=rng,
        mt=mt if mt is not None else torch.zeros((E, 0), dtype=torch.int64, device=dev),
        map_idx=map_idx.to(torch.int32),
    )
    if program.materialized:
        state = recompute_materialized(program, state, mtd=draws)
    return state


@trace.setup_span("setup.make_reset")
def make_reset(program: EngineProgram, init: EnvInit, num_envs: int, reference_rng: bool = False, device=None,
               obs_tail: str = "auto"):
    """Returns reset(seed, query_ranks=None) -> (state, StepOutputs) with
    initial observations.

    Envs get maps from the pool round-robin. reference_rng=True seeds every
    env's MT19937 twin with the scalar seed (reference step.py:260-270; each
    C++ env owns one, mettagrid_c.cpp:51-52). order_by=random queries of the
    materialized tags and value observations draw from a torch.Generator
    seeded with the seed, or take ``query_ranks`` ({rng_salt: f32[E, N]},
    a parity hook as make_step's). obs_tail: the observation tail, "auto"
    or "v3" (obs.make_obs_fn). ``device`` defaults to CUDA and raises when
    there is none; pass device="cpu" for the plain path."""
    dev = resolve_device(device)
    pool = _device_init(program, init, dev)
    P = init.pool_size
    generator = torch.Generator(device=dev)
    draws = RankDraws(generator)
    obs_fn = step_obs_fn(program, init, dev, obs_tail, draws)

    def reset(seed: int, query_ranks=None):
        generator.manual_seed(int(seed))
        draws.start_step(query_ranks)
        map_idx = torch.arange(num_envs, dtype=torch.int32, device=dev) % P
        rng = torch.stack(
            [torch.full((num_envs,), int(seed), dtype=torch.int64, device=dev),
             torch.arange(num_envs, dtype=torch.int64, device=dev)],
            dim=1,
        )
        mt = mt_init(torch.full((num_envs,), int(seed), dtype=torch.int64, device=dev)) if reference_rng else None
        state = _fresh_state_from_pool(program, pool, map_idx, rng, mt=mt, draws=draws)
        obs, attempted = obs_fn(state)
        # Construction-time observation token accounting (mettagrid_c.cpp:271-319).
        state = _token_stat_update(program, state, attempted)
        out = StepOutputs(
            observations=obs,
            rewards=state.rewards,
            terminals=state.terminals,
            truncations=state.truncations,
            action_success=state.action_success,
            tokens_attempted=attempted,
        )
        return state, out

    return trace.first_call(reset, "setup.reset")


def make_agent_tick_phase(program: EngineProgram, reference_rng: bool = False):
    """Per-agent on_tick handlers (mettagrid_c.cpp:1018-1024), or None.
    Returns agent_tick_phase(state, draws=None) -> state.

    Under reference_rng with handlers that draw, agents run one at a time in
    index order, each with an [E] context threading the MT19937 twin (the
    C++ loop's order); otherwise every agent at once with an [E, A]
    context, order_by=random queries drawing from ``draws``."""
    if not any(h is not None for h in program.on_tick_handlers):
        return None
    A = program.num_agents
    consuming = reference_rng and any(h is not None and handler_consumes(h, program) for h in program.on_tick_handlers)

    def agent_tick_phase_sequential(state: EnvState, draws=None) -> EnvState:
        E = state.grid.shape[0]
        zeros = torch.zeros((E,), dtype=torch.int32, device=state.grid.device)
        for a in range(A):
            slot = torch.full((E,), a, dtype=torch.int32, device=state.grid.device)
            ctx = Ctx(actor=slot, target=slot, target_r=state.obj_r[:, a], target_c=state.obj_c[:, a],
                      distance=zeros, timestep=state.step_count)
            for cfg_idx, handler in enumerate(program.on_tick_handlers):
                if handler is None:
                    continue
                mask = state.agent_cfg[:, a] == cfg_idx
                mtd = MtThread(state.mt, mask)
                state, _ = try_apply(program, state, ctx, handler, mask, mtd)
                state = state._replace(mt=mtd.mt)
        return state

    def agent_tick_phase(state: EnvState, draws=None) -> EnvState:
        E = state.grid.shape[0]
        dev = state.grid.device
        slots = torch.arange(A, dtype=torch.int32, device=dev)[None, :].expand(E, A)
        ctx = Ctx(actor=slots, target=slots, target_r=state.obj_r[:, :A], target_c=state.obj_c[:, :A],
                  distance=torch.zeros((E, A), dtype=torch.int32, device=dev), timestep=state.step_count,
                  actor_prefix=True)
        for cfg_idx, handler in enumerate(program.on_tick_handlers):
            if handler is None:
                continue
            state, _ = try_apply(program, state, ctx, handler, state.agent_cfg == cfg_idx, draws)
        return state

    return agent_tick_phase_sequential if consuming else agent_tick_phase


def make_game_tick_phase(program: EngineProgram, reference_rng: bool = False):
    """The game-level on_tick handler (mettagrid_c.cpp:1050-1056), or None:
    one application per env with no actor or target. Returns
    game_tick_phase(state, draws=None) -> state; under reference_rng a
    handler that draws takes the MT19937 twin."""
    if program.game_on_tick is None:
        return None
    consuming = reference_rng and handler_consumes(program.game_on_tick, program)

    def game_tick_phase(state: EnvState, draws=None) -> EnvState:
        E = state.grid.shape[0]
        dev = state.grid.device
        none = torch.full((E,), -1, dtype=torch.int32, device=dev)
        zeros = torch.zeros((E,), dtype=torch.int32, device=dev)
        gctx = Ctx(actor=none, target=none, target_r=zeros, target_c=zeros, distance=zeros, timestep=state.step_count)
        ones = torch.ones((E,), dtype=torch.bool, device=dev)
        if consuming:
            mtd = MtThread(state.mt, ones)
            state, _ = try_apply(program, state, gctx, program.game_on_tick, ones, mtd)
            return state._replace(mt=mtd.mt)
        state, _ = try_apply(program, state, gctx, program.game_on_tick, ones, draws)
        return state

    return game_tick_phase


def make_coverage_phase(program: EngineProgram):
    """Per-step coverage stats (Agent::track_coverage, objects/agent.cpp:49-57):
    insert the current cell into the visited bitmap, count newly visited
    cells into "cell.unique_visited" and keep the running max Manhattan
    distance from spawn in "cell.max_distance_from_spawn"."""
    A = program.num_agents

    def coverage_phase(state: EnvState) -> EnvState:
        W = state.grid.shape[2]
        NW = state.visit_bitmap.shape[2]
        ar = state.obj_r[:, :A]
        ac = state.obj_c[:, :A]
        bit_word = _bit_words(ar * W + ac, NW)
        old = state.visit_bitmap
        newly = ((old & bit_word) == 0).all(dim=-1)  # [E, A]
        dist = (ar - state.agent_spawn_r).abs() + (ac - state.agent_spawn_c).abs()
        if program.stats_compact:
            lu = program.stat_cell_unique - AUTO_STAT_BASE
            lm = program.stat_cell_maxdist - AUTO_STAT_BASE
            au = state.auto_stats.clone()
            au[..., lu] += newly.to(torch.int32)
            au[..., lm] = torch.maximum(au[..., lm], dist)
            return state._replace(auto_stats=au, visit_bitmap=old | bit_word)
        stats = state.agent_stats.clone()
        stats[..., program.stat_cell_unique] += newly.to(stats.dtype)
        stats[..., program.stat_cell_maxdist] = torch.maximum(
            stats[..., program.stat_cell_maxdist], dist.to(stats.dtype)
        )
        return state._replace(agent_stats=stats, visit_bitmap=old | bit_word)

    return coverage_phase


def _vision_covered(dr, dc, hr: int, wr: int):
    """The obs scan's vision mask (within_observation_shape,
    core/observation_shape.cpp:19-52): circular dr^2+dc^2 <= r^2 with the
    cardinal tips widened by one for square windows; elliptical otherwise."""
    if hr == 0 and wr == 0:
        return (dr == 0) & (dc == 0)
    if hr == 0:
        return (dr == 0) & (dc.abs() <= wr)
    if wr == 0:
        return (dc == 0) & (dr.abs() <= hr)
    r2 = dr * dr
    c2 = dc * dc
    if hr == wr:
        d2 = r2 + c2
        cov = d2 <= hr * hr
        if hr >= 2:
            cov = cov | ((d2 == hr * hr + 1) & ((dr.abs() == hr) | (dc.abs() == wr)))
        return cov
    return r2 * (wr * wr) + c2 * (hr * hr) <= (hr * hr) * (wr * wr)


def make_visited_phase(program: EngineProgram):
    """"cell.visited" staleness during the obs scan (mettagrid_c.cpp:620-628):
    each object inside any agent's vision mask is claimed by the first such
    agent in index order, which adds (step - last claimed step) to its stat."""
    A = program.num_agents
    hr = (program.obs_height - 1) // 2
    wr = (program.obs_width - 1) // 2

    def visited_phase(state: EnvState) -> EnvState:
        ar = state.obj_r[:, :A, None]  # [E, A, 1]
        ac = state.obj_c[:, :A, None]
        covered = (
            _vision_covered(state.obj_r[:, None, :] - ar, state.obj_c[:, None, :] - ac, hr, wr)
            & state.obj_alive[:, None, :]
        )  # [E, A, N]
        a_idx = torch.arange(A, dtype=torch.int32, device=ar.device)[None, :, None]
        first = torch.where(covered, a_idx, A).amin(dim=1)  # [E, N]
        step = state.step_count[:, None]  # [E, 1]
        claim = (first < A) & (state.obj_visited < step)
        stale = torch.where(claim, step - state.obj_visited, 0)  # [E, N]
        win = covered & (first[:, None, :] == a_idx)  # [E, A, N]
        add = torch.where(win, stale[:, None, :], 0).sum(dim=2, dtype=torch.int32)  # [E, A]
        if program.stats_compact:
            au = state.auto_stats.clone()
            au[..., program.stat_cell_visited - AUTO_STAT_BASE] += add
            state = state._replace(auto_stats=au)
        else:
            stats = state.agent_stats.clone()
            stats[..., program.stat_cell_visited] += add.to(stats.dtype)
            state = state._replace(agent_stats=stats)
        return state._replace(obj_visited=torch.where(claim, step.expand_as(claim), state.obj_visited))

    return visited_phase


def _token_stat_update(program: EngineProgram, state: EnvState, attempted: torch.Tensor) -> EnvState:
    """Game-scope token accounting for one observation pass
    (mettagrid_c.cpp:640-642, 655-661): written = min(attempted, capacity),
    dropped = attempted - written, free = capacity - written, summed over
    agents."""
    T = program.num_tokens
    written = attempted.clamp(max=T)
    gs = state.game_stats.clone()
    f = gs.dtype
    gs[:, program.stat_tokens_written] += written.sum(dim=1, dtype=torch.int32).to(f)
    gs[:, program.stat_tokens_dropped] += (attempted - written).sum(dim=1, dtype=torch.int32).to(f)
    gs[:, program.stat_tokens_free] += (T - written).sum(dim=1, dtype=torch.int32).to(f)
    return state._replace(game_stats=gs)


def _pool_token_stats(program: EngineProgram, pool: dict, obs_fn, P: int, draws: RankDraws) -> torch.Tensor:
    """f32[P, 3] construction-observation token sums per pooled map: an
    auto-reset builds a fresh env whose constructor in the reference computes
    initial observations and accounts their tokens (mettagrid_c.cpp:271-319)."""
    T = program.num_tokens
    dev = pool["grid"].device
    map_idx = torch.arange(P, dtype=torch.int32, device=dev)
    st = _fresh_state_from_pool(program, pool, map_idx, torch.zeros((P, 2), dtype=torch.int64, device=dev), draws=draws)
    _, att = obs_fn(st)  # [P, A]
    written = att.clamp(max=T)
    return torch.stack(
        [
            written.sum(dim=1, dtype=torch.int32),
            (att - written).sum(dim=1, dtype=torch.int32),
            (T - written).sum(dim=1, dtype=torch.int32),
        ],
        dim=-1,
    ).to(torch.float32)


# The phases whose loops read the host.
_HOST_READ_PHASES = (mutfields.EVENT, mutfields.AGENT_TICK, mutfields.AOE, mutfields.TERRITORY, mutfields.GAME_TICK)


def graphs_ok(program: EngineProgram, device, action_mode: str = "auto", reference_rng: bool = False) -> bool:
    """True when make_step(program, device=device, action_mode=...,
    reference_rng=...) replays its step as CUDA graphs: the device is CUDA,
    the action phase is the pure-move waves (whose only host reads are the
    ends of its loop, which the graphs keep), the program has no event,
    agent on_tick, AOE, territory or game on_tick phase (their loops read
    the host) and no order_by=random query (it draws from the generator),
    and the reference-RNG step is off (its twin's loops read the host)."""
    if torch.device(device).type != "cuda" or reference_rng:
        return False
    if not step_gates(program, action_mode, reference_rng).pure_move:
        return False
    if any(site.context in _HOST_READ_PHASES for site in mutfields.mutation_sites(program)):
        return False
    return not reaches(program, lambda node: isinstance(node, CompiledQuery) and node.order_random)


def _graph_step(run, external_perm: bool, draws_maps: bool):
    """make_step's step on the graph path: ``run`` (the body) eager on the
    first call and on calls that draw from the generator; captured as CUDA
    graphs (engine/step_graphs.py) before the first other call after it, in
    the set-up span ``setup.graph_capture``, then replayed by every call the
    graphs take, each counted as ``step.graph_replays``."""
    graphs = None  # StepGraphs once captured; False where the body reads the host
    calls = 0

    def arguments(actions, vibe_actions, perm_in, obs_buf, reset_maps, event_ranks, query_ranks) -> tuple:
        inputs = dict(actions=actions, vibe_actions=vibe_actions, perm_in=perm_in, reset_maps=reset_maps)
        key = (perm_in is None, reset_maps is None, obs_buf is None)
        fed = event_ranks is None and query_ranks is None
        drawn = not (external_perm and perm_in is not None) or (draws_maps and reset_maps is None)
        return inputs, key, fed and not drawn

    def dispatch(state, actions, vibe_actions, perm_in=None, obs_buf=None, reset_maps=None, event_ranks=None,
                 query_ranks=None):
        inputs, key, capturable = arguments(actions, vibe_actions, perm_in, obs_buf, reset_maps, event_ranks,
                                            query_ranks)
        if capturable and graphs and graphs.takes(state, inputs, obs_buf, key):
            trace.count("step.graph_replays")
            return graphs.replay(state, inputs, obs_buf)
        return run(state, actions, vibe_actions, perm_in, obs_buf, reset_maps, event_ranks, query_ranks)

    counted = trace.program_step(dispatch)

    @functools.wraps(counted)
    def step(state, actions, vibe_actions, perm_in=None, obs_buf=None, reset_maps=None, event_ranks=None,
             query_ranks=None):
        nonlocal graphs, calls
        calls += 1
        if graphs is None and calls > 1:
            inputs, key, capturable = arguments(actions, vibe_actions, perm_in, obs_buf, reset_maps, event_ranks,
                                                query_ranks)
            if capturable:
                with trace.span("setup.graph_capture"):
                    given = {k: v for k, v in inputs.items() if v is not None}
                    graphs = step_graphs.capture(run, state, given, obs_buf, key) or False
        return counted(state, actions, vibe_actions, perm_in, obs_buf, reset_maps, event_ranks, query_ranks)

    return step


@trace.setup_span("setup.make_step")
def make_step(
    program: EngineProgram,
    init: EnvInit,
    auto_reset: bool = True,
    external_perm: bool = False,
    reference_rng: bool = False,
    device=None,
    generator: torch.Generator = None,
    action_mode: str = "auto",
    obs_tail: str = "auto",
):
    """Returns step(state, actions, vibe_actions, perm=None, obs_buf=None,
    reset_maps=None, event_ranks=None, query_ranks=None) -> (state,
    StepOutputs).

    actions/vibe_actions: int32[E, A] indices into the flattened action space.

    external_perm: the step takes perm[E, A], the shuffled agent order
    (perm[e, i] = agent acting at rank i), instead of drawing it. Otherwise
    the order, the map of every auto-reset env when the pool has more than
    one map, the events' target ranks and the picks of order_by=random
    queries are drawn from ``generator`` (a torch.Generator on the device;
    by default one seeded with 0).

    reference_rng: the reference-RNG step. The MT19937 twin in state.mt
    (seeded by make_reset(reference_rng=True)) draws the agent order, the
    events' shuffles and the order_by=random picks as the C++ engine does;
    the auto-reset map picks still come from ``generator`` or reset_maps,
    as the reference draws them from its own keys. It excludes
    external_perm, event_ranks and query_ranks.

    action_mode: one of "auto", "fast", "pure" and "sequential"
    (reference step.py:595-629); anything else raises ValueError. "auto"
    takes the wave phase where it is provably sequential-equivalent
    (actions_fast.fast_mode_ok), with pure-move waves where
    actions_fast.pure_move_ok holds, else the sequential phase; "fast"
    forces the wave phase (handler-chain waves); "pure" forces the
    pure-move waves; "sequential" forces the sequential phase. Under
    reference_rng, a program whose action handlers draw from the twin takes
    the sequential phase whatever the mode, as in the reference. The forced
    modes are hooks for parity with the reference's API and for tests that
    hold the wave phase against the sequential one; no path of the port's
    own sets them. step.action_phase_kind ("waves" or "sequential") and
    step.lazy_grid report what was chosen.

    obs_tail: "auto" or "v3", the observation tail (obs.make_obs_fn).

    obs_buf: optional carried uint8[E, A, T, 3] observation buffer from the
    previous step or reset. On the v2 and v3 observation routes (kernels
    B1-B3, B6a, B6b) its first OUT_W token slots are rewritten IN PLACE and
    it is returned as the observations; the v1 routes (B4, B5: local position or value
    observations on) ignore it and return a new tensor (obs.make_obs_fn).
    Read the observations from the returned StepOutputs, never from the
    buffer.

    reset_maps: optional int32[E] with values in [0, pool size): the map each
    env starts on if it auto-resets this step, in place of the draw from
    ``generator`` (the parity tests feed the reference engine's draw).

    event_ranks: optional f32[E, rows, N] with values in [0, 1), the random
    ranks by which events with max_targets pick their targets
    (events.make_event_phase; rows = n_events * (fallback depth + 1)), in
    place of the draw from ``generator`` (the parity tests feed the
    reference engine's draw).

    query_ranks: optional {rng_salt: f32[E, N]} with values in [0, 1), the
    ranks by which each order_by=random query (ir.CompiledQuery.rng_salt)
    picks its results this step, in place of the one draw per query and step
    from ``generator`` (exec.RankDraws; the parity tests feed the reference
    engine's draw). The materialized tags of an auto-reset env's fresh
    state take the same ranks as the step (the reference draws them from
    the key its merge splits off); under reference_rng the queries of
    rewards, value observations, AOE, territories and fresh states draw
    from ``generator``, as the reference draws them from its own keys and
    not from the twin.

    CUDA graphs: where graphs_ok holds (a CUDA device, the pure-move
    waves, no phase or query that reads the host or draws), the step is
    captured as CUDA graphs on its first call after the first that draws
    nothing from ``generator`` (the agent order given with external_perm,
    the reset maps given or a pool of one map, no event or query ranks), and
    every later such call replays them (engine/step_graphs.py): the same
    kernels and results, a few graph launches in place of some 440 kernel
    launches. **Then the state and outputs a step returns are its own
    buffers, valid until its next call**, as the observation buffer is; a
    caller that keeps them across calls clones them. A call given an
    observation buffer other than the step's own gets the observations
    written into it, as on the eager path. A call that draws, or whose
    tensors differ in shape from the captured ones, runs eagerly.

    ``device`` defaults to CUDA and raises when there is none; pass
    device="cpu" for the plain path."""
    # Under reference_rng, the constructs whose draws the twin cannot place in
    # the C++ engine's order raise, as in the reference's make_step.
    problems = reference_rng_unsupported(program) if reference_rng else []
    if problems:
        raise NotImplementedError("reference_rng cannot bit-match this config: " + "; ".join(sorted(set(problems))))
    if action_mode not in ("auto", "fast", "pure", "sequential"):
        raise ValueError(f"action_mode must be 'auto', 'fast', 'pure' or 'sequential', not {action_mode!r}")
    if reference_rng and external_perm:
        raise ValueError("reference_rng draws the agent order from the MT19937 twin; it excludes external_perm")
    dev = resolve_device(device)
    pool = _device_init(program, init, dev)
    P = init.pool_size
    A = program.num_agents

    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    # order_by=random outside the twin's reach draws from the generator.
    draws = RankDraws(generator)

    gates = step_gates(program, action_mode, reference_rng)
    if gates.waves:
        action_phase = make_action_phase_fast(program, pure_move=gates.pure_move, lazy_grid=gates.lazy_grid)
    else:
        sequential_phase = make_action_phase(program, reference_rng=reference_rng and actions_consume_rng(program))

        def action_phase(state, actions, vibe_actions, perm):
            return sequential_phase(state, actions, vibe_actions, perm, draws)
    event_phase = make_event_phase(program, reference_rng)
    agent_tick_phase = make_agent_tick_phase(program, reference_rng)
    game_tick_phase = make_game_tick_phase(program, reference_rng)
    aoe_phase = make_aoe_phase(program, init)
    territory_phase = make_territory_phase(program)
    obs_fn = step_obs_fn(program, init, dev, obs_tail, draws, gates)
    reward_phase = make_reward_phase(program)
    coverage_phase = make_coverage_phase(program)
    visited_phase = make_visited_phase(program)

    pool_token_stats = _pool_token_stats(program, pool, obs_fn, P, draws) if auto_reset else None
    pool_fields = _POOL_RESET_FIELDS + (() if program.stats_compact else ("agent_stats", "auto_stats"))
    reset_template = None
    if auto_reset and P == 1:
        # With one pooled map, fresh == template == the value every unwritten
        # field has held since init, so fields no phase of this program can
        # write merge as the identity and are skipped (engine/mutfields.py).
        # With a lazy agent layer the action phase writes no grid cell. (The
        # reference tests gridless_batch_ok here, which also holds for
        # pure-move programs that write the grid and for batches that read
        # and write it; ROADMAP Queue 3.) The sequential phase writes it.
        mutable = maybe_written_pool_fields(program, lazy_grid=gates.lazy_agent_layer)
        pool_fields = tuple(f for f in pool_fields if f in mutable or f not in POOL_FIELDS)
        reset_template = _fresh_state_from_pool(
            program, pool, torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.zeros((1, 2), dtype=torch.int64, device=dev), init_token_stats=pool_token_stats, draws=draws,
        )
    game_touched_row = pool["game_stats_init_touched"]
    auto_row = None
    if program.stats_compact and program.num_auto_lanes:
        row = np.zeros((program.num_auto_lanes,), dtype=np.int32)
        row[program.stat_cell_unique - AUTO_STAT_BASE] = 1
        auto_row = torch.from_numpy(row).to(dev)

    def auto_reset_merge(state: EnvState, reset_maps) -> EnvState:
        """Reset the envs whose episode ended last step (PufferEnv semantics:
        a fresh sim is built, then this step's actions apply to it), field
        class by field class, with masked selects and no host sync."""
        E = state.step_count.shape[0]
        done = (state.terminals | state.truncations).any(dim=1)  # [E]

        def mrg(new, old):
            return torch.where(done.reshape((E,) + (1,) * (old.dim() - 1)), new, old)

        if reset_maps is not None:
            map_new = reset_maps
        elif P == 1:
            map_new = torch.zeros((E,), dtype=torch.int32, device=dev)
        else:
            map_new = torch.randint(0, P, (E,), generator=generator, device=dev, dtype=torch.int32)
        upd = {"map_idx": mrg(map_new, state.map_idx)}
        for f, v in _CONST_RESETS.items():
            old = getattr(state, f)
            upd[f] = mrg(torch.full_like(old, v), old)
        upd["game_stats_touched"] = mrg(game_touched_row, state.game_stats_touched)
        if program.stats_compact:
            upd["agent_stats"] = mrg(torch.zeros_like(state.agent_stats), state.agent_stats)
            if auto_row is not None:
                upd["auto_stats"] = mrg(auto_row, state.auto_stats)
        if P == 1:
            fresh = reset_template
        else:
            fresh = _fresh_state_from_pool(
                program, pool, upd["map_idx"], state.rng, init_token_stats=pool_token_stats, draws=draws
            )
        for f in pool_fields:
            upd[f] = mrg(getattr(fresh, f), getattr(state, f))
        return state._replace(**upd)

    def run(state: EnvState, actions, vibe_actions, perm_in=None, obs_buf=None, reset_maps=None, event_ranks=None,
            query_ranks=None, phase=trace.span):
        """The step's body, each phase inside ``phase(name)``: trace.span
        when it runs, the recorder's phase when it is captured
        (engine/step_graphs.py)."""
        E = actions.shape[0]
        if reference_rng and event_ranks is not None:
            raise ValueError("reference_rng draws the events' shuffles from the MT19937 twin; pass no event_ranks")
        if reference_rng and query_ranks is not None:
            raise ValueError("reference_rng draws the queries' shuffles from the MT19937 twin; pass no query_ranks")
        draws.start_step(query_ranks)
        if auto_reset:
            with phase("step.auto_reset"):
                state = auto_reset_merge(state, reset_maps)

        with phase("step.actions"):
            # --- agent order: perm[e, i] = agent acting at rank i ---
            if reference_rng:
                # libstdc++'s std::shuffle of the agents from each env's twin
                # (mettagrid_c.cpp:957-960); events and queries draw later.
                full = torch.full((E,), A, dtype=torch.int32, device=dev)
                mt, perm = shuffle_perm(state.mt, full, A, torch.ones((E,), dtype=torch.bool, device=dev))
                state = state._replace(mt=mt)
            elif external_perm:
                perm = perm_in
            else:
                perm = torch.rand((E, A), generator=generator, device=dev).argsort(dim=1).to(torch.int32)

            # --- reset phase (mettagrid_c.cpp:929-952) ---
            state = state._replace(
                agent_prev_r=state.obj_r[:, :A].contiguous(),
                agent_prev_c=state.obj_c[:, :A].contiguous(),
                rewards=torch.zeros_like(state.rewards),
                action_success=torch.zeros_like(state.action_success),
                agent_last_action=torch.zeros_like(state.agent_last_action),
                game_stats_prev=state.game_stats,
                agent_stats_prev=state.agent_stats,
                auto_stats_prev=state.auto_stats if program.needs_auto_prev else state.auto_stats_prev,
                obj_inv_prev=state.obj_inv if program.needs_inv_prev else state.obj_inv_prev,
                step_count=state.step_count + 1,
            )

            # --- actions (shuffled, priority-ordered, dual streams) ---
            state = action_phase(state, actions, vibe_actions, perm)

        # --- events (mettagrid_c.cpp:1008-1011) ---
        if event_phase is not None:
            with phase("step.events"):
                if event_ranks is None and not reference_rng:
                    N = state.obj_type.shape[1]
                    event_ranks = torch.rand((E, event_phase.num_rank_rows, N), generator=generator, device=dev)
                state = event_phase(state, event_ranks, draws)

        # --- per-agent on_tick (mettagrid_c.cpp:1018-1024) ---
        if agent_tick_phase is not None:
            with phase("step.agent_tick"):
                state = agent_tick_phase(state, draws)

        # --- AOE effects, then territory effects (mettagrid_c.cpp:1031-1042) ---
        if aoe_phase is not None:
            with phase("step.aoe"):
                state = aoe_phase(state, draws)
        if territory_phase is not None:
            with phase("step.territory"):
                state = territory_phase(state, draws)

        # --- game on_tick (mettagrid_c.cpp:1050-1056) ---
        if game_tick_phase is not None:
            with phase("step.game_tick"):
                state = game_tick_phase(state, draws)

        # --- observations (before rewards, like the reference) ---
        with phase("step.obs"):
            obs, attempted = obs_fn(state, obs_buf=obs_buf)
        with phase("step.stats"):
            state = coverage_phase(state)
            state = visited_phase(state)
            state = _token_stat_update(program, state, attempted)

        # --- rewards, then truncation (mettagrid_c.cpp:1086-1096) ---
        with phase("step.rewards"):
            state = reward_phase(state, draws)
            if program.max_steps > 0:
                over = (state.step_count >= program.max_steps)[:, None].expand_as(state.terminals)
                if program.episode_truncates:
                    state = state._replace(truncations=state.truncations | over)
                else:
                    state = state._replace(terminals=state.terminals | over)

        out = StepOutputs(
            observations=obs,
            rewards=state.rewards,
            terminals=state.terminals,
            truncations=state.truncations,
            action_success=state.action_success,
            tokens_attempted=attempted,
        )
        return state, out

    if not graphs_ok(program, dev, action_mode, reference_rng):
        step = trace.program_step(run)
    else:
        step = _graph_step(run, external_perm, auto_reset and P > 1)
    step.obs_fn = obs_fn
    step.action_phase = action_phase
    step.action_phase_kind = "waves" if gates.waves else "sequential"
    step.lazy_grid = gates.lazy_agent_layer
    return step
