"""The full-combat family against the JAX engine, and the Chebyshev waves
against the sequential phase, exactly.

The config is bench_run's ``full_combat`` variant (the reference's parity
family of mettagrid_tpu/parity/arena.py:368-406): the combat arena with the
shield_break, melee (loot, then DirectAttack) and bump_swap move handlers
and the per-agent loadouts written into the pooled maps. Its reachable swap
takes the wave phase onto the Chebyshev waves. Here it runs at 24 agents on
15x15 maps (denser than the bench's 25x25, so agents meet), a pool of three
maps, max_steps 10 (every env auto-resets twice), with the family's action
script drawn with numpy and the agent orders and reset maps fed to both
engines.

Exactness: the JAX engine's sequential phase is the semantics. The port's
sequential phase and its Chebyshev waves must each equal it on every output
and every state field but ``rng`` after every step. The JAX engine's own
waves must equal it too, except where they book an agent that a swap moved
before its own (noop) turn at its phase-start cell: agent_action_prev_r/c,
agent_swm and the max-steps-without-motion stat. That is a reference fault,
shown here and not copied (the port books the cell at the agent's turn).
Tolerance: exact (integer inventories, float stats that are sums of small
integers).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import mettagrid_tpu.engine as jengine
import mettagrid_tpu.engine.actions_fast as jfast
from mettagrid_tpu.maps.map_builder import GameMap as JGameMap
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.config.handler_config import MaxDistanceFilter
from mettagrid_tpu_torch.engine.actions_fast import fast_mode_ok, footprint_schedule_ok
from mettagrid_tpu_torch.engine.interop import state_from_numpy, state_to_numpy
from mettagrid_tpu_torch.engine.obs import make_stage1
from mettagrid_tpu_torch.maps.map_builder import GameMap
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from mettagrid_tpu_torch.profiling import trace
from mettagrid_tpu_torch.tools import bench_run
from tests.test_torch_general import _jax_draws
from tests.test_torch_mutation_kinds import assert_inits_equal, jax_state_of
from tests.test_torch_reference_rng import build_both
from tests.test_torch_step import _assert_outputs_equal, _assert_states_equal, _jax_state_numpy

E = 4
A = 24
# Fields the reference's waves book at the phase-start cell for an agent
# swapped before its noop turn (agent_stats: its max-steps-without-motion
# lane; agent_stats_prev is last step's agent_stats).
BOOKED = ("agent_action_prev_r", "agent_action_prev_c", "agent_swm", "agent_stats", "agent_stats_prev")


def _cfg(agents=A, size=15, max_steps=10):
    cfg = bench_run.make_cfg("full_combat", agents)
    cfg.game.map_builder = RandomMapBuilder.Config(agents=agents, width=size, height=size, border_width=1,
                                                   objects={"wall": 10})
    cfg.game.max_steps = max_steps
    return cfg


def _with_loadouts(pair):
    program, init = pair
    return program, dataclasses.replace(init, obj_inv=bench_run.full_combat_loadouts(program, init.obj_inv))


def _script(rng, program, agents):
    """The family's script (parity/arena.py:627-644, bench_run's
    full_combat_script) and agent orders, drawn with numpy."""
    acts, vibes = bench_run.full_combat_script(program, rng, (E, agents))
    perm = np.stack([rng.permutation(agents) for _ in range(E)]).astype(np.int32)
    return acts, vibes, perm


def test_lockstep_with_jax():
    """24 steps: the JAX engine's sequential and wave phases and the port's
    sequential phase and Chebyshev waves, from the port's reset state (equal
    to the JAX engine's, tests/test_torch_step.py); the pool's map picks of
    the JAX engine are fed to the port."""
    cfg = _cfg()
    jax_pair, port_pair = build_both(cfg, [3, 4, 5])
    (jp, ji), (tp, ti) = _with_loadouts(jax_pair), _with_loadouts(port_pair)
    assert_inits_equal(ji, ti)
    assert fast_mode_ok(tp) and not footprint_schedule_ok(tp)
    assert (jfast.fast_mode_ok(jp), jfast.footprint_schedule_ok(jp)) == (True, False)
    jsteps = {m: jengine.make_step(jp, ji, auto_reset=True, donate=False, external_perm=True, action_mode=m)
              for m in ("sequential", "auto")}
    tsteps = {m: tengine.make_step(tp, ti, auto_reset=True, external_perm=True, device="cpu", action_mode=m)
              for m in ("sequential", "auto")}
    assert tsteps["auto"].action_phase_kind == "waves"
    # full_token_bounds: 23 token slots per cell, window rows of 299 lanes,
    # so the non-fused observation path (kernels B7 and B8 on the card).
    assert tsteps["auto"].obs_fn.route == "nonfused" and make_stage1(tp).num_slots == 23
    t0, tout0 = tengine.make_reset(tp, ti, E, device="cpu")(0)
    jst = {m: jax_state_of(t0) for m in jsteps}
    jbuf = {m: jnp.asarray(tout0.observations.numpy()) for m in jsteps}
    tst = {m: t0 for m in tsteps}
    tbuf = {m: tout0.observations.clone() for m in tsteps}
    N = ti.obj_type.shape[1]
    R = tp.num_resources
    heart, ore = tp.resource_names.index("heart"), tp.resource_names.index("ore_red")
    swap_stat = tp.agent_stat_names.index("actions.swap")
    rng = np.random.default_rng(0)
    seen = dict(hearts_lost=0, ore_deposited=0, swaps=0, waves=0, booked_apart=0)
    for i in range(24):
        acts, vibes, perm = _script(rng, tp, A)
        maps, _ = _jax_draws(jst["sequential"], 3, 1, N)
        jout = {}
        for m, step in jsteps.items():
            jst[m], jout[m] = step(jst[m], jnp.asarray(acts), jnp.asarray(vibes), jnp.asarray(perm), jbuf[m])
            jbuf[m] = jout[m].observations
        ref = _jax_state_numpy(jst["sequential"])
        for m, step in tsteps.items():
            waves = trace.counted("actions.waves")
            tst[m], tout = step(tst[m], torch.from_numpy(acts), torch.from_numpy(vibes), torch.from_numpy(perm),
                                tbuf[m], reset_maps=torch.from_numpy(maps))
            tbuf[m] = tout.observations
            _assert_outputs_equal(jout["sequential"], tout, where=f"step {i} port {m}: ")
            _assert_states_equal(ref, tst[m], where=f"step {i} port {m}: ")
            if m == "auto":
                seen["waves"] += trace.counted("actions.waves") - waves
        for f in jout["auto"]._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jout["auto"], f)),
                                          np.asarray(getattr(jout["sequential"], f)), err_msg=f"step {i} JAX waves")
        waves = _jax_state_numpy(jst["auto"])
        _assert_states_equal(ref, state_from_numpy(waves, "cpu"), skip=("rng",) + BOOKED, where=f"step {i} JAX waves: ")
        seen["booked_apart"] += int(any(not np.array_equal(waves[f], ref[f]) for f in BOOKED))
        seen["hearts_lost"] += int(ref["auto_stats"][..., R + heart].sum())
        seen["ore_deposited"] += int(ref["auto_stats"][..., 2 * R + ore].sum())
        seen["swaps"] = max(seen["swaps"], int(ref["agent_stats"][..., swap_stat].sum()))
    assert int(tst["auto"].step_count.max()) < 24, "no env auto-reset"
    assert seen["hearts_lost"] > 0, "no attack lowered a heart"
    assert seen["ore_deposited"] > 0, "no loot moved ore from an agent"
    assert seen["swaps"] > 0, "no swap applied"
    assert seen["waves"] > 24, "the Chebyshev waves never took more than one wave"
    assert seen["booked_apart"] > 0, "no agent was swapped before its noop turn"


def _row_map(agents):
    """One row: a wall border, two empty cells, the agents, two empty cells."""
    grid = np.full((3, agents + 6), "wall", dtype=object)
    grid[1, 1:-1] = "empty"
    grid[1, 3:3 + agents] = "agent.agent"
    return grid.astype(str)


def test_swapped_before_its_turn():
    """Agent 0 (clown, rank 0) bumps east into agent 1 and swaps with it.
    Agent 1 (rank 1) then acts from agent 0's old cell: in env 0 it moves
    west into the empty cell there, in env 1 it takes a noop and is booked
    at that cell. The port's Chebyshev waves, its sequential phase and the
    JAX engine's sequential phase agree on every field."""
    cfg = _cfg(agents=2, max_steps=0)
    grid = _row_map(2)
    (jp, _), (tp, _) = build_both(cfg, [0])
    ti = tengine.build_env_init(tp, [GameMap(grid)])
    ji = jengine.build_env_init(jp, [JGameMap(grid)])
    names = tp.action_names
    clown, east, west, noop = (names.index(n) for n in ("change_vibe_clown", "move_east", "move_west", "noop"))
    perm = torch.tensor([[0, 1], [0, 1]], dtype=torch.int32)
    steps = [  # (primary actions, vibe actions): set agent 0's vibe, then act
        ([[noop, noop], [noop, noop]], [[clown, 0], [clown, 0]]),
        ([[east, west], [east, noop]], [[0, 0], [0, 0]]),
    ]
    reset = tengine.make_reset(tp, ti, 2, device="cpu")(0)[0]
    jstep = jengine.make_step(jp, ji, auto_reset=False, donate=False, external_perm=True, action_mode="sequential")
    js = jax_state_of(reset)
    for acts, vibes in steps:
        js, _ = jstep(js, jnp.asarray(acts, jnp.int32), jnp.asarray(vibes, jnp.int32), jnp.asarray(perm.numpy()))
    ref = _jax_state_numpy(js)
    for m in ("sequential", "auto"):
        step = tengine.make_step(tp, ti, auto_reset=False, external_perm=True, device="cpu", action_mode=m)
        ts = reset
        for acts, vibes in steps:
            ts, _ = step(ts, torch.tensor(acts, dtype=torch.int32), torch.tensor(vibes, dtype=torch.int32), perm)
        _assert_states_equal(ref, ts, where=f"port {m}: ")
    # Agent 0 took agent 1's cell (column 4); agent 1 moved on to column 2
    # (env 0) or stayed, and was booked, at column 3 (env 1).
    assert ref["obj_c"][:, :2].tolist() == [[4, 2], [4, 3]]
    assert ref["agent_action_prev_c"][1, 1] == 3


def test_range_three_waves_match_sequential():
    """bump_swap behind a max_distance(radius=3) filter: its line scan reaches
    three cells, so r_int = 6 and the waves no longer share one read. The
    port's Chebyshev waves equal its sequential phase on every field after
    every step (8 agents on 11x11 maps, a pool of three, auto-reset, 24
    steps), and some swap reaches past the adjacent cell."""
    agents = 8
    cfg = _cfg(agents=agents, size=11)
    cfg.game.actions.move.handlers[2].filters.append(MaxDistanceFilter(radius=3))
    _, port_pair = build_both(cfg, [3, 4, 5])
    tp, ti = _with_loadouts(port_pair)
    assert [mh.max_range for mh in tp.move_handlers] == [1, 1, 3, 1, 1]
    steps = {m: tengine.make_step(tp, ti, auto_reset=True, external_perm=True, device="cpu", action_mode=m)
             for m in ("sequential", "auto")}
    assert steps["auto"].action_phase_kind == "waves"
    reset = tengine.make_reset(tp, ti, E, device="cpu")(0)[0]
    st = {m: reset for m in steps}
    far_swaps = 0
    rng = np.random.default_rng(1)
    for i in range(24):
        acts, vibes, perm = (torch.from_numpy(x) for x in _script(rng, tp, agents))
        reset_maps = torch.from_numpy(rng.integers(0, 3, E).astype(np.int32))
        before = st["sequential"]
        for m, step in steps.items():
            st[m], _ = step(st[m], acts, vibes, perm, reset_maps=reset_maps)
        _assert_states_equal(state_to_numpy(st["sequential"]), st["auto"], where=f"step {i}: ")
        # A swap across more than one cell: an agent jumped 2 or 3 cells.
        after = st["sequential"]
        jump = torch.maximum((after.obj_r - before.obj_r).abs(), (after.obj_c - before.obj_c).abs())[:, :agents]
        far_swaps += int(((jump >= 2) & (after.step_count[:, None] > 1)).sum())
    assert far_swaps > 0, "no swap reached past the adjacent cell"


def test_bench_run_reports_waves():
    """bench_run's command line steps full_combat on the CPU at a small
    size and reports its phase, route and waves per step."""
    report = bench_run.main(["--variant", "full_combat", "--envs", "2", "--pool", "1", "--steps", "2", "--device", "cpu"])
    assert (report["action_phase"], report["obs_route"]) == ("waves", "nonfused")
    assert 1 <= report["waves_per_step_mean"] <= report["waves_per_step_max"]
    assert report["step_ms_host_clock"] > 0 and report["envs"] == 2
