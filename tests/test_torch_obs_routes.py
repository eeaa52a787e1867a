"""The port's new observation routes against the JAX engine, step for step.

Three configs leave the v2 fast path for the v1 tail, because their global
tokens can be absent:

* ``arena_lp``: the arena with local position on (static background, B4);
* ``general_lp``: the general bench config with local position on (mutable
  background, B5);
* the arena with value observations (``global_obs.obs``: the agent's hearts,
  absent while it holds none, and its visited-cell count, whose digits in
  base 4 appear as it grows; static background, B4).

Both engines step in lockstep from the JAX reset state, fed the same
actions, agent orders, reset maps and event ranks (the JAX engine's own
draws, as tests/test_torch_general.py feeds them), over 42 steps with
max_steps=20, so every env auto-resets twice and agents stand on their
spawn cells (no lp tokens) and leave them. Every output and every state
field but rng must be equal after every step (tolerance: exact).

The routing test builds a 128x128 arena, whose padded image (144 x 512
words) needs more shared memory than one block has, and checks that
make_obs_fn picks B3 (B5 with local position on) when it is built, over the
static pool and over the image built from every object, and that it returns
the JAX engine's bytes. The whole routing table is checked on its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import mettagrid_tpu.builder as jbuilder
import mettagrid_tpu.engine as jengine
import mettagrid_tpu.engine.obs as jobs
from mettagrid_tpu.config import game_value as jgv
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu_torch import builder as tbuilder
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.config import game_value as tgv
from mettagrid_tpu_torch.engine import obs as tobs
from mettagrid_tpu_torch.engine.interop import state_from_numpy
from mettagrid_tpu_torch.engine.kernels.obs_tail_dyn_v2 import obs_tail_dyn_v2
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v1 import obs_tail_static_v1
from mettagrid_tpu_torch.engine.kernels.tail_plan import MAX_SMEM
from mettagrid_tpu_torch.engine.kernels.obs_tail_v1 import obs_tail_v1
from mettagrid_tpu_torch.engine.step import step_obs_fn
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from tests.test_torch_general import A, E, _build, _cfgs, _lockstep
from tests.test_torch_tail_plan import _one_image_and_tables


def _arena_cfgs(value_obs: bool):
    out = []
    for builder_mod, rmb, gv in ((jbuilder, JRandomMapBuilder, jgv), (tbuilder, RandomMapBuilder, tgv)):
        cfg = builder_mod.make_arena(
            A, combat=False,
            map_builder=rmb.Config(agents=A, width=15, height=15, border_width=1, objects={"wall": 8}),
        )
        cfg.game.max_steps = 20
        if value_obs:
            cfg.game.obs.global_obs.obs = {"hearts": gv.InventoryValue(item="heart"), "visited": gv.stat("cell.unique_visited")}
            cfg.game.obs.token_value_base = 4
        else:
            cfg.game.obs.global_obs.local_position = True
        out.append(cfg)
    return out


def _variant_cfgs(variant):
    if variant == "general_lp":
        cfgs = _cfgs("general", max_steps=20)
        for cfg in cfgs:
            cfg.game.obs.global_obs.local_position = True
        return cfgs
    return _arena_cfgs(value_obs=variant == "arena_values")


@pytest.mark.parametrize(
    "variant,kernel", [("arena_lp", obs_tail_static_v1), ("general_lp", obs_tail_v1), ("arena_values", obs_tail_static_v1)]
)
def test_lockstep_matches_jax(variant, kernel):
    jcfg, tcfg = _variant_cfgs(variant)
    tp, ti = _build(tengine, tcfg, (3, 4, 5))
    fn = step_obs_fn(tp, ti, "cpu")
    assert fn.tail is kernel
    g = tp.global_obs
    fixed = sum([g.episode_completion_pct, g.last_action, g.last_action_move, g.last_reward])
    seen = dict(on_spawn=0, off_spawn=0, absent=0, present=0)

    def check(jstate, tstate, tout):
        on = (tstate.obj_r[:, :A] == tstate.agent_spawn_r) & (tstate.obj_c[:, :A] == tstate.agent_spawn_c)
        seen["on_spawn"] += int(on.sum())
        seen["off_spawn"] += int((~on).sum())
        gw = fn.tail_inputs(tstate)["gwords"]
        seen["absent"] += int((gw == 0).sum())
        seen["present"] += int((gw[..., fixed:] > 0).sum())  # lp or value tokens present

    seen.update(_lockstep(jcfg, tcfg, 42, check=check))
    assert seen["resets"] == 2 * E
    assert seen["on_spawn"] > 0 and seen["off_spawn"] > 0
    assert seen["absent"] > 0 and seen["present"] > 0


def _big_arena(eng, builder_mod, rmb, local_position):
    cfg = builder_mod.make_arena(
        4, combat=False,
        map_builder=rmb.Config(agents=4, width=128, height=128, border_width=1, objects={"wall": 10}),
    )
    cfg.game.obs.global_obs.local_position = local_position
    program = eng.compile_program(cfg)
    b = cfg.game.map_builder.create()
    b.config.seed = 7
    return program, eng.build_env_init(program, [b.build_for_num_agents(4)])


_BIG = {}


def _big_case(local_position):
    """(JAX tables, port program, port init, JAX state after 3 random steps,
    the JAX engine's observations and counts) of the 128x128 arena, E=2."""
    if local_position not in _BIG:
        n_envs = 2
        jp, ji = _big_arena(jengine, jbuilder, JRandomMapBuilder, local_position)
        tp, ti = _big_arena(tengine, tbuilder, RandomMapBuilder, local_position)
        state, _ = jengine.make_reset(jp, ji, n_envs)(0)
        step = jengine.make_step(jp, ji, auto_reset=False, donate=False)
        rng = np.random.default_rng(3)
        for _ in range(3):
            acts = jnp.asarray(rng.integers(0, len(jp.action_names), (n_envs, 4)), dtype=jnp.int32)
            state, _ = step(state, acts, jnp.zeros((n_envs, 4), jnp.int32))
        jfn = jobs.make_obs_fn(jp, static_bg=jobs.build_static_bg(jp, ji))
        _BIG[local_position] = (jfn._tables, tp, ti, state, jfn(state))
    return _BIG[local_position]


@pytest.mark.parametrize("background", ["static", "mutable"])
@pytest.mark.parametrize("local_position,kernel", [(False, obs_tail_dyn_v2), (True, obs_tail_v1)])
def test_large_map_routes_at_build_time(local_position, kernel, background):
    """A 128x128 map's image outgrows shared memory: make_obs_fn routes it to
    B3 (v2 gate passes) or B5 (v2 gate fails) when it is built, whether the
    background is the static pool or built from every object, and the
    observations equal the JAX engine's."""
    t, tp, ti, state, (ref_obs, ref_att) = _big_case(local_position)
    assert _one_image_and_tables(t["HP_f"], t["WPC_f"], len(tp.window_offsets), t["S"]) > MAX_SMEM
    assert t["v2_ok"] != local_position
    bg = tobs.build_static_bg(tp, ti, "cpu") if background == "static" else None
    fn = tobs.make_obs_fn(tp, bg, "cpu")
    assert fn.tail is kernel
    obs, att = fn(state_from_numpy({f: np.asarray(getattr(state, f)) for f in state._fields}, "cpu"))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(ref_obs))
    np.testing.assert_array_equal(att.numpy(), np.asarray(ref_att))


@pytest.mark.parametrize(
    "v2_ok,static,fits,route",
    [
        (True, True, True, "B1"),
        (True, True, False, "B3"),
        (False, True, True, "B4"),
        (False, True, False, "B5"),
        (True, False, True, "B2"),
        (True, False, False, "B3"),
        (False, False, True, "B5"),
        (False, False, False, "B5"),
        (False, True, True, "nonfused"),
        (False, False, False, "nonfused"),
        (True, True, True, "B6a"),
        (True, True, False, "B6b"),
        (True, False, True, "B6b"),
        (True, False, False, "B6b"),
    ],
)
def test_tail_route_table(v2_ok, static, fits, route):
    """make_obs_fn's routing table: the v2 gate, the background kind and the
    shared-memory fit pick the tail kernel, unless no fused tail takes the
    config (an AOE mask, or window rows wider than 128 lanes): then the
    non-fused path, whatever the rest. With the v3 tail requested and its
    gate passed (the B6 rows), a static background whose paired halves fit
    one block takes B6a and every other program B6b; a program that fails
    the v3 gate routes as "auto" does (the rows above)."""
    v3 = route in ("B6a", "B6b")
    assert tobs.tail_route(v2_ok, static, fits, fused=route != "nonfused", v3=v3) == route


def test_geometry_outside_both_gates_raises():
    """Window rows wider than 128 lanes (OW * S > 128: a 15-wide window over
    the armed combat config's 9 token slots per cell in base 4) fail the v2
    and the v1 gate. make_obs_fn no longer raises for them: it routes them to
    the non-fused path (kernels B7 and B8), whose observations
    tests/test_torch_obs_nonfused.py holds to the JAX engine."""
    from mettagrid_tpu_torch.tools.bench_run import make_combat_cfg

    cfg = make_combat_cfg(4)
    cfg.game.map_builder = RandomMapBuilder.Config(agents=4, width=11, height=11, border_width=1, objects={"wall": 6})
    cfg.game.obs.token_value_base = 4
    cfg.game.obs.width = cfg.game.obs.height = 15
    program = tengine.compile_program(cfg)
    b = cfg.game.map_builder.create()
    b.config.seed = 1
    init = tengine.build_env_init(program, [b.build_for_num_agents(4)])
    assert program.obs_width * tobs.make_stage1(program).num_slots > 128
    fn = tobs.make_obs_fn(program, tobs.build_static_bg(program, init, "cpu"))
    assert fn.route == "nonfused"
