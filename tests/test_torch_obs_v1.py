"""Kernels B4's and B5's plain versions and the port's v1 observation routes
against the JAX engine, exactly.

The inputs come from a real small arena state with local position on (E=8,
A=4, after 0 or 4 random steps, so agents stand on their spawn cells, where
their lp tokens are absent, or have left them). The JAX Pallas kernels
``obs_tail_static_pallas`` (B4) and ``obs_tail_pallas`` (B5) run in interpret
mode. Map widths 10 and 40 give one and two 128-lane tiles per image row.
Both kernels are also held at a budget of 16 words, below the valid
candidates, so the compaction truncates. Tolerance: exact (integer token
words).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import mettagrid_tpu.builder as jbuilder
import mettagrid_tpu.engine as jengine
import mettagrid_tpu.engine.obs as jobs
from mettagrid_tpu.engine.pallas_kernels import obs_tail_pallas, obs_tail_static_pallas
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu_torch import builder as tbuilder
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.engine import obs as tobs
from mettagrid_tpu_torch.engine.interop import state_from_numpy
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v1 import obs_tail_static_v1, obs_tail_static_v1_ref
from mettagrid_tpu_torch.engine.kernels.obs_tail_v1 import obs_tail_v1, obs_tail_v1_ref
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder

A = 4
E = 8


def _arena(eng, builder_mod, rmb, width):
    cfg = builder_mod.make_arena(
        A, combat=False,
        map_builder=rmb.Config(agents=A, width=width, height=10, border_width=1, objects={"wall": 6}),
    )
    cfg.game.obs.global_obs.local_position = True
    program = eng.compile_program(cfg)
    b = cfg.game.map_builder.create()
    maps = []
    for i in range(3):
        b.config.seed = 20 + i
        maps.append(b.build_for_num_agents(A))
    return program, eng.build_env_init(program, maps)


_ENGINES = {}
_STATES = {}
_TABLES = {}


def _case(width, steps):
    """(JAX program, JAX init, port program, port init, JAX state after
    ``steps`` random steps)."""
    if width not in _ENGINES:
        jp, ji = _arena(jengine, jbuilder, JRandomMapBuilder, width)
        tp, ti = _arena(tengine, tbuilder, RandomMapBuilder, width)
        state, _ = jengine.make_reset(jp, ji, E)(0)
        _ENGINES[width] = (jp, ji, tp, ti, jengine.make_step(jp, ji, auto_reset=False, donate=False))
        _STATES[width, 0] = state
    jp, ji, tp, ti, step = _ENGINES[width]
    if (width, steps) not in _STATES:
        state = _STATES[width, 0]
        rng = np.random.default_rng(width)
        for _ in range(steps):
            acts = jnp.asarray(rng.integers(0, len(jp.action_names), (E, A)), dtype=jnp.int32)
            state, _ = step(state, acts, jnp.zeros((E, A), jnp.int32))
        _STATES[width, steps] = state
    return jp, ji, tp, ti, _STATES[width, steps]


def _tables(width, static):
    """The JAX obs function's tables for the static or mutable background."""
    if (width, static) not in _TABLES:
        jp, ji, *_ = _case(width, 0)
        _TABLES[width, static] = jobs.make_obs_fn(jp, static_bg=jobs.build_static_bg(jp, ji) if static else None)._tables
    return _TABLES[width, static]


def _port_state(state):
    return state_from_numpy({f: np.asarray(getattr(state, f)) for f in state._fields}, "cpu")


def _check_globals(gwords, steps):
    """lp tokens absent on the spawn cell (every agent at reset), present
    for some agents after steps."""
    lp = np.asarray(gwords)[..., -2:]
    if steps == 0:
        assert (lp == 0).all()
    else:
        assert (lp == 0).any() and (lp > 0).any()


CASES = [(10, "full"), (40, "full"), (10, 16)]


@pytest.mark.parametrize("width,budget", CASES)
def test_b4_ref_matches_pallas_interpret(width, budget):
    for steps in (0, 4):
        _b4_case(width, steps, budget)


def _b4_case(width, steps, budget):
    jp, ji, tp, ti, state = _case(width, steps)
    t = _tables(width, True)
    assert not t["v2_ok"] and t["imgp_static_i32"] is not None
    assert (t["WPC_f"] > 128) == (width > 10)
    S, hr, wr = t["S"], t["hr"], t["wr"]
    agent_r, agent_c = state.obj_r[:, :A], state.obj_c[:, :A]
    slots = jnp.broadcast_to(jnp.arange(A, dtype=jnp.int32)[None, :], (E, A))
    tok, cnt = t["stage1"](
        state.obj_type[:, :A], state.obj_vibe[:, :A], state.obj_tags[:, :A], state.obj_inv[:, :A],
        state.obj_alive[:, :A], jnp.ones((E, A), dtype=bool), state.agent_group, slots,
    )
    words = (tok + (jnp.arange(S)[None, None, :] < cnt[..., None])).astype(jnp.int32)
    args = dict(
        static_imgp=t["imgp_static_i32"], map_idx=state.map_idx, row0=agent_r, lane0=agent_c * S,
        rext=agent_r + hr, lext=(agent_c + wr) * S, words=words, gwords=t["global_plus"](state, E),
    )
    _check_globals(args["gwords"], steps)
    fn = tobs.make_obs_fn(tp, tobs.build_static_bg(tp, ti, "cpu"))
    assert fn.tail is obs_tail_static_v1 and fn.wide is None
    t_pad = fn.out_w if budget == "full" else budget
    jw, ja = obs_tail_static_pallas(
        *args.values(), t["perm_fused"], t["make_loc_const"](args["gwords"].shape[-1]), t_pad, interpret=True,
    )
    # The port prepares the same kernel inputs from the same state.
    port_args = fn.tail_inputs(_port_state(state))
    for k, v in args.items():
        np.testing.assert_array_equal(port_args[k].numpy(), np.asarray(v), err_msg=k)
    tw, ta = obs_tail_static_v1_ref(**port_args, out_w=t_pad)
    assert tw.shape[-1] == np.asarray(jw).shape[-1] == t_pad
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    if budget != "full":
        assert int(ta.min()) > t_pad, "the budget did not truncate"


@pytest.mark.parametrize("width,budget", CASES)
def test_b5_ref_matches_pallas_interpret(width, budget):
    """The mutable-background route (B5) over the port's per-env image: the
    same inputs through the Pallas kernel and the plain version."""
    for steps in (0, 4):
        _b5_case(width, steps, budget)


def _b5_case(width, steps, budget):
    jp, _, tp, _, state = _case(width, steps)
    t = _tables(width, False)
    fn = tobs.make_obs_fn(tp, None, "cpu")
    assert fn.tail is obs_tail_v1 and fn.wide is None
    port_args = fn.tail_inputs(_port_state(state))
    assert tuple(port_args["imgp"].shape[1:]) == (t["HP_f"], t["WPC_f"])
    gwords = t["global_plus"](state, E)
    np.testing.assert_array_equal(port_args["gwords"].numpy(), np.asarray(gwords))
    _check_globals(gwords, steps)
    t_pad = fn.out_w if budget == "full" else budget
    jw, ja = obs_tail_pallas(
        jnp.asarray(port_args["imgp"].numpy()), state.obj_r[:, :A], state.obj_c[:, :A] * t["S"], gwords,
        t["perm_fused"], t["make_loc_const"](gwords.shape[-1]), t_pad, interpret=True,
    )
    tw, ta = obs_tail_v1_ref(**port_args, out_w=t_pad)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    if budget != "full":
        assert int(ta.min()) > t_pad, "the budget did not truncate"


@pytest.mark.parametrize("background", ["static", "mutable"])
@pytest.mark.parametrize("width", [10, 40])
def test_obs_fn_matches_jax_v1_and_xla(width, background):
    """The port's whole v1 observation function (B4 over the static pool, B5
    over the image built from every object) against the JAX engine's v1
    route with the Pallas kernel in interpret mode. (The JAX package's own
    tests hold that route equal to its plain XLA route.)"""
    jp, ji, tp, ti, state = _case(width, 4)
    jbg = jobs.build_static_bg(jp, ji) if background == "static" else None
    jobs._FORCE_FUSED_INTERPRET = True
    old_v2 = jobs._OBS_V2
    jobs._OBS_V2 = False
    try:
        fused_obs, fused_att = jobs.make_obs_fn(jp, static_bg=jbg)(state)
        assert jobs._LAST_TAIL == ("static_v1" if background == "static" else "dyn_v1")
    finally:
        jobs._FORCE_FUSED_INTERPRET = False
        jobs._OBS_V2 = old_v2
    fn = tobs.make_obs_fn(tp, tobs.build_static_bg(tp, ti, "cpu") if background == "static" else None, "cpu")
    kernel = obs_tail_static_v1 if background == "static" else obs_tail_v1
    assert fn.tail is kernel
    before = kernel.launches
    obs, att = fn(_port_state(state))
    assert kernel.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(obs.numpy(), np.asarray(fused_obs))
    np.testing.assert_array_equal(att.numpy(), np.asarray(fused_att))
