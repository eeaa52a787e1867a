"""Kernel B1's plain version and the port's observation function against
the JAX engine, exactly.

The B1 inputs come from a real small arena state (E=8, A=4), built as the
JAX package's own kernel tests build it; the JAX Pallas kernel runs in
interpret mode. Widths 11 and 40 give one and two 128-lane tiles per image
row (NT == 1 and NT > 1 in the Pallas kernel). Tolerance: exact (integer
token words).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mettagrid_tpu.builder as jbuilder
import mettagrid_tpu.engine as jengine
import mettagrid_tpu.engine.obs as jobs
from mettagrid_tpu.engine.pallas_kernels import obs_tail_static_v2_pallas
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu_torch import builder as tbuilder
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.engine import obs as tobs
from mettagrid_tpu_torch.engine.step import step_gates
from mettagrid_tpu_torch.engine.interop import state_from_numpy
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import obs_tail_static_v2, obs_tail_static_v2_ref
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder

A = 4
E = 8


def _arena(eng, builder_mod, rmb, width):
    cfg = builder_mod.make_arena(
        A, combat=False,
        map_builder=rmb.Config(agents=A, width=width, height=11, border_width=1, objects={"wall": 6}),
    )
    program = eng.compile_program(cfg)
    b = cfg.game.map_builder.create()
    maps = []
    for i in range(3):
        b.config.seed = 10 + i
        maps.append(b.build_for_num_agents(A))
    return program, eng.build_env_init(program, maps)


_CACHE = {}


def _jax_case(width, seed):
    """(program, init, state) of the JAX engine after 3 random steps."""
    key = (width, seed)
    if key not in _CACHE:
        program, init = _arena(jengine, jbuilder, JRandomMapBuilder, width)
        state, _ = jengine.make_reset(program, init, E)(seed)
        step = jengine.make_step(program, init, auto_reset=False, donate=False)
        rng = np.random.default_rng(seed)
        for _ in range(3):
            acts = jnp.asarray(rng.integers(0, len(program.action_names), (E, A)), dtype=jnp.int32)
            state, _ = step(state, acts, jnp.zeros((E, A), jnp.int32))
        _CACHE[key] = (program, init, state)
    return _CACHE[key]


def _port_obs_fn(width):
    program, init = _arena(tengine, tbuilder, RandomMapBuilder, width)
    assert step_gates(program).static_bg
    return tobs.make_obs_fn(program, tobs.build_static_bg(program, init, "cpu"))


def _state_numpy(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("width", [11, 40])
def test_ref_matches_pallas_interpret(width, wide, seed):
    program, init, state = _jax_case(width, seed)
    fn = jobs.make_obs_fn(program, static_bg=jobs.build_static_bg(program, init))
    t = fn._tables
    assert t["v2_ok"] and (t["WPC_f"] > 128) == (width > 11)
    S, hr, wr = t["S"], t["hr"], t["wr"]
    agent_r = state.obj_r[:, :A]
    agent_c = state.obj_c[:, :A]
    slots = jnp.broadcast_to(jnp.arange(A, dtype=jnp.int32)[None, :], (E, A))
    tok, cnt = t["stage1"](
        state.obj_type[:, :A], state.obj_vibe[:, :A], state.obj_tags[:, :A], state.obj_inv[:, :A],
        state.obj_alive[:, :A], jnp.ones((E, A), dtype=bool), state.agent_group, slots,
    )
    words = (tok + (jnp.arange(S)[None, None, :] < cnt[..., None])).astype(jnp.int32)
    args = dict(
        static_imgp=t["imgp_static_i32"], map_idx=state.map_idx, row0=agent_r, lane0=agent_c * S,
        rext=agent_r + hr, lext=(agent_c + wr) * S, words=words, gplus=t["global_plus"](state, E),
    )
    loc_sh = 14 if wide else 15
    loc15 = np.asarray(t["loc15"]) >> 15 << loc_sh  # the location table for this packing
    port_fn = _port_obs_fn(width)
    jw, ja = obs_tail_static_v2_pallas(
        *args.values(), t["perm2"], t["tri2"], jnp.asarray(loc15), t["OH"], t["OW"] * S, t["KS"],
        out_w=port_fn.out_w, wide=wide, interpret=True,
    )
    # The port prepares the same kernel inputs from the same state.
    port_args = port_fn.tail_inputs(state_from_numpy(_state_numpy(state), "cpu"))
    for k, v in args.items():
        np.testing.assert_array_equal(port_args[k].numpy(), np.asarray(v), err_msg=k)
    tw, ta = obs_tail_static_v2_ref(**port_args, out_w=port_fn.out_w, wide=wide)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("width", [11, 40])
def test_obs_fn_matches_jax_fused_and_xla(width):
    """The port's whole observation function against the JAX static path with
    the fused kernel in interpret mode, and against the plain XLA path."""
    program, init, state = _jax_case(width, 0)
    xla_obs, xla_att = jobs.make_obs_fn(program)(state)
    bg = jobs.build_static_bg(program, init)
    jobs._FORCE_FUSED_INTERPRET = True
    old_v2, old_force = jobs._OBS_V2, jobs._FORCE_STATIC_TAIL
    jobs._OBS_V2, jobs._FORCE_STATIC_TAIL = True, "v2"
    try:
        fused_obs, fused_att = jobs.make_obs_fn(program, static_bg=bg)(state)
        assert jobs._LAST_TAIL == "static_v2"
    finally:
        jobs._FORCE_FUSED_INTERPRET = False
        jobs._OBS_V2, jobs._FORCE_STATIC_TAIL = old_v2, old_force

    obs_fn = _port_obs_fn(width)
    tstate = state_from_numpy(_state_numpy(state), "cpu")
    before = obs_tail_static_v2.launches
    obs, att = obs_fn(tstate)
    assert obs_tail_static_v2.launches == before  # CPU tensors take the plain version
    for ref_obs, ref_att in ((fused_obs, fused_att), (xla_obs, xla_att)):
        np.testing.assert_array_equal(obs.numpy(), np.asarray(ref_obs))
        np.testing.assert_array_equal(att.numpy(), np.asarray(ref_att))

    # A carried buffer is rewritten in place over its prefix, to the same bytes.
    buf = torch.full_like(obs, 0xFF)
    buf[:, :, : obs_fn.out_w // 2] = 0xAB
    carried, _ = obs_fn(tstate, obs_buf=buf)
    assert carried is buf
    np.testing.assert_array_equal(carried.numpy(), np.asarray(xla_obs))
