"""The slice as a whole on the CPU: the port's engine driven by the port's
LSTMPolicy in lockstep with the JAX engine driven by the flax LSTMPolicy.

Both engines compile one small arena (4 agents, 2 envs); the port starts
from the JAX reset state (engine/interop.py) and the flax parameters are
carried across by ``policy/interop.params_from_flax``. At every one of 10
steps each policy reads its own engine's observations: the logits, values
and LSTM state must agree within atol = rtol = 1e-5 (float32; the pooled
sums run in another order). Both engines then step with one set of
actions, the argmax of the JAX logits, and one agent order drawn with
numpy (``external_perm``): observations, rewards and terminals must be
equal (exact). Also: ``TorchMultiAgentPolicy.step_batch`` on an
``[E, A, T, 3]`` tensor (read without a copy, actions written into a
tensor) and on ``[E·A, T, 3]`` numpy gives one recurrent state, and two
policies with one seed give one action stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mettagrid_tpu.builder as jbuilder
import mettagrid_tpu.engine as jengine
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu.policy import lstm as jlstm
from mettagrid_tpu_torch import builder as tbuilder
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.engine.interop import state_from_numpy
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from mettagrid_tpu_torch.policy import LSTMPolicy, LSTMState, TorchMultiAgentPolicy, params_from_flax
from mettagrid_tpu_torch.policy.policy import as_tokens

A, E, STEPS = 4, 2, 10
TOL = dict(atol=1e-5, rtol=1e-5)


def _arena(eng, builder_mod, rmb):
    cfg = builder_mod.make_arena(
        A, combat=False, map_builder=rmb.Config(agents=A, width=11, height=11, border_width=1, objects={"wall": 6})
    )
    cfg.game.max_steps = 40
    program = eng.compile_program(cfg)
    b = cfg.game.map_builder.create()
    b.config.seed = 3
    return program, eng.build_env_init(program, [b.build_for_num_agents(A)])


class _Info:
    def __init__(self, program):
        self.action_names = [n for n in program.action_names if not n.startswith("change_vibe_")]


def test_policy_drives_engine_in_lockstep_with_jax():
    jp, ji = _arena(jengine, jbuilder, JRandomMapBuilder)
    tp, ti = _arena(tengine, tbuilder, RandomMapBuilder)
    n_actions = len(_Info(tp).action_names)
    jstate, jout = jengine.make_reset(jp, ji, E)(0)
    jstep = jengine.make_step(jp, ji, auto_reset=True, donate=False, external_perm=True)
    tstep = tengine.make_step(tp, ti, auto_reset=True, external_perm=True, device="cpu")
    tstate = state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate._fields}, "cpu")
    tout_obs = torch.from_numpy(np.asarray(jout.observations).copy())

    jnet = jlstm.LSTMPolicy(num_actions=n_actions, hidden_size=32, encoder_hidden=48)
    jlstate = jnet.initial_state((E, A))
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(0), jout.observations, jlstate))
    net = params_from_flax(LSTMPolicy(n_actions, 32, 48, device="cpu"), params)
    tlstate = net.initial_state((E, A))
    japply = jax.jit(jnet.apply)
    jbuf = jout.observations
    rng = np.random.default_rng(0)
    zeros = np.zeros((E, A), np.int32)
    for i in range(STEPS):
        jl, jv, jlstate = japply(params, jbuf, jlstate)
        with torch.no_grad():
            tl, tv, tlstate = net(tout_obs, tlstate)
        for what, got, want in (("logits", tl, jl), ("value", tv, jv), ("h", tlstate.h, jlstate.h),
                                ("c", tlstate.c, jlstate.c)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {i}: {what}")
        acts = np.asarray(jl).argmax(-1).astype(np.int32)
        perm = np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32)
        jstate, jout = jstep(jstate, jnp.asarray(acts), jnp.asarray(zeros), jnp.asarray(perm), jbuf)
        tstate, tout = tstep(tstate, torch.from_numpy(acts), torch.from_numpy(zeros), torch.from_numpy(perm), tout_obs)
        for name in ("observations", "rewards", "terminals"):
            np.testing.assert_array_equal(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                          err_msg=f"step {i}: {name}")
        jbuf, tout_obs = jout.observations, tout.observations
    assert int((tstate.obj_r[:, :A] != tstate.agent_spawn_r).sum()) > 0, "no agent moved"


def _engine_obs():
    program, init = _arena(tengine, tbuilder, RandomMapBuilder)
    state, out = tengine.make_reset(program, init, E, device="cpu")(0)
    step = tengine.make_step(program, init, device="cpu")
    acts = torch.from_numpy(np.random.default_rng(1).integers(0, 5, (E, A)).astype(np.int32))
    state, out = step(state, acts, torch.zeros_like(acts), None, out.observations)
    return program, out.observations.clone()


def test_step_batch_on_tensors_and_numpy():
    program, obs = _engine_obs()
    info = _Info(program)
    assert as_tokens(obs, torch.device("cpu")).data_ptr() == obs.data_ptr()
    on_tensor, on_numpy = TorchMultiAgentPolicy(info, seed=2, device="cpu"), TorchMultiAgentPolicy(info, seed=2,
                                                                                                   device="cpu")
    t_acts = torch.full((E, A), -1, dtype=torch.int32)
    n_acts = np.full(E * A, -1, np.int32)
    for _ in range(3):
        on_tensor.step_batch(obs, t_acts)
        on_numpy.step_batch(obs.numpy().reshape(E * A, -1, 3), n_acts)
        assert 0 <= int(t_acts.min()) and int(t_acts.max()) < len(info.action_names)
        assert 0 <= n_acts.min() and n_acts.max() < len(info.action_names)
        np.testing.assert_array_equal(t_acts.numpy().reshape(-1), n_acts)
    h_t, h_n = on_tensor._lstm_state.h, on_numpy._lstm_state.h
    assert tuple(h_t.shape) == (E, A, 128) and tuple(h_n.shape) == (E * A, 128)
    torch.testing.assert_close(h_t.reshape(E * A, -1), h_n, **TOL)
    with torch.no_grad():
        net = on_tensor.network()
        state = LSTMState(*(torch.zeros(E, A, 128) for _ in range(2)))
        for _ in range(3):
            _, _, state = net(obs, state)
    torch.testing.assert_close(state.h, h_t, **TOL)


def test_one_seed_one_action_stream():
    program, obs = _engine_obs()
    info = _Info(program)
    streams = []
    for seed in (5, 5, 6):
        policy = TorchMultiAgentPolicy(info, seed=seed, device="cpu")
        acts = np.zeros(E * A, np.int32)
        stream = []
        for _ in range(6):
            policy.step_batch(obs.numpy().reshape(E * A, -1, 3), acts)
            stream.append(acts.copy())
        streams.append(np.stack(stream))
    np.testing.assert_array_equal(streams[0], streams[1])
    assert not np.array_equal(streams[0], streams[2])
