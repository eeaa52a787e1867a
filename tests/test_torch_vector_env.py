"""The port's vector env and its wrappers, on the CPU.

- Lockstep with the JAX package's ``MettaGridVectorEnv``: one agent and a
  one-map pool, so that no draw of either engine's generator reaches the
  trajectory (the agent order of one agent, the map pick of a one-map pool);
  every buffer after every step, and every ``infos["episode"]`` (stats
  dicts, episode rewards, length) across the auto-resets, must be equal.
- Against the port's own engine at four agents and a pool of three maps:
  the env's buffers and infos equal ``make_step``'s outputs driven with a
  generator seeded like the env's.
- Twins of tests/test_envs.py: shapes and dtypes, running past the episode
  end, the puffer 2-D transport, the PettingZoo API, the grid-obs wrapper,
  infos with a supervisor (a stub with ``step_batch``).
- Reseeding, and no aliasing of the caller's actions or of the engine's
  tensors.

Tolerance: exact (uint8 observations, rewards that are sums of small
integers, float stats that are counts).
"""

import numpy as np
import torch

from mettagrid_tpu.builder import make_arena as jax_make_arena
from mettagrid_tpu.envs import MettaGridVectorEnv as JaxVectorEnv
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu_torch.builder import make_arena, make_navigation
from mettagrid_tpu_torch.engine import build_env_init, compile_program, make_reset, make_step
from mettagrid_tpu_torch.envs import GridObsWrapper, MettaGridPettingZooEnv, MettaGridPufferEnv, MettaGridVectorEnv
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from mettagrid_tpu_torch.simulator.stats import episode_stats


def arena(agents, size, max_steps, jax=False):
    builder, maps = (jax_make_arena, JRandomMapBuilder) if jax else (make_arena, RandomMapBuilder)
    cfg = builder(agents, combat=False, map_builder=maps.Config(
        agents=agents, width=size, height=size, border_width=1, objects={"wall": 4}))
    cfg.game.max_steps = max_steps
    return cfg


def small_cfg(num_agents=2):
    cfg = make_navigation(num_agents)
    cfg.game.max_steps = 20
    cfg.game.map_builder.width = 8
    cfg.game.map_builder.height = 8
    return cfg


def _assert_buffers_equal(a, b, where):
    for name in ("observations", "rewards", "terminals", "truncations"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=f"{where}{name}")


def test_lockstep_with_jax_env():
    E, steps = 3, 16
    jenv = JaxVectorEnv(arena(1, 9, 6, jax=True), num_envs=E, seed=2, map_pool=1)
    tenv = MettaGridVectorEnv(arena(1, 9, 6), num_envs=E, seed=2, map_pool=1, device="cpu")
    jenv.reset()
    tenv.reset()
    _assert_buffers_equal(jenv.buffers, tenv.buffers, "reset: ")
    rng = np.random.default_rng(0)
    ends = 0
    for i in range(steps):
        acts = rng.integers(0, len(tenv.action_names), E).astype(np.int32)
        *_, jinfo = jenv.step(acts)
        *_, tinfo = tenv.step(acts)
        _assert_buffers_equal(jenv.buffers, tenv.buffers, f"step {i}: ")
        assert tinfo.keys() == jinfo.keys()
        if "episode" in tinfo:
            ends += 1
            assert sorted(tinfo["episode"]) == list(range(E))
            assert tinfo["episode"] == jinfo["episode"], f"step {i}"
            assert all(ep["length"] == 6 and ep["stats"]["agent"][0] for ep in tinfo["episode"].values())
        assert tenv.episode_stats(1) == jenv.episode_stats(1)
    assert ends == 2


def _own_engine(cfg, E, seed, pool):
    """(step, state, out) of the port's engine on the maps the env builds."""
    program = compile_program(cfg)
    builder = cfg.game.map_builder
    maps = [builder.model_copy(update={"seed": seed + i}).create().build_for_num_agents(cfg.game.num_agents)
            for i in range(pool)]
    init = build_env_init(program, maps)
    generator = torch.Generator()
    generator.manual_seed(seed)
    step = make_step(program, init, device="cpu", generator=generator)
    state, out = make_reset(program, init, E, device="cpu")(seed)
    return program, step, state, out


def test_env_equals_own_engine():
    E, A, seed = 4, 4, 3
    cfg = arena(A, 9, 5)
    env = MettaGridVectorEnv(cfg, num_envs=E, seed=seed, map_pool=3, device="cpu")
    program, step, state, out = _own_engine(cfg, E, seed, 3)
    env.reset()
    rng = np.random.default_rng(1)
    ends = 0
    for i in range(12):
        acts = rng.integers(0, len(program.action_names), (E, A)).astype(np.int32)
        _, rew, term, trunc, infos = env.step(acts.reshape(-1))
        state, out = step(state, torch.from_numpy(acts), torch.zeros((E, A), dtype=torch.int32), None,
                          out.observations)
        np.testing.assert_array_equal(env.buffers.observations, out.observations.reshape(E * A, -1, 3).numpy())
        np.testing.assert_array_equal(rew, out.rewards.reshape(-1).numpy())
        np.testing.assert_array_equal(term, out.terminals.reshape(-1).numpy())
        np.testing.assert_array_equal(trunc, out.truncations.reshape(-1).numpy())
        done = (out.terminals | out.truncations).any(dim=1)
        assert ("episode" in infos) == bool(done.any())
        if done.any():
            ends += 1
            for e in torch.nonzero(done).flatten().tolist():
                ep = infos["episode"][e]
                assert ep["stats"] == episode_stats(program, state, e)
                assert ep["episode_rewards"] == state.episode_rewards[e].tolist()
                assert ep["length"] == int(state.step_count[e])
    assert ends == 2
    assert len(set(state.map_idx.tolist())) > 1, "the auto-resets all drew one map"


def _rollout(env, seed, steps=10):
    env.reset(seed)
    rng = np.random.default_rng(4)
    obs = []
    for _ in range(steps):
        env.step(rng.integers(0, len(env.action_names), env.num_agents).astype(np.int32))
        obs.append(env.buffers.observations.copy())
    return np.stack(obs)


def test_reseeding():
    """reset(5) twice rolls out alike, and like a second env built alike;
    reset(6) draws other agent orders and map picks."""
    env = MettaGridVectorEnv(arena(4, 9, 4), num_envs=4, seed=0, map_pool=3, device="cpu")
    first = _rollout(env, 5)
    np.testing.assert_array_equal(_rollout(env, 5), first)
    twin = MettaGridVectorEnv(arena(4, 9, 4), num_envs=4, seed=0, map_pool=3, device="cpu")
    np.testing.assert_array_equal(_rollout(twin, 5), first)
    assert not np.array_equal(_rollout(env, 6), first)


def test_no_aliasing():
    """Overwriting the caller's actions after a step changes nothing in the
    state, and no buffer shares memory with a tensor of the engine."""
    env = MettaGridVectorEnv(arena(2, 9, 0), num_envs=2, seed=0, map_pool=1, device="cpu")
    env.reset()
    acts = np.full(env.num_agents, env.action_names.index("move_east"), dtype=np.int32)
    env.step(acts)
    kept = env.state.agent_last_action.clone()
    acts[:] = 0
    env.buffers.actions[:] = 3
    torch.testing.assert_close(env.state.agent_last_action, kept, rtol=0, atol=0)
    engine = [t for t in (*env.state, *env._last) if isinstance(t, torch.Tensor) and t.numel()]
    for name in ("observations", "rewards", "terminals", "truncations"):
        buf = getattr(env.buffers, name)
        assert not any(np.shares_memory(buf, t.numpy()) for t in engine), name
    before = env.buffers.observations
    env.step(acts)
    assert env.buffers.observations is before


def test_vector_env_shapes_and_dtypes():
    env = MettaGridVectorEnv(small_cfg(), num_envs=3, seed=0, device="cpu")
    obs, _ = env.reset()
    EA = env.num_agents
    T = env.program.num_tokens
    assert obs.shape == (EA, T, 3) and obs.dtype == np.uint8
    acts = np.zeros(EA, dtype=np.int32)
    obs, rew, term, trunc, _ = env.step(acts)
    assert rew.shape == (EA,) and rew.dtype == np.float32
    assert term.dtype == np.bool_ and trunc.dtype == np.bool_
    assert env.single_observation_space.shape == (T, 3)
    assert env.single_action_space.n == len(env.action_names)


def test_vector_env_auto_reset_runs_past_episode_end():
    env = MettaGridVectorEnv(small_cfg(), num_envs=2, seed=0, device="cpu")
    env.reset()
    for _ in range(25):  # runs past max_steps=20 thanks to auto-reset
        obs, rew, term, trunc, _ = env.step(np.zeros(env.num_agents, dtype=np.int32))
    assert not np.any(term), "auto-reset env should have restarted"


def test_puffer_env_2d_action_transport():
    """[primary, vibe] columns step as the vector env's two action streams."""
    env = MettaGridPufferEnv(small_cfg(), num_envs=2, device="cpu")
    env.reset()
    EA = env.num_agents
    acts = np.zeros((EA, 2), dtype=np.int32)
    move_east = env.program.action_names.index("move_east")
    acts[:, 0] = move_east
    obs, rew, term, trunc, _ = env.step(acts)
    assert obs.shape[0] == EA
    venv = MettaGridVectorEnv(small_cfg(), num_envs=2, device="cpu")
    venv.reset()
    venv.step(acts[:, 0], acts[:, 1])
    _assert_buffers_equal(env._venv.buffers, venv.buffers, "")


def test_pettingzoo_parallel_api():
    env = MettaGridPettingZooEnv(small_cfg(), device="cpu")
    observations, infos = env.reset(seed=0)
    assert set(observations) == {"agent_0", "agent_1"}
    actions = {name: 0 for name in env.agents}
    observations, rewards, terms, truncs, infos = env.step(actions)
    assert set(rewards) == {"agent_0", "agent_1"}
    assert all(isinstance(v, float) for v in rewards.values())


def test_grid_obs_wrapper_dense_conversion():
    env = GridObsWrapper(MettaGridVectorEnv(small_cfg(), num_envs=1, device="cpu"))
    obs, _ = env.reset()
    C, H, W = env.single_observation_space.shape
    assert obs.shape == (env.num_agents, C, H, W)
    assert obs.dtype == np.float32
    assert obs.sum() > 0  # something was scattered


class _Supervisor:
    """A teacher that labels every row with action 1."""

    def __init__(self):
        self.calls = 0

    def step_batch(self, raw_observations, raw_actions):
        assert raw_observations.shape[0] == raw_actions.shape[0]
        raw_actions[:] = 1
        self.calls += 1


def test_episode_infos_and_supervisor():
    env = MettaGridVectorEnv(small_cfg(), num_envs=2, seed=0, device="cpu")
    teacher = _Supervisor()
    env.set_supervisor(teacher)
    env.reset()
    infos = {}
    for _ in range(21):  # max_steps=20 -> truncated on step 20
        obs, rew, term, trunc, infos = env.step(np.zeros(env.num_agents, dtype=np.int32))
        if "episode" in infos:
            break
    assert "episode" in infos and sorted(infos["episode"]) == [0, 1]
    ep = infos["episode"][0]
    assert ep["length"] == 20
    assert "agent" in ep["stats"] and len(ep["stats"]["agent"]) == 2
    assert teacher.calls == 20 and (env.buffers.teacher_actions == 1).all()
    assert env.buffers.teacher_actions.shape == (env.num_agents,)


def test_action_shapes():
    """Actions arrive as [E*A] or [E, A] of any integer type, and default to
    the buffers'."""
    envs = [MettaGridVectorEnv(small_cfg(), num_envs=2, seed=0, device="cpu") for _ in range(2)]
    for env in envs:
        env.reset()
    east = envs[0].action_names.index("move_east")
    start = envs[0].state.obj_c.clone()
    envs[0].buffers.actions[:] = east
    envs[0].step()
    envs[1].step(np.full((2, envs[1].agents_per_env), east, dtype=np.int64))
    _assert_buffers_equal(envs[0].buffers, envs[1].buffers, "")
    assert (envs[0].state.obj_c != start).any(), "no agent moved east"
