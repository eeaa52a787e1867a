"""The port's reward phase with several agent configs, against rewards
computed by hand.

Two agent configs each carry one delta-mode reward entry, so both write
column 0 of ``reward_prev``: config 0 rewards hearts, config 1 ore. Over
several steps the inventories change at random and every agent's reward must
be its own value's change since the last step, and ``reward_prev`` its own
value (tolerance: exact; the values are small integers in float32). The
reference rewrites the whole column from the step-start value for each
config, so a later config's write undoes an earlier config's update and
config 0's agents re-count their first value every step; the port updates
each config's own agents only.
"""

import numpy as np
import torch

from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.builder.envs import make_arena
from mettagrid_tpu_torch.config.game_config import AgentConfig
from mettagrid_tpu_torch.config.reward_config import inventoryReward
from mettagrid_tpu_torch.engine.rewards import make_reward_phase
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder

A = 4
E = 3


def _two_config_case():
    cfg = make_arena(A, combat=False, map_builder=RandomMapBuilder.Config(
        agents=A, width=9, height=9, border_width=1, objects={"wall": 4}))
    cfg.game.agents = [
        AgentConfig(name="red", rewards={"hearts": inventoryReward("heart")}),
        AgentConfig(name="blue", rewards={"ore": inventoryReward("ore_red")}),
    ]
    program = tengine.compile_program(cfg)
    b = cfg.game.map_builder.create()
    b.config.seed = 1
    init = tengine.build_env_init(program, [b.build_for_num_agents(A)])
    state, _ = tengine.make_reset(program, init, E, device="cpu")(0)
    return program, state


def test_two_configs_sharing_a_column_keep_their_own_prev():
    program, state = _two_config_case()
    assert [len(p) for p in program.reward_programs] == [1, 1]
    heart = list(program.resource_names).index("heart")
    ore = list(program.resource_names).index("ore_red")
    cfg_of = np.array([0, 1, 1, 0], dtype=np.int32)
    state = state._replace(agent_cfg=torch.from_numpy(np.broadcast_to(cfg_of, (E, A)).copy()))
    reward_phase = make_reward_phase(program)
    rng = np.random.default_rng(0)
    inv = state.obj_inv.numpy().copy()
    own = np.where(cfg_of == 0, inv[:, :A, heart], inv[:, :A, ore]).astype(np.float32)
    prev = state.reward_prev.numpy()[:, :, 0].copy()
    np.testing.assert_array_equal(prev, own)  # reset primes prev with each agent's own value
    episode = np.zeros((E, A), np.float32)
    for t in range(6):
        inv[:, :A, heart] = rng.integers(0, 9, (E, A))
        inv[:, :A, ore] = rng.integers(0, 9, (E, A))
        state = state._replace(obj_inv=torch.from_numpy(inv.copy()), rewards=torch.zeros((E, A)))
        state = reward_phase(state)
        own = np.where(cfg_of == 0, inv[:, :A, heart], inv[:, :A, ore]).astype(np.float32)
        np.testing.assert_array_equal(state.rewards.numpy(), own - prev, err_msg=f"step {t}")
        np.testing.assert_array_equal(state.reward_prev.numpy()[:, :, 0], own, err_msg=f"step {t}")
        episode += own - prev
        np.testing.assert_array_equal(state.episode_rewards.numpy(), episode, err_msg=f"step {t}")
        prev = own
