"""The port's Simulation and Simulator, on the CPU.

- Lockstep with the JAX package's ``Simulation`` under the MT19937 twin
  (``reference_shuffle=True``) from one seed, fed only actions through
  ``SimulationAgent.set_action`` (invalid indices among them, for the
  per-index stat overlay), on a four-agent arena until the episode ends:
  every agent's observation tokens, location, inventory, rewards and action
  success, ``episode_stats``, ``grid_objects()`` and the episode signature
  must be equal after every step, and after ``set_inventory`` and a step.
- Twins of tests/simulator/test_simulation.py and test_talk_and_cache.py:
  the views, the event-handler hooks, the invariant check of ``Simulator``,
  episode stats, and talk.

Tolerance: exact (integers; float stats and rewards that are counts).
"""

import numpy as np
import pytest

from mettagrid_tpu.builder import make_arena as jax_make_arena
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu.parity.signature import episode_signature as jax_signature
from mettagrid_tpu.simulator import Simulation as JaxSimulation
from mettagrid_tpu_torch.builder import make_arena
from mettagrid_tpu_torch.config.game_config import GameConfig, MettaGridConfig, TalkConfig, WallConfig
from mettagrid_tpu_torch.maps.ascii import AsciiMapBuilder
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from mettagrid_tpu_torch.parity import episode_signature
from mettagrid_tpu_torch.simulator import Simulation, Simulator, SimulatorEventHandler


def arena(jax=False):
    builder, maps = (jax_make_arena, JRandomMapBuilder) if jax else (make_arena, RandomMapBuilder)
    cfg = builder(4, combat=True, map_builder=maps.Config(
        agents=4, width=10, height=10, border_width=1, objects={"wall": 6}))
    cfg.game.max_steps = 14
    cfg.game.agent.inventory.initial = {"laser": 2, "armor": 1, "heart": 3}
    return cfg


def _tokens(agent):
    return [(t.location_byte, t.feature_id, t.feature_name, t.value) for t in agent.observation.tokens]


def _assert_sims_equal(j, t, where):
    assert t.current_step == j.current_step, where
    assert t.is_done == j.is_done, where
    for ja, ta in zip(j.agents, t.agents):
        assert _tokens(ta) == _tokens(ja), f"{where}agent {ta.id} observation"
        assert tuple(ta.location) == tuple(ja.location), where
        assert ta.inventory == ja.inventory, where
        assert (ta.step_reward, ta.episode_reward) == (ja.step_reward, ja.episode_reward), where
        assert ta.last_action_success == ja.last_action_success, where
        assert ta.global_observations == ja.global_observations, where
    assert t.action_success == j.action_success, where
    np.testing.assert_array_equal(t.episode_rewards, j.episode_rewards, err_msg=where)
    assert t.episode_stats == j.episode_stats, where
    assert t.grid_objects() == j.grid_objects(), where
    assert episode_signature(t.program, t.state) == jax_signature(j.program, j.state), where


def test_lockstep_with_jax_simulation():
    j = JaxSimulation(arena(jax=True), seed=5, reference_shuffle=True)
    t = Simulation(arena(), seed=5, reference_shuffle=True, device="cpu")
    _assert_sims_equal(j, t, "reset: ")
    names = t.action_names
    rng = np.random.default_rng(2)
    steps = 0
    while not t.is_done:
        if steps == 5:
            for sim in (j, t):
                sim.agent(0).set_inventory({"heart": 2, "laser": 1})
                sim.agent(2).set_inventory({})
            _assert_sims_equal(j, t, "set_inventory: ")
        for a in range(4):
            pick = int(rng.integers(-1, len(names) + 1))
            action = names[pick] if 0 <= pick < len(names) and pick % 2 else pick
            for sim in (j, t):
                sim.agent(a).set_action(action)
        j.step()
        t.step()
        steps += 1
        _assert_sims_equal(j, t, f"step {steps}: ")
    assert j.is_done and steps == 14
    stats = t.episode_stats["agent"]
    assert any(k.startswith("action.invalid_index.") for s in stats for k in s), "no invalid index was fed"
    assert int(t.state.mt[0, 624]) > 0, "the twin never drew"


def nav_config(max_steps=10) -> MettaGridConfig:
    return MettaGridConfig(
        game=GameConfig(
            num_agents=1,
            max_steps=max_steps,
            objects={"wall": WallConfig()},
            map_builder=AsciiMapBuilder.Config(map_data=["#####", "#@..#", "#####"]),
        )
    )


def test_simulation_step_and_views():
    sim = Simulation(nav_config(), device="cpu")
    agent = sim.agent(0)
    assert agent.location == (1, 1)
    agent.set_action("move_east")
    sim.step()
    assert agent.location == (1, 2)
    assert agent.last_action_success
    assert sim.current_step == 1
    assert sim.action_names[0] == "noop"
    assert not sim.is_done
    assert sim.episode_stats["agent"][0].get("action.move.success") == 1.0
    assert "tag" in {t.feature_name for t in agent.observation.tokens}
    assert "episode_completion_pct" in agent.global_observations
    objs = sim.grid_objects()
    assert {o["type_name"] for o in objs.values()} == {"wall", "agent"}
    agents = [o for o in objs.values() if "agent_id" in o]
    assert len(agents) == 1 and (agents[0]["r"], agents[0]["c"]) == (1, 2)


def test_simulation_runs_to_done():
    hooks = []

    class Recorder(SimulatorEventHandler):
        def on_episode_start(self):
            hooks.append("start")

        def on_step(self):
            hooks.append("step")

        def on_episode_end(self):
            hooks.append("end")

        def on_close(self):
            hooks.append("close")

    sim = Simulation(nav_config(max_steps=3), event_handlers=[Recorder()], device="cpu")
    while not sim.is_done:
        sim.step()
    sim.close()
    assert hooks == ["start", "step", "step", "step", "end", "close"]


def test_simulator_invariant_enforcement():
    simr = Simulator()
    first = simr.new_simulation(nav_config(), seed=1, device="cpu")
    second = simr.new_simulation(nav_config(), seed=1, device="cpu")  # same invariants OK
    assert (first.seed, second.seed) == (1, 2)
    cfg2 = nav_config()
    cfg2.game.num_agents = 2
    cfg2.game.map_builder = AsciiMapBuilder.Config(map_data=["#####", "#@@.#", "#####"])
    with pytest.raises(ValueError, match="invariants"):
        simr.new_simulation(cfg2, device="cpu")
    simr.close()
    assert first._closed and second._closed


def talk_config(enabled=True):
    return MettaGridConfig(
        game=GameConfig(
            num_agents=2,
            max_steps=50,
            objects={"wall": WallConfig()},
            talk=TalkConfig(enabled=enabled, max_length=10, cooldown_steps=3),
            map_builder=AsciiMapBuilder.Config(map_data=["######", "#@.@.#", "######"]),
        )
    )


def test_talk():
    sim = Simulation(talk_config(), device="cpu")
    with pytest.raises(ValueError):
        sim.agent(0).set_talk("this is way too long")
    sim.agent(0).set_talk("hi")
    sim.step()
    assert sim.talk_states()[0].text == "hi"
    # Agent 1 is within the 13x13 window -> sees agent 0's message.
    assert any(v.agent_id == 0 and v.text == "hi" for v in sim.agent(1).visible_talk)
    with pytest.raises(ValueError):
        sim.agent(0).set_talk("two")  # cooldown active
    with pytest.raises(ValueError):
        Simulation(talk_config(enabled=False), device="cpu").agent(0).set_talk("x")
