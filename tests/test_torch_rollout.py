"""The port's Rollout, multi-episode runs, replays, stats writer and episode
runner on the CPU: twins of tests/simulator/test_multi_episode.py,
test_overage_budget.py, test_replay.py and tests/runner/test_episode_runner.py,
and the port against the JAX package on one episode.

The comparison with the JAX package drives both with
``RandomMultiAgentPolicy``, whose numpy stream is the same in both packages,
on a map where every agent has a room of its own: no agent can reach
another's cells, so the agent order each step draws (jax.random in the JAX
package, a torch.Generator in the port) cannot change the outcome. Steps,
episode rewards and episode stats must be equal, as must the decoded v4
replay and the runner's EpisodeResult (tolerance: exact).
"""

import json
import time
import zlib

import numpy as np
import pytest

import mettagrid_tpu.config.game_config as jgc
import mettagrid_tpu.maps.ascii as jascii
import mettagrid_tpu_torch.config.game_config as tgc
import mettagrid_tpu_torch.maps.ascii as tascii
from mettagrid_tpu.policy.policy import PolicySpec as JPolicySpec
from mettagrid_tpu.policy.policy import RandomMultiAgentPolicy as JRandomMultiAgentPolicy
from mettagrid_tpu.runner import EpisodeRequest as JEpisodeRequest
from mettagrid_tpu.runner import run_episode_local as jax_run_episode_local
from mettagrid_tpu.simulator.multi_episode import run_multi_episode as jax_run_multi_episode
from mettagrid_tpu.simulator.replay_writer import InMemoryReplayWriter as JInMemoryReplayWriter
from mettagrid_tpu.simulator.rollout import Rollout as JRollout
from mettagrid_tpu_torch.envs.early_reset_handler import EarlyResetHandler
from mettagrid_tpu_torch.policy.policy import MultiAgentPolicy, PolicySpec, RandomMultiAgentPolicy
from mettagrid_tpu_torch.runner import EpisodeRequest, run_episode_isolated, run_episode_local
from mettagrid_tpu_torch.simulator import Simulation
from mettagrid_tpu_torch.simulator.multi_episode import run_multi_episode, summarize
from mettagrid_tpu_torch.simulator.replay_writer import InMemoryReplayWriter, ReplayLogWriter
from mettagrid_tpu_torch.simulator.rollout import Rollout
from mettagrid_tpu_torch.util.stats_writer import JsonlStatsWriter, StatsWriterHandler

ROOMS = ["##########", "#@.#.@#..#", "#..#..#.@#", "##########"]


class _Info:
    action_names = ["noop", "move_north", "move_south", "move_west", "move_east"]


def config(jax=False, num_agents=2, max_steps=4, map_data=("######", "#@.@.#", "######")):
    gc, ascii_mod = (jgc, jascii) if jax else (tgc, tascii)
    return gc.MettaGridConfig(
        game=gc.GameConfig(
            num_agents=num_agents,
            max_steps=max_steps,
            objects={"wall": gc.WallConfig()},
            map_builder=ascii_mod.AsciiMapBuilder.Config(map_data=list(map_data)),
        )
    )


def rooms(jax=False, max_steps=12):
    return config(jax, num_agents=3, max_steps=max_steps, map_data=ROOMS)


# --- twins of tests/simulator/test_multi_episode.py ---


def test_multi_episode_and_summary():
    policy = RandomMultiAgentPolicy(_Info(), seed=0)
    result = run_multi_episode(config(), [(policy, [0, 1])], episodes=3, device="cpu")
    assert len(result.episode_rewards) == 3
    summary = summarize(result, [[0, 1]])
    assert summary.episodes == 3
    assert summary.policy_summaries[0].agent_count == 2
    assert len(summary.per_episode_per_policy_avg_rewards) == 3


def test_stats_writer_records_episode(tmp_path):
    writer = JsonlStatsWriter(tmp_path)
    rollout = Rollout(config(), RandomMultiAgentPolicy(_Info()), event_handlers=[StatsWriterHandler(writer).handler],
                      device="cpu")
    rollout.run()
    lines = (tmp_path / "episodes.jsonl").read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["step_count"] == 4
    assert "0" in rec["agent_metrics"] and rec["agent_groups"] == {"0": 0, "1": 0}


def test_early_reset_handler_desyncs():
    sim = Simulation(config(max_steps=100), seed=5, event_handlers=[EarlyResetHandler()], device="cpu")
    steps = 0
    while not sim.is_done and steps < 150:
        sim.step()
        steps += 1
    assert steps < 101, "early reset should end the episode before max_steps"


# --- twins of tests/simulator/test_overage_budget.py ---


class SlowPolicy(MultiAgentPolicy):
    def __init__(self, sleep_ms: float):
        super().__init__(None)
        self._sleep_ms = sleep_ms
        self.call_count = 0

    def step_batch(self, raw_observations, raw_actions) -> None:
        self.call_count += 1
        time.sleep(self._sleep_ms / 1000.0)
        raw_actions[:] = 1  # would move if allowed


class FastPolicy(MultiAgentPolicy):
    def __init__(self):
        super().__init__(None)
        self.call_count = 0

    def step_batch(self, raw_observations, raw_actions) -> None:
        self.call_count += 1
        raw_actions[:] = 0


def _overage_cfg():
    return config(max_steps=50, map_data=("#####", "#@.@#", "#####"))


def test_timeout_replaces_action_with_noop_and_counts():
    slow = SlowPolicy(sleep_ms=80)
    r = Rollout(_overage_cfg(), slow, max_action_time_ms=20, device="cpu")
    for _ in range(3):
        r.step()
    assert r.timeout_counts[0] == 3
    assert r.overage_exceeded_at[0] is None  # no budget configured
    st = r.simulation.state
    assert st.obj_r[0, :2].tolist() == st.agent_spawn_r[0].tolist()
    assert st.obj_c[0, :2].tolist() == st.agent_spawn_c[0].tolist()


def test_overage_budget_disables_policy():
    slow = SlowPolicy(sleep_ms=80)
    r = Rollout(_overage_cfg(), slow, max_action_time_ms=20, overage_budget_ms=100, device="cpu")
    for _ in range(6):
        r.step()
    assert r.overage_exceeded_at[0] is not None
    calls_at_disable = slow.call_count
    for _ in range(3):
        r.step()
    assert slow.call_count == calls_at_disable


def test_fast_policy_unaffected_alongside_slow():
    slow, fast = SlowPolicy(sleep_ms=80), FastPolicy()
    r = Rollout(_overage_cfg(), [(slow, [0]), (fast, [1])], max_action_time_ms=20, overage_budget_ms=100,
                device="cpu")
    for _ in range(6):
        r.step()
    assert r.overage_exceeded_at[0] is not None
    assert r.overage_exceeded_at[1] is None
    assert r.timeout_counts[1] == 0
    assert fast.call_count == 6


def test_policy_groups_step_concurrently():
    """Distinct group keys dispatch on the thread pool (the barrier
    deadlocks unless both groups run at once)."""
    import threading

    barrier = threading.Barrier(2, timeout=5)

    class BarrierPolicy(MultiAgentPolicy):
        def __init__(self):
            super().__init__(None)
            self.call_count = 0

        def step_batch(self, raw_observations, raw_actions) -> None:
            self.call_count += 1
            barrier.wait()
            raw_actions[:] = 0

    a, b = BarrierPolicy(), BarrierPolicy()
    r = Rollout(_overage_cfg(), [(a, [0]), (b, [1])], policy_group_keys=["g0", "g1"], max_action_time_ms=10000,
                device="cpu")
    for _ in range(3):
        r.step()
    assert a.call_count == 3 and b.call_count == 3


# --- twins of tests/simulator/test_replay.py ---


def run_replay_episode(writer):
    sim = Simulation(config(num_agents=1, map_data=("#####", "#@..#", "#####")), event_handlers=[writer],
                     device="cpu")
    while not sim.is_done:
        sim.agent(0).set_action("move_east")
        sim.step()
    return sim


def test_in_memory_replay_records_episode():
    writer = InMemoryReplayWriter()
    run_replay_episode(writer)
    replays = writer.get_completed_replays()
    assert len(replays) == 1
    data = replays[0].finalize()
    assert data["version"] == 4 and data["num_agents"] == 1
    assert "move_east" in data["action_names"]
    agents = [o for o in data["objects"] if "agent_id" in o]
    assert len(agents) == 1
    loc = agents[0]["location"]
    assert isinstance(loc, list) and len(loc) >= 2


def test_replay_file_roundtrip(tmp_path):
    writer = ReplayLogWriter(str(tmp_path))
    run_replay_episode(writer)
    paths = writer.get_written_replay_paths()
    assert len(paths) == 1
    data = json.loads(zlib.decompress(open(paths[0], "rb").read()))
    assert data["version"] == 4 and data["map_size"] == [5, 3] and len(data["objects"]) > 0


# --- twins of tests/runner/test_episode_runner.py ---


def request(jax=False):
    req_cls, spec_cls = (JEpisodeRequest, JPolicySpec) if jax else (EpisodeRequest, PolicySpec)
    return req_cls(config=rooms(jax), policy_specs=[spec_cls(class_path="random", init_kwargs={"seed": 3})], seed=0)


def test_run_episode_local():
    result = run_episode_local(request(), device="cpu")
    assert result.steps == 12 and len(result.episode_rewards) == 3 and result.error is None
    assert result.model_dump() == jax_run_episode_local(request(jax=True)).model_dump()


def test_run_episode_local_mixed_assignment():
    req = request()
    req.policy_specs.append(PolicySpec(class_path="noop"))
    req.assignments = [0, 1, 1]
    assert run_episode_local(req, device="cpu").steps == 12


def test_run_episode_isolated_subprocess():
    """One episode in a fresh process, on the CPU as asked: equal to the
    same episode run in this process."""
    result = run_episode_isolated(request(), timeout_s=300, device="cpu")
    assert result.error is None, result.error
    assert result == run_episode_local(request(), device="cpu")


# --- the port against the JAX package ---


@pytest.mark.parametrize("seed", [0, 5])
def test_rollout_equals_jax(seed):
    """One episode of three agents in rooms of their own, random actions:
    steps, episode rewards and episode stats equal to the JAX Rollout's,
    and the decoded replays equal."""
    jwriter, twriter = JInMemoryReplayWriter(), InMemoryReplayWriter()
    jres = JRollout(rooms(jax=True), JRandomMultiAgentPolicy(_Info(), seed=seed), seed=seed,
                    event_handlers=[jwriter]).run()
    tres = Rollout(rooms(), RandomMultiAgentPolicy(_Info(), seed=seed), seed=seed, event_handlers=[twriter],
                   device="cpu").run()
    assert tres.steps == jres.steps == 12
    np.testing.assert_array_equal(tres.episode_rewards, np.asarray(jres.episode_rewards))
    assert tres.episode_stats == jres.episode_stats
    assert any(v for a in tres.episode_stats["agent"] for k, v in a.items() if k.startswith("action.move"))
    jrep, trep = (json.loads(json.dumps(w.get_completed_replays()[0].finalize())) for w in (jwriter, twriter))
    builder = trep["mg_config"]["game"]["map_builder"]  # its type names the builder's package
    assert builder["type"] == "mettagrid_tpu_torch.maps.ascii.AsciiMapBuilder.Config"
    builder["type"] = "mettagrid_tpu.maps.ascii.AsciiMapBuilder.Config"
    assert trep == jrep


def test_multi_episode_equals_jax():
    policies = [(RandomMultiAgentPolicy(_Info(), seed=1), [0, 1]), (RandomMultiAgentPolicy(_Info(), seed=2), [2])]
    jpolicies = [(JRandomMultiAgentPolicy(_Info(), seed=1), [0, 1]), (JRandomMultiAgentPolicy(_Info(), seed=2), [2])]
    got = run_multi_episode(rooms(max_steps=6), policies, episodes=2, seed=3, device="cpu")
    want = jax_run_multi_episode(rooms(jax=True, max_steps=6), jpolicies, episodes=2, seed=3)
    assert got.model_dump() == want.model_dump()
    assert summarize(got, [[0, 1], [2]]).model_dump() == summarize(want, [[0, 1], [2]]).model_dump()
