"""Rollout orchestration: policies driving a Simulation
(reference: mettagrid_tpu/simulator/rollout.py). Policies run batched
through step_batch, each over its slice of the agent axis.

The Simulation runs on ``device`` (None means CUDA, and raises without a
card unless the caller passes device="cpu"). The observations go to the
policies as one host copy a step; a policy on the card copies them back
and returns with its actions on the host, so the action timeout measures
the policy's whole step."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from mettagrid_tpu_torch.config.game_config import MettaGridConfig
from mettagrid_tpu_torch.policy.policy import MultiAgentPolicy
from mettagrid_tpu_torch.simulator.interface import SimulatorEventHandler
from mettagrid_tpu_torch.simulator.simulator import Simulation


@dataclass
class RolloutResult:
    steps: int
    episode_rewards: np.ndarray
    episode_stats: dict
    replay_urls: list[str] = field(default_factory=list)


class Rollout:
    """Drives one episode: per-step policy inference + simulation stepping.

    policies: either one MultiAgentPolicy for all agents, or a list assigning
    one policy per agent slice (reference groups agents per policy).
    """

    def __init__(
        self,
        config: MettaGridConfig,
        policies: MultiAgentPolicy | Sequence[tuple[MultiAgentPolicy, list[int]]],
        seed: int = 0,
        event_handlers: Sequence[SimulatorEventHandler] = (),
        max_steps: Optional[int] = None,
        renderer=None,
        max_action_time_ms: Optional[int] = 10000,
        overage_budget_ms: Optional[int] = None,
        policy_group_keys: Optional[Sequence[object]] = None,
        device=None,
    ):
        handlers = list(event_handlers)
        self._renderer = renderer
        if renderer is not None and renderer not in handlers:
            handlers.append(renderer)
        self._sim = Simulation(config, seed=seed, event_handlers=handlers, device=device)
        if isinstance(policies, MultiAgentPolicy):
            policies = [(policies, list(range(self._sim.num_agents)))]
        self._policies = list(policies)
        self._max_steps = max_steps
        A = self._sim.num_agents
        T = self._sim.num_observation_tokens
        self._obs_buf = np.zeros((A, T, 3), dtype=np.uint8)
        self._act_buf = np.zeros(A, dtype=np.int32)
        # Per-policy action timeout + cumulative overage budget
        # (reference: simulator/rollout.py:79-86, 399-417): a step slower
        # than max_action_time_ms is replaced by noop and counted; overage
        # past the budget disables the policy for the rest of the episode.
        self._max_action_time_ms = max_action_time_ms or 10000
        self._overage_remaining_ms: Optional[list[float]] = (
            [float(overage_budget_ms)] * len(self._policies)
            if overage_budget_ms is not None
            else None
        )
        self.timeout_counts: list[int] = [0] * len(self._policies)
        self.overage_exceeded_at: list[Optional[int]] = [None] * len(self._policies)
        self._step_count = 0
        self._noop_id = self._sim.action_names.index("noop") if "noop" in self._sim.action_names else 0
        # Policies sharing a group key step together; distinct groups run
        # concurrently on a thread pool (reference: rollout.py:150-162).
        if policy_group_keys is not None and len(policy_group_keys) != len(self._policies):
            raise ValueError("policy_group_keys must have same length as policies")
        self._policy_group_keys = list(policy_group_keys) if policy_group_keys is not None else None
        self._pool = None

    @property
    def simulation(self) -> Simulation:
        return self._sim

    def step(self) -> None:
        sim = self._sim
        # Interactive renderers block here for pacing/pause/manual input
        # (reference: Rollout's user-input override ordering).
        renderer = self._renderer
        if renderer is not None:
            renderer.render()
            if getattr(renderer, "stopped", False):
                return
        self._obs_buf[...] = sim.last_outputs.observations[0].cpu().numpy()  # [A, T, 3]
        import time as _time

        def step_policy(pi):
            """Run one policy; returns (pi, actions, elapsed_ms)."""
            policy, agent_ids = self._policies[pi]
            ids = np.asarray(agent_ids)
            acts = self._act_buf[ids]
            t0 = _time.perf_counter()
            policy.step_batch(self._obs_buf[ids], acts)
            return pi, acts, (_time.perf_counter() - t0) * 1000.0

        live = [pi for pi in range(len(self._policies)) if self.overage_exceeded_at[pi] is None]
        for pi in range(len(self._policies)):
            if self.overage_exceeded_at[pi] is not None:
                self._act_buf[np.asarray(self._policies[pi][1])] = self._noop_id

        if self._policy_group_keys is None or len(live) <= 1:
            results = [step_policy(pi) for pi in live]
        else:
            # Distinct group keys dispatch concurrently; same-key policies
            # step sequentially within their group (reference: grouped
            # thread-pool stepping, rollout.py:150-182). Timeout accounting
            # and action application stay on this thread.
            from concurrent.futures import ThreadPoolExecutor

            groups: dict = {}
            for pi in live:
                groups.setdefault(self._policy_group_keys[pi], []).append(pi)
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=max(len(groups), 1))

            def run_group(pis):
                return [step_policy(pi) for pi in pis]

            results = []
            for fut in [self._pool.submit(run_group, pis) for pis in groups.values()]:
                results.extend(fut.result())

        for pi, acts, elapsed_ms in results:
            ids = np.asarray(self._policies[pi][1])
            overage = elapsed_ms - self._max_action_time_ms
            if overage > 0:
                # Timed out: this step becomes noop; overage eats the budget.
                self.timeout_counts[pi] += 1
                if self._overage_remaining_ms is not None:
                    self._overage_remaining_ms[pi] -= overage
                    if self._overage_remaining_ms[pi] <= 0:
                        self.overage_exceeded_at[pi] = self._step_count
                self._act_buf[ids] = self._noop_id
            else:
                self._act_buf[ids] = acts
        for agent_id in range(sim.num_agents):
            sim.agent(agent_id).set_action(int(self._act_buf[agent_id]))
        if renderer is not None and hasattr(renderer, "consume_user_actions"):
            # Manual actions override the policy's (applied last, wins).
            for agent_id, action in renderer.consume_user_actions().items():
                sim.agent(agent_id).set_action(action)
        sim.step()
        self._step_count += 1

    def run(self) -> RolloutResult:
        for policy, _ in self._policies:
            policy.reset()
        steps = 0
        while not self._sim.is_done:
            if self._max_steps is not None and steps >= self._max_steps:
                break
            if self._renderer is not None and getattr(self._renderer, "stopped", False):
                break
            self.step()
            steps += 1
        return RolloutResult(
            steps=steps,
            episode_rewards=self._sim.episode_rewards,
            episode_stats=self._sim.episode_stats,
        )


def single_episode_rollout(
    config: MettaGridConfig,
    policies,
    seed: int = 0,
    event_handlers: Sequence[SimulatorEventHandler] = (),
    device=None,
) -> RolloutResult:
    """Convenience wrapper (reference: runner/rollout.py:58-148)."""
    return Rollout(config, policies, seed=seed, event_handlers=event_handlers, device=device).run()
