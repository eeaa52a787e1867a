"""In-process episode runner (reference: mettagrid_tpu/runner/rollout.py)."""

from __future__ import annotations

from typing import Sequence

from mettagrid_tpu_torch.engine.state import resolve_device
from mettagrid_tpu_torch.policy import PolicyEnvInterface, load_policy
from mettagrid_tpu_torch.runner.types import EpisodeRequest, EpisodeResult
from mettagrid_tpu_torch.simulator.interface import SimulatorEventHandler
from mettagrid_tpu_torch.simulator.rollout import Rollout


def run_episode_local(
    request: EpisodeRequest,
    event_handlers: Sequence[SimulatorEventHandler] = (),
    device=None,
) -> EpisodeResult:
    """One episode in this process. ``device`` (None means CUDA, and raises
    without a card unless the caller passes device="cpu") runs the
    Simulation and every policy the request names that takes a device."""
    device = resolve_device(device)
    env_info = PolicyEnvInterface.from_config(request.config)
    policies = [load_policy(spec, env_info, device=device) for spec in request.policy_specs]

    num_agents = request.config.game.num_agents
    assignments = request.assignments or [0] * num_agents
    if len(assignments) != num_agents:
        raise ValueError(f"assignments length {len(assignments)} != num_agents {num_agents}")
    groups: list[tuple[object, list[int]]] = []
    for pi, policy in enumerate(policies):
        ids = [a for a, p in enumerate(assignments) if p == pi]
        if ids:
            groups.append((policy, ids))

    rollout = Rollout(
        request.config,
        groups,
        seed=request.seed,
        event_handlers=event_handlers,
        max_steps=request.max_steps,
        device=device,
    )
    result = rollout.run()
    return EpisodeResult(
        steps=result.steps,
        episode_rewards=[float(x) for x in result.episode_rewards],
        episode_stats=result.episode_stats,
    )
