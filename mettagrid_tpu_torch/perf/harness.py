"""Reusable benchmark loop (reference: mettagrid_tpu/perf/harness.py).

Pre-generated random actions on the step's device, warmup + measured
rounds, SPS statistics with a CV stability gate, JSON save/compare with the
same result schema."""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclass
class PerfResult:
    label: str
    num_envs: int
    num_agents: int
    iters_per_round: int
    rounds: int
    env_steps_per_s: float
    agent_steps_per_s: float
    round_sps: list[float] = field(default_factory=list)
    cv: float = 0.0
    extra: dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "PerfResult":
        with open(path) as f:
            return PerfResult(**json.load(f))

    def compare(self, baseline: "PerfResult") -> dict[str, float]:
        return {
            "env_sps_ratio": self.env_steps_per_s / max(baseline.env_steps_per_s, 1e-9),
            "agent_sps_ratio": self.agent_steps_per_s / max(baseline.agent_steps_per_s, 1e-9),
        }


def run_performance(
    step_fn: Callable,
    reset_fn: Callable,
    *,
    num_envs: int,
    num_agents: int,
    n_actions: int,
    label: str = "bench",
    iters_per_round: int = 100,
    rounds: int = 5,
    warmup_iters: int = 20,
    seed: int = 0,
    max_cv: Optional[float] = 0.2,
    phase_timing: Optional[tuple] = None,
) -> PerfResult:
    """Benchmark a step. step_fn(state, actions, vibes) -> (state, out);
    reset_fn(seed) -> (state, out). The actions live on the device of the
    reset's rewards, and each round ends in a read of the rewards' sum, which
    waits for the device.

    Raises RuntimeError when the coefficient of variation across rounds
    exceeds max_cv (the reference's stability gate: exit 1 if CV > 20%).

    phase_timing: optional (program, init) — when given, per-phase step
    timing (profiling.measure_step_phases) is recorded under
    result.extra["phase_timing_s"].
    """
    rng = np.random.default_rng(seed)
    state, out = reset_fn(seed)
    device = out.rewards.device
    vibes = torch.zeros((num_envs, num_agents), dtype=torch.int32, device=device)

    # A bank of action tensors drawn up front, so no round pays for a draw.
    bank = [
        torch.as_tensor(rng.integers(0, n_actions, size=(num_envs, num_agents)), dtype=torch.int32, device=device)
        for _ in range(16)
    ]

    for i in range(warmup_iters):
        state, out = step_fn(state, bank[i % len(bank)], vibes)
    float(out.rewards.sum())  # the completion barrier

    round_sps: list[float] = []
    for r in range(rounds):
        t0 = time.perf_counter()
        for i in range(iters_per_round):
            state, out = step_fn(state, bank[i % len(bank)], vibes)
        float(out.rewards.sum())
        dt = time.perf_counter() - t0
        round_sps.append(num_envs * iters_per_round / dt)

    mean = float(np.mean(round_sps))
    cv = float(np.std(round_sps) / mean) if mean > 0 else 0.0
    result = PerfResult(
        label=label,
        num_envs=num_envs,
        num_agents=num_agents,
        iters_per_round=iters_per_round,
        rounds=rounds,
        env_steps_per_s=mean,
        agent_steps_per_s=mean * num_agents,
        round_sps=round_sps,
        cv=cv,
    )
    if max_cv is not None and cv > max_cv:
        raise RuntimeError(f"unstable benchmark: CV={cv:.1%} > {max_cv:.0%}\n{result.to_json()}")
    if phase_timing is not None:
        from mettagrid_tpu_torch.profiling.phase_timing import measure_step_phases

        program, init = phase_timing
        result.extra["phase_timing_s"] = measure_step_phases(program, init, state, bank[0], vibes, k=4)
    return result
