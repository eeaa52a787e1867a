"""PettingZoo compatibility demo (reference: demos/demo_train_pettingzoo.py):
drives the ParallelEnv API for a few episodes with random actions.

    python -m mettagrid_tpu_torch.demos.demo_pettingzoo

runs on the CUDA device; ``run(device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import sys


def run(episodes: int = 2, seed: int = 0, device=None) -> list[float]:
    import numpy as np

    from mettagrid_tpu_torch.builder import make_navigation
    from mettagrid_tpu_torch.envs import MettaGridPettingZooEnv

    cfg = make_navigation(2)
    cfg.game.max_steps = 16
    cfg.game.map_builder.width = 8
    cfg.game.map_builder.height = 8
    env = MettaGridPettingZooEnv(cfg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    totals = []
    for ep in range(episodes):
        observations, infos = env.reset(seed=seed + ep)
        total = 0.0
        while env.agents:
            actions = {a: int(rng.integers(0, 5)) for a in env.agents}
            observations, rewards, terms, truncs, infos = env.step(actions)
            total += sum(rewards.values())
        totals.append(total)
    env.close()
    return totals


def main() -> int:
    totals = run()
    print(f"ran {len(totals)} episodes, totals={totals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
