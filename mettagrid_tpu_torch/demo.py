"""Demo CLI (reference: mettagrid_tpu/demo.py, `mettagrid-demo`).

Runs a short random-policy episode on the arena preset, optionally rendering
each frame with the miniscope renderer. The episode runs on the CUDA device
(and raises without one) unless ``--device=cpu`` is given.

Usage: python -m mettagrid_tpu_torch.demo [--agents=4] [--steps=50] [--render] [--device=cpu]
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    num_agents, steps, render, device = 4, 50, False, None
    for arg in argv:
        k, _, v = arg.partition("=")
        if k == "--agents":
            num_agents = int(v)
        elif k == "--steps":
            steps = int(v)
        elif k == "--render":
            render = True
        elif k == "--device":
            device = v

    from mettagrid_tpu_torch.builder import make_arena
    from mettagrid_tpu_torch.policy.policy import RandomMultiAgentPolicy
    from mettagrid_tpu_torch.renderer import MiniscopeRenderer
    from mettagrid_tpu_torch.simulator.rollout import Rollout

    cfg = make_arena(num_agents, combat=False)
    cfg.game.max_steps = steps

    class _Info:
        action_names = [a.name for a in cfg.game.actions.actions()]

    handlers = [MiniscopeRenderer(fps=10)] if render else []
    rollout = Rollout(cfg, RandomMultiAgentPolicy(_Info()), event_handlers=handlers, device=device)
    result = rollout.run()
    print(f"episode finished: steps={result.steps} rewards={result.episode_rewards}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
