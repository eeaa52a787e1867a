"""On-device training demo (reference: demos/demo_train_jax.py): a short
A2C loop on the navigation preset, the batched env and the LSTM learner on
one device, printing the first and last loss.

    python -m mettagrid_tpu_torch.demos.demo_train

runs on the CUDA device; ``train(device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import math
import sys


def train(num_envs: int = 8, num_agents: int = 2, steps: int = 20, seed: int = 0, device=None) -> list[float]:
    from mettagrid_tpu_torch.builder import make_navigation
    from mettagrid_tpu_torch.engine import build_env_init, compile_program, make_reset, make_step
    from mettagrid_tpu_torch.engine.state import resolve_device
    from mettagrid_tpu_torch.parallel import TrainState, adam, make_train_step
    from mettagrid_tpu_torch.policy import LSTMPolicy
    from mettagrid_tpu_torch.policy.policy import generators

    dev = resolve_device(device)
    cfg = make_navigation(num_agents)
    cfg.game.max_steps = 32
    cfg.game.map_builder.width = 10
    cfg.game.map_builder.height = 10
    program = compile_program(cfg)
    gm = cfg.game.map_builder.create().build_for_num_agents(num_agents)
    init = build_env_init(program, [gm])
    reset = make_reset(program, init, num_envs, device=dev)
    step = make_step(program, init, auto_reset=True, device=dev)

    # The parameters from seed, the actions from seed + 1, as the reference
    # splits its keys.
    init_gen, action_gen = generators(seed, dev)
    policy = LSTMPolicy(num_actions=len(program.action_names), hidden_size=32, encoder_hidden=32, device=dev,
                        generator=init_gen)
    state, out = reset(seed)
    ts = TrainState(
        env_state=state,
        obs=out.observations,
        lstm_state=policy.initial_state(tuple(out.observations.shape[:-2])),
        generator=action_gen,
    )
    train_step = make_train_step(program, step, policy, adam(policy, 1e-3))

    losses = []
    for _ in range(steps):
        ts, metrics = train_step(ts)
        losses.append(float(metrics["loss"]))
    return losses


def main() -> int:
    losses = train()
    print(f"trained {len(losses)} steps; first loss {losses[0]:.4f}, last loss {losses[-1]:.4f}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError("non-finite loss")
    return 0


if __name__ == "__main__":
    sys.exit(main())
