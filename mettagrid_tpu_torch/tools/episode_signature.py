"""Deterministic episode signature.

    python -m mettagrid_tpu_torch.tools.episode_signature [--seed=0] [--steps=64] [--device=cpu]

Runs a fixed-seed episode of the arena with 4 agents on a 12x12 random map
(border 1, 6 walls), with random actions from np.random.default_rng(seed),
and prints the SHA-256 of its end state (parity/signature.py). Run in N
fresh processes, it must print one hash: the determinism gate (reference
tests/simulator/test_deterministic_signature.py). It is the twin of the
default mode of the JAX package's scripts/deterministic_episode_signature.py,
but not of its hash: this engine draws the agent orders from a
torch.Generator seeded with the seed, where the JAX engine draws them from
its threefry key. Its cross-engine mode, which needs the C++ reference
engine, has no twin here. The device is CUDA unless --device names another.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mettagrid_tpu_torch.builder import make_arena
from mettagrid_tpu_torch.engine import build_env_init, compile_program, make_reset, make_step
from mettagrid_tpu_torch.engine.state import resolve_device
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from mettagrid_tpu_torch.parity import episode_signature


def signature(seed: int = 0, steps: int = 64, device=None) -> str:
    dev = resolve_device(device)
    cfg = make_arena(
        4,
        combat=False,
        map_builder=RandomMapBuilder.Config(
            agents=4, width=12, height=12, border_width=1, objects={"wall": 6}, seed=seed
        ),
    )
    program = compile_program(cfg)
    gm = cfg.game.map_builder.create().build_for_num_agents(4)
    init = build_env_init(program, [gm])
    reset = make_reset(program, init, 1, device=dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    step = make_step(program, init, auto_reset=False, device=dev, generator=generator)

    state, _ = reset(seed)
    rng = np.random.default_rng(seed)
    n_actions = len(program.action_names)
    vibes = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    for _ in range(steps):
        acts = torch.from_numpy(rng.integers(0, n_actions, size=(1, 4)).astype(np.int32)).to(dev)
        state, _ = step(state, acts, vibes)
    return episode_signature(program, state)


def main(argv=None) -> None:
    seed, steps, device = 0, 64, None
    for arg in sys.argv[1:] if argv is None else argv:
        k, _, v = arg.partition("=")
        if k == "--seed":
            seed = int(v)
        elif k == "--steps":
            steps = int(v)
        elif k == "--device":
            device = v
        else:
            raise SystemExit(f"unknown argument {arg!r}")
    print(signature(seed, steps, device))


if __name__ == "__main__":
    main()
