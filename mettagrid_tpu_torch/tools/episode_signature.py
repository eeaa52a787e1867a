"""Deterministic episode signature.

    python -m mettagrid_tpu_torch.tools.episode_signature [--seed=0] [--steps=64] [--device=cpu]
    python -m mettagrid_tpu_torch.tools.episode_signature --cross-engine [--seeds=0,3,11] [--steps=500] [--device=cpu]

Runs a fixed-seed episode of the arena with 4 agents on a 12x12 random map
(border 1, 6 walls), with random actions from np.random.default_rng(seed),
and prints the SHA-256 of its end state (parity/signature.py). Run in N
fresh processes, it must print one hash: the determinism gate (reference
tests/simulator/test_deterministic_signature.py). It is the twin of the
default mode of the JAX package's scripts/deterministic_episode_signature.py,
but not of its hash: this engine draws the agent orders from a
torch.Generator seeded with the seed, where the JAX engine draws them from
its threefry key. The device is CUDA unless --device names another.

--cross-engine runs the make_arena(24) preset in this engine and in the
reference C++ engine (the oracle that scripts/build_reference_oracle.sh
builds) for --steps steps (500 unless given) under reproduced MT19937 agent
shuffling, one episode per map seed of --seeds with action seed
7 * seed + 42 (parity/arena.run_arena_parity), and prints a JSON verdict:
the twin of the JAX script's cross-engine mode. It exits 0 on a match, 1 on
a mismatch, and 2 with {"error": ...} when the oracle is not built.
"""

from __future__ import annotations

import json
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


def cross_engine(seeds, steps: int, device=None) -> int:
    """Arena-scale signature parity against the reference C++ engine; prints
    the JSON verdict and returns the exit code."""
    from mettagrid_tpu_torch.parity.arena import run_arena_parity
    from mettagrid_tpu_torch.parity.reference_oracle import HOW_TO_BUILD, reference_available

    dev = resolve_device(device)
    if not reference_available():
        print(json.dumps({"error": f"reference oracle not built ({HOW_TO_BUILD})"}))
        return 2
    results = {seed: run_arena_parity(seed, seed * 7 + 42, steps=steps, device=dev) for seed in seeds}
    ok = all(not p for p in results.values())
    print(
        json.dumps(
            {
                "match": ok,
                "preset": "make_arena(24)",
                "steps": steps,
                "seeds": list(seeds),
                "problems": {s: p[:5] for s, p in results.items() if p},
            }
        )
    )
    return 0 if ok else 1


def main(argv=None) -> None:
    seed, steps, device = 0, None, None
    seeds = [0, 3, 11]
    xengine = False
    for arg in sys.argv[1:] if argv is None else argv:
        k, _, v = arg.partition("=")
        if k == "--seed":
            seed = int(v)
        elif k == "--steps":
            steps = int(v)
        elif k == "--seeds":
            seeds = [int(x) for x in v.split(",")]
        elif k == "--cross-engine":
            xengine = True
        elif k == "--device":
            device = v
        else:
            raise SystemExit(f"unknown argument {arg!r}")
    if xengine:
        sys.exit(cross_engine(seeds, 500 if steps is None else steps, device))
    print(signature(seed, 64 if steps is None else steps, device))


if __name__ == "__main__":
    main()
