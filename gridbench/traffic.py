"""The one traffic generator: reads a mix's parameters (``traffic/<name>.json``)
and draws each step's inputs on the device from the run's seed.

A mix is closed-loop: the harness starts the next step once the previous
one's outputs are on the device. Its file gives:

* ``max_steps``: the episode length (null: the configuration's);
* ``warmup_steps``, ``trace_steps``: steps stepped in set-up, and under the
  profiler after the window of a ``--trace 1`` run;
* ``action_weights``: a weight for each action the agents take, by the
  configuration's action names (null: every action alike; a name left out
  is never taken);
* ``vibe_action_weights``: the same for the step's second action channel
  (null: its first action, noop, for every agent);
* ``about``: one line on what the mix stands for.

Each step draws, in this order and from one ``torch.Generator`` seeded with
the seed: the actions, the vibe actions (where weighted), the agent order
(an argsort of uniform draws, the same work as the engine's own draw) and
the map each env would take if it reset on this step. So two generators of
one seed give the same inputs, step for step, and the plain reference can
be handed exactly what the program was.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
KEYS = {"about", "max_steps", "warmup_steps", "trace_steps", "action_weights", "vibe_action_weights"}


def load(name: str) -> dict:
    """The mix ``traffic/<name>.json``, checked for its keys."""
    params = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    if set(params) != KEYS:
        raise ValueError(f"traffic {name}: keys {sorted(params)}, expected {sorted(KEYS)}")
    return params


def cumulative(weights, action_names: list, device) -> torch.Tensor:
    """The cumulative distribution over the action indices, float64[n]; its
    last entry is 1."""
    if weights is None:
        weights = {name: 1.0 for name in action_names}
    unknown = set(weights) - set(action_names)
    if unknown or any(w < 0 for w in weights.values()) or not sum(weights.values()) > 0:
        raise ValueError(f"action weights {weights} over the actions {action_names}")
    w = torch.tensor([float(weights.get(name, 0.0)) for name in action_names], dtype=torch.float64)
    cdf = w.cumsum(0) / w.sum()
    cdf[-1] = 1.0
    return cdf.to(device)


class Traffic:
    """Each step's (actions, vibe_actions, perm, reset_maps) for ``envs`` envs
    of ``agents`` agents, the configuration's ``action_names`` and a pool of
    ``pool`` maps."""

    def __init__(self, params: dict, seed: int, envs: int, agents: int, action_names: list, pool: int, device):
        self.shape = (envs, agents)
        self.pool, self.device = pool, torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.actions = cumulative(params["action_weights"], action_names, self.device)
        vibes = params["vibe_action_weights"]
        self.vibes = None if vibes is None else cumulative(vibes, action_names, self.device)
        self.noop = torch.zeros(self.shape, dtype=torch.int32, device=self.device)

    def _pick(self, cdf: torch.Tensor) -> torch.Tensor:
        u = torch.rand(self.shape, generator=self.generator, device=self.device, dtype=torch.float64)
        return torch.searchsorted(cdf, u, right=True).to(torch.int32)

    def draw(self):
        g, dev = self.generator, self.device
        actions = self._pick(self.actions)
        vibes = self.noop if self.vibes is None else self._pick(self.vibes)
        perm = torch.rand(self.shape, generator=g, device=dev).argsort(dim=1, stable=True).to(torch.int32)
        reset_maps = torch.randint(0, self.pool, self.shape[:1], generator=g, device=dev, dtype=torch.int32)
        return actions, vibes, perm, reset_maps

    def replay(self, n: int, rows: torch.Tensor) -> dict:
        """The first n steps' draws of the envs ``rows``, as numpy arrays:
        actions, vibe_actions and perm [n, S, A], reset_maps [n, S]."""
        names = ("actions", "vibe_actions", "perm", "reset_maps")
        steps = {k: [] for k in names}
        for _ in range(n):
            for k, t in zip(names, self.draw()):
                steps[k].append(t[rows])
        return {k: torch.stack(v).cpu().numpy() for k, v in steps.items()}
