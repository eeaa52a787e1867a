"""Random object/agent placement into empty cells
(reference: mapgen/scenes/random.py)."""

from __future__ import annotations

import numpy as np
from pydantic import Field

from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig


class RandomConfig(SceneConfig):
    objects: dict[str, int] = Field(default_factory=dict)
    agents: int | dict[str, int] = 0


class Random(Scene[RandomConfig]):
    """Scatter the configured objects and agents uniformly over empty cells."""

    def render(self) -> None:
        if isinstance(self.config.agents, int):
            agents = ["agent.agent"] * self.config.agents
        else:
            agents = [f"agent.{name}" for name, n in self.config.agents.items() for _ in range(n)]

        symbols: list[str] = []
        for name, count in self.config.objects.items():
            symbols.extend([name] * count)
        symbols.extend(agents)
        if not symbols:
            return

        # NOTE: self.grid is a (possibly non-contiguous) view — ravel() would
        # copy, so write through 2-D index pairs.
        ys, xs = np.nonzero(self.grid == "empty")
        take = min(len(symbols), len(ys))
        chosen = self.rng.choice(len(ys), size=take, replace=False)
        sym = np.array(symbols, dtype=self.grid.dtype)
        self.rng.shuffle(sym)
        self.grid[ys[chosen], xs[chosen]] = sym[:take]
