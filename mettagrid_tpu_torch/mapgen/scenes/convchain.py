"""ConvChain texture synthesis (reference: mapgen/scenes/convchain.py — both
trace back to Gumin's published MCMC algorithm; this is an independent
implementation from the algorithm description)."""

from __future__ import annotations

import numpy as np
from pydantic import Field

from mettagrid_tpu_torch.mapgen.pattern import Symmetry, extract_pattern_weights, parse_ascii_sample
from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig


class ConvChainConfig(SceneConfig):
    pattern: str = Field(description="ASCII sample ('#' = wall)")
    pattern_size: int = 3
    iterations: int = 2
    temperature: float = 1.0
    periodic_input: bool = True
    symmetry: Symmetry = "all"
    on_value: str = "wall"
    off_value: str = "empty"


class ConvChain(Scene[ConvChainConfig]):
    """Metropolis sampling over n x n pattern energies: start from random
    noise, flip cells, accept by the product of changed pattern weights."""

    def render(self) -> None:
        cfg = self.config
        n = cfg.pattern_size
        sample = parse_ascii_sample(cfg.pattern)
        weights = extract_pattern_weights(sample, n, cfg.symmetry, cfg.periodic_input)
        weights = np.where(weights > 0, weights, 0.1)

        H, W = self.height, self.width
        field = self.rng.random((H, W)) < 0.5

        def window_index(y: int, x: int) -> int:
            idx = 0
            for dy in range(n):
                for dx in range(n):
                    idx = (idx << 1) | int(field[(y + dy) % H, (x + dx) % W])
            return idx

        def point_energy(y: int, x: int) -> float:
            value = 1.0
            for dy in range(-n + 1, 1):
                for dx in range(-n + 1, 1):
                    value *= weights[window_index((y + dy) % H, (x + dx) % W)]
            return value

        total_flips = cfg.iterations * H * W
        for _ in range(total_flips):
            y = int(self.rng.integers(H))
            x = int(self.rng.integers(W))
            before = point_energy(y, x)
            field[y, x] = ~field[y, x]
            after = point_energy(y, x)
            ratio = after / before if before > 0 else 1.0
            if ratio < 1.0:
                p = ratio ** (1.0 / cfg.temperature) if cfg.temperature > 0 else 0.0
                if self.rng.random() >= p:
                    field[y, x] = ~field[y, x]  # reject

        self.grid[field] = cfg.on_value
        self.grid[~field] = cfg.off_value
