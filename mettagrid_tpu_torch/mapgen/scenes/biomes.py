"""Biome terrain scenes (reference: mapgen/scenes/biome_{caves,plains,
forest,desert,city}.py — same terrain vocabularies, fresh implementations)."""

from __future__ import annotations

import numpy as np

from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig


def _neighbor_counts(rock: np.ndarray) -> np.ndarray:
    H, W = rock.shape
    p = np.pad(rock, 1, mode="constant", constant_values=1)
    return (
        p[0:H, 0:W] + p[0:H, 1 : W + 1] + p[0:H, 2 : W + 2]
        + p[1 : H + 1, 0:W] + p[1 : H + 1, 2 : W + 2]
        + p[2 : H + 2, 0:W] + p[2 : H + 2, 1 : W + 1] + p[2 : H + 2, 2 : W + 2]
    )


class BiomeCavesConfig(SceneConfig):
    fill_prob: float = 0.4
    steps: int = 3
    birth_limit: int = 5
    death_limit: int = 3


class BiomeCaves(Scene[BiomeCavesConfig]):
    """Cellular-automata caves: random rock, then birth/death smoothing."""

    def render(self) -> None:
        p = self.config
        rock = (self.rng.random((self.height, self.width)) < p.fill_prob).astype(np.uint8)
        for _ in range(max(p.steps, 0)):
            nb = _neighbor_counts(rock)
            rock = ((nb > p.birth_limit) | ((nb >= p.death_limit) & (rock == 1))).astype(np.uint8)
        self.grid[rock == 1] = "wall"


class BiomePlainsConfig(SceneConfig):
    cluster_period: int = 7
    cluster_max_radius: int = 2
    cluster_fill: float = 0.7
    cluster_prob: float = 0.8
    jitter: int = 2


class BiomePlains(Scene[BiomePlainsConfig]):
    """Sparse rock clusters on a jittered anchor lattice."""

    def render(self) -> None:
        p = self.config
        H, W = self.height, self.width
        period = max(p.cluster_period, 3)
        for ay in range(0, H, period):
            for ax in range(0, W, period):
                if self.rng.random() >= p.cluster_prob:
                    continue
                cy = ay + int(self.rng.integers(-p.jitter, p.jitter + 1))
                cx = ax + int(self.rng.integers(-p.jitter, p.jitter + 1))
                r = int(self.rng.integers(0, p.cluster_max_radius + 1))
                for dy in range(-r, r + 1):
                    for dx in range(-r, r + 1):
                        y, x = cy + dy, cx + dx
                        if 0 <= y < H and 0 <= x < W and dy * dy + dx * dx <= r * r:
                            if self.rng.random() < p.cluster_fill:
                                self.grid[y, x] = "wall"


class BiomeForestConfig(SceneConfig):
    density: float = 0.25
    clearing_count: int = 3
    clearing_radius: int = 3


class BiomeForest(Scene[BiomeForestConfig]):
    """Dense scattered trees (walls) with carved clearings."""

    def render(self) -> None:
        p = self.config
        H, W = self.height, self.width
        trees = self.rng.random((H, W)) < p.density
        yy, xx = np.mgrid[0:H, 0:W]
        for _ in range(p.clearing_count):
            cy = int(self.rng.integers(0, H))
            cx = int(self.rng.integers(0, W))
            trees &= (yy - cy) ** 2 + (xx - cx) ** 2 > p.clearing_radius**2
        self.grid[trees] = "wall"


class BiomeDesertConfig(SceneConfig):
    dune_period: int = 6
    dune_prob: float = 0.6


class BiomeDesert(Scene[BiomeDesertConfig]):
    """Sparse horizontal dune ridges."""

    def render(self) -> None:
        p = self.config
        H, W = self.height, self.width
        for y in range(0, H, max(p.dune_period, 2)):
            x = 0
            while x < W:
                seg = int(self.rng.integers(2, max(W // 3, 3)))
                if self.rng.random() < p.dune_prob:
                    yy = min(y + int(self.rng.integers(0, 2)), H - 1)
                    self.grid[yy, x : min(x + seg, W)] = "wall"
                x += seg + int(self.rng.integers(1, 4))


class BiomeCityConfig(SceneConfig):
    block_size: int = 5
    street_width: int = 1
    building_fill: float = 0.85


class BiomeCity(Scene[BiomeCityConfig]):
    """Rectangular building blocks separated by streets."""

    def render(self) -> None:
        p = self.config
        H, W = self.height, self.width
        pitch = p.block_size + p.street_width
        for by in range(0, H, pitch):
            for bx in range(0, W, pitch):
                if self.rng.random() >= p.building_fill:
                    continue
                h = min(p.block_size, H - by)
                w = min(p.block_size, W - bx)
                if h > 0 and w > 0:
                    self.grid[by : by + h, bx : bx + w] = "wall"
