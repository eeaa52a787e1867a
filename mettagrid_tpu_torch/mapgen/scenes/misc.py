"""Small utility scenes: spiral, radial maze, random objects, copy/transplant,
remove agents, dither (reference: mapgen/scenes/{spiral,radial_maze,
random_objects,copy_grid,remove_agents,dither}.py)."""

from __future__ import annotations

import numpy as np
from pydantic import Field

from mettagrid_tpu_torch.mapgen.distributions import FloatDistribution
from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig


class SpiralConfig(SceneConfig):
    wall_gap: int = 2
    corridor: str = "empty"
    wall_object: str = "wall"


class Spiral(Scene[SpiralConfig]):
    """Inward square spiral of walls with a configurable corridor gap."""

    def render(self) -> None:
        gap = max(self.config.wall_gap, 1) + 1
        top, left = 0, 0
        bottom, right = self.height - 1, self.width - 1
        self.grid[:] = self.config.corridor
        side = 0
        while top <= bottom and left <= right:
            if side % 4 == 0:
                self.grid[top, left : right + 1] = self.config.wall_object
                if top + 1 <= bottom:
                    self.grid[top + 1, max(left, 1) - 0] = self.config.corridor
                top += gap
            elif side % 4 == 1:
                self.grid[max(top - gap, 0) : bottom + 1, right] = self.config.wall_object
                right -= gap
            elif side % 4 == 2:
                self.grid[bottom, left : right + gap + 1] = self.config.wall_object
                bottom -= gap
            else:
                self.grid[max(top - gap, 0) : bottom + gap + 1, left] = self.config.wall_object
                left += gap
            side += 1


class RadialMazeConfig(SceneConfig):
    arms: int = 4
    arm_width: int = 1
    wall_object: str = "wall"


class RadialMaze(Scene[RadialMazeConfig]):
    """Walls everywhere except `arms` corridors radiating from the center."""

    def render(self) -> None:
        cfg = self.config
        self.grid[:] = cfg.wall_object
        cy, cx = self.height // 2, self.width // 2
        half_w = max(cfg.arm_width // 2, 0)
        radius = max(self.height, self.width)
        for k in range(cfg.arms):
            angle = 2 * np.pi * k / cfg.arms
            dy, dx = np.sin(angle), np.cos(angle)
            for t in range(radius):
                y = int(round(cy + dy * t))
                x = int(round(cx + dx * t))
                if not (0 <= y < self.height and 0 <= x < self.width):
                    break
                self.grid[
                    max(y - half_w, 0) : min(y + half_w + 1, self.height),
                    max(x - half_w, 0) : min(x + half_w + 1, self.width),
                ] = "empty"


class RandomObjectsConfig(SceneConfig):
    # Fraction (or distribution over fractions) of the area to fill per object
    # type (reference: mapgen/scenes/random_objects.py — percentage-based
    # counterpart of Random's absolute counts).
    object_ranges: dict[str, FloatDistribution] = Field(default_factory=dict)


class RandomObjects(Scene[RandomObjectsConfig]):
    """Fill a sampled fraction of the area with each object type."""

    def render(self) -> None:
        ys, xs = np.nonzero(self.grid == "empty")
        total = len(ys)
        if total == 0:
            return
        size = self.height * self.width
        order = self.rng.permutation(total)
        cursor = 0
        for name, dist in self.config.object_ranges.items():
            count = min(int(size * dist.sample(self.rng)), total - cursor)
            sel = order[cursor : cursor + count]
            self.grid[ys[sel], xs[sel]] = name
            cursor += count


class RemoveAgentsConfig(SceneConfig):
    pass


class RemoveAgents(Scene[RemoveAgentsConfig]):
    def render(self) -> None:
        mask = np.char.startswith(self.grid.astype(str), "agent")
        self.grid[mask] = "empty"


class CopyGridConfig(SceneConfig):
    # grid is injected programmatically (MapGen nesting); not serializable
    source: object = None


class CopyGrid(Scene[CopyGridConfig]):
    """Blit a prebuilt grid into the area (centered)."""

    def render(self) -> None:
        src = self.config.source
        assert src is not None, "CopyGrid requires a source grid"
        src = np.asarray(src)
        h = min(src.shape[0], self.height)
        w = min(src.shape[1], self.width)
        y0 = (self.height - h) // 2
        x0 = (self.width - w) // 2
        self.grid[y0 : y0 + h, x0 : x0 + w] = src[:h, :w]


class DitherConfig(SceneConfig):
    density: float = 0.1
    object_name: str = "wall"


class Dither(Scene[DitherConfig]):
    """Sprinkle an object over empty cells with the given density."""

    def render(self) -> None:
        mask = (self.grid == "empty") & (self.rng.random(self.grid.shape) < self.config.density)
        self.grid[mask] = self.config.object_name


class BoundedLayoutConfig(SceneConfig):
    max_width: int = Field(ge=1)
    max_height: int = Field(ge=1)
    tag: str


class BoundedLayout(Scene[BoundedLayoutConfig]):
    """Centered sub-area clamped by both the zone size and the configured
    maxima, with a minimum footprint (reference: mapgen/scenes/bounded_layout.py)."""

    def render(self) -> None:
        width = max(1, min(self.width, self.config.max_width))
        height = max(1, min(self.height, self.config.max_height))
        min_w = min(self.width, max(10, self.config.max_width // 2))
        min_h = min(self.height, max(10, self.config.max_height // 2))
        width = max(min_w, width)
        height = max(min_h, height)
        x = (self.width - width) // 2
        y = (self.height - height) // 2
        width = min(width, self.width - x)
        height = min(height, self.height - y)
        if width > 0 and height > 0:
            self.make_area(x, y, width, height, tags=[self.config.tag])


class MeanDistanceConfig(SceneConfig):
    mean_distance: float
    objects: dict[str, int]


class MeanDistance(Scene[MeanDistanceConfig]):
    """Agent at the center; objects placed at Poisson-distributed distances
    from it at uniform angles (reference: mapgen/scenes/mean_distance.py)."""

    def render(self) -> None:
        agent_pos = (self.height // 2, self.width // 2)
        self.grid[agent_pos] = "agent.agent"
        for obj_name, count in self.config.objects.items():
            placed = 0
            attempts = 0
            # Bounded attempts so tiny/full areas can't loop forever.
            max_attempts = max(100, count * 200)
            while placed < count and attempts < max_attempts:
                attempts += 1
                d = self.rng.poisson(lam=self.config.mean_distance) or 1
                angle = self.rng.uniform(0, 2 * np.pi)
                dy = int(round(d * np.sin(angle)))
                dx = int(round(d * np.cos(angle)))
                candidate = (agent_pos[0] + dy, agent_pos[1] + dx)
                if (
                    0 <= candidate[0] < self.height
                    and 0 <= candidate[1] < self.width
                    and self.grid[candidate] == "empty"
                ):
                    self.grid[candidate] = obj_name
                    placed += 1


class AsteroidMaskConfig(SceneConfig):
    step: int = 3
    depth_min: int = 2
    depth_max: int = 8
    width_min: int = 2
    width_max: int = 6
    chunk_prob: float = 0.6


class AsteroidMask(Scene[AsteroidMaskConfig]):
    """Carve triangular wall bites into the edges at regular anchor points,
    giving an asteroid-like silhouette (reference: mapgen/scenes/asteroid_mask.py)."""

    def render(self) -> None:
        cfg = self.config
        step = max(1, int(cfg.step))
        depth_min = max(0, int(cfg.depth_min))
        depth_max = max(depth_min, int(cfg.depth_max))
        width_min = max(0, int(cfg.width_min))
        width_max = max(width_min, int(cfg.width_max))
        if depth_max == 0 or width_max == 0 or cfg.chunk_prob <= 0.0:
            return

        def cut(anchor: int, depth: int, half_w: int, axis: str, reverse: bool) -> None:
            if depth <= 0 or half_w <= 0:
                return
            for offset in range(depth):
                span = int(round(half_w * (1.0 - offset / depth)))
                if span <= 0:
                    continue
                if axis == "x":
                    x0, x1 = max(0, anchor - span), min(self.width, anchor + span + 1)
                    y = self.height - 1 - offset if reverse else offset
                    self.grid[y, x0:x1] = "wall"
                else:
                    y0, y1 = max(0, anchor - span), min(self.height, anchor + span + 1)
                    x = self.width - 1 - offset if reverse else offset
                    self.grid[y0:y1, x] = "wall"

        for axis, extent in (("x", self.width), ("y", self.height)):
            for anchor in range(0, extent, step):
                for reverse in (False, True):
                    if self.rng.random() < cfg.chunk_prob:
                        cut(
                            anchor,
                            int(self.rng.integers(depth_min, depth_max + 1)),
                            int(self.rng.integers(width_min, width_max + 1)),
                            axis,
                            reverse,
                        )
