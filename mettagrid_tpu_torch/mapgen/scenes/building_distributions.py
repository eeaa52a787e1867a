"""Extractor/building placement with configurable spatial distributions
(reference: mapgen/scenes/building_distributions.py).

`UniformExtractorScene` places stations either on a jittered uniform grid
(rows x cols) or — when `target_coverage` is set — by sampling positions from
a spatial distribution (uniform / normal / exponential / poisson-disk /
bimodal), with per-building-type distribution overrides.
"""

from __future__ import annotations

from enum import Enum

import numpy as np
from pydantic import BaseModel, Field

from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig

DEFAULT_BUILDING_WEIGHTS: dict[str, float] = {
    "carbon_extractor": 1.0,
    "oxygen_extractor": 1.0,
    "germanium_extractor": 1.0,
    "silicon_extractor": 1.0,
    "junction": 1.0,
}
DEFAULT_FALLBACK_WEIGHT = 1.0


class DistributionType(str, Enum):
    UNIFORM = "uniform"
    NORMAL = "normal"
    EXPONENTIAL = "exponential"
    POISSON = "poisson"
    BIMODAL = "bimodal"


class DistributionConfig(BaseModel):
    type: DistributionType = DistributionType.UNIFORM
    # Normal
    mean_x: float | None = None
    mean_y: float | None = None
    std_x: float = 0.2
    std_y: float = 0.2
    # Exponential
    decay_rate: float = 2.0
    origin_x: float = 0.0
    origin_y: float = 0.0
    # Bimodal
    center1_x: float = 0.25
    center1_y: float = 0.25
    center2_x: float = 0.75
    center2_y: float = 0.75
    cluster_std: float = 0.15


def sample_positions(
    count: int,
    bounds: tuple[int, int, int, int],  # row_min, row_max, col_min, col_max
    dist: DistributionConfig,
    rng: np.random.Generator,
) -> list[tuple[int, int]]:
    """Sample (row, col) positions within bounds per the distribution."""
    row_min, row_max, col_min, col_max = bounds
    avail_w = col_max - col_min + 1
    avail_h = row_max - row_min + 1
    if count <= 0 or avail_w <= 0 or avail_h <= 0:
        return []

    def clip_zip(rows: np.ndarray, cols: np.ndarray) -> list[tuple[int, int]]:
        rows = np.clip(rows, row_min, row_max).astype(int)
        cols = np.clip(cols, col_min, col_max).astype(int)
        return list(zip(rows.tolist(), cols.tolist()))

    if dist.type == DistributionType.NORMAL:
        mean_x = 0.5 if dist.mean_x is None else dist.mean_x
        mean_y = 0.5 if dist.mean_y is None else dist.mean_y
        rows = rng.normal(row_min + mean_y * avail_h, dist.std_y * avail_h, size=count)
        cols = rng.normal(col_min + mean_x * avail_w, dist.std_x * avail_w, size=count)
        return clip_zip(rows, cols)

    if dist.type == DistributionType.EXPONENTIAL:
        sx = np.clip(rng.exponential(scale=1.0 / dist.decay_rate, size=count), 0, 1)
        sy = np.clip(rng.exponential(scale=1.0 / dist.decay_rate, size=count), 0, 1)
        if dist.origin_x > 0.5:
            sx = 1.0 - sx
        if dist.origin_y > 0.5:
            sy = 1.0 - sy
        return clip_zip(row_min + sy * avail_h, col_min + sx * avail_w)

    if dist.type == DistributionType.POISSON:
        # Poisson-disk (dart throwing): approximately uniform with a minimum
        # separation, relaxed by one cell at a time until count is reached.
        area = max(1, avail_w * avail_h)
        min_dist = max(1, int(np.sqrt(area / max(1, count)) * 0.6))
        positions: list[tuple[int, int]] = []
        while len(positions) < count and min_dist >= 1:
            min_dist_sq = min_dist * min_dist
            tries = 0
            max_tries = (count - len(positions)) * 200
            while len(positions) < count and tries < max_tries:
                tries += 1
                cand = (
                    int(rng.integers(row_min, row_max + 1)),
                    int(rng.integers(col_min, col_max + 1)),
                )
                if all(
                    (cand[0] - p[0]) ** 2 + (cand[1] - p[1]) ** 2 >= min_dist_sq
                    for p in positions
                ):
                    positions.append(cand)
            min_dist -= 1
        return positions

    if dist.type == DistributionType.BIMODAL:
        half = count // 2
        std_r = dist.cluster_std * avail_h
        std_c = dist.cluster_std * avail_w
        rows = np.concatenate(
            [
                rng.normal(row_min + dist.center1_y * avail_h, std_r, size=half),
                rng.normal(row_min + dist.center2_y * avail_h, std_r, size=count - half),
            ]
        )
        cols = np.concatenate(
            [
                rng.normal(col_min + dist.center1_x * avail_w, std_c, size=half),
                rng.normal(col_min + dist.center2_x * avail_w, std_c, size=count - half),
            ]
        )
        return clip_zip(rows, cols)

    # UNIFORM (and fallback)
    rows = rng.integers(row_min, row_max + 1, size=count)
    cols = rng.integers(col_min, col_max + 1, size=count)
    return clip_zip(rows, cols)


def linspace_positions(count: int, interior_size: int) -> list[int]:
    """Approximately uniform interior positions (1-based) for `count` items."""
    if count <= 0:
        return []
    if interior_size <= 0:
        raise ValueError("interior_size must be positive")
    if count >= interior_size:
        return list(range(1, interior_size + 1))
    step = (interior_size + 1) / (count + 1)
    return [1 + max(0, min(interior_size - 1, round(step * (i + 1)))) for i in range(count)]


class UniformExtractorParams(SceneConfig):
    rows: int = 4
    cols: int = 4
    jitter: int = 1
    padding: int = 1
    clear_existing: bool = False
    frame_with_walls: bool = False
    target_coverage: float | None = None
    building_names: list[str] = Field(
        default_factory=lambda: list(DEFAULT_BUILDING_WEIGHTS.keys())
    )
    building_weights: dict[str, float] | None = None
    distribution: DistributionConfig = Field(default_factory=DistributionConfig)
    building_distributions: dict[str, DistributionConfig] | None = None


class UniformExtractorScene(Scene[UniformExtractorParams]):
    """Place extractor stations on a jittered uniform grid or by spatial
    distribution sampling (target_coverage mode)."""

    def render(self) -> None:
        params = self.config
        if self.width < 3 or self.height < 3:
            raise ValueError("Extractor map must be at least 3x3 to fit border walls")

        padding = max(0, params.padding)
        bounds = (padding, self.height - padding - 1, padding, self.width - padding - 1)
        if bounds[0] > bounds[1] or bounds[2] > bounds[3]:
            return

        if params.clear_existing:
            self.grid[:, :] = "empty"
            if params.frame_with_walls:
                self.grid[0, :] = "wall"
                self.grid[-1, :] = "wall"
                self.grid[:, 0] = "wall"
                self.grid[:, -1] = "wall"

        names, probabilities = self._resolve_building_distribution()
        self._padding = padding
        self._placed_centers: list[tuple[int, int]] = []

        if params.target_coverage is not None:
            self._render_target_coverage(bounds, names, probabilities)
        else:
            self._render_grid(bounds, names, probabilities)

    # -- placement primitives ------------------------------------------------

    def _carve_and_place(self, row: int, col: int, name: str) -> None:
        """Write the station at (row, col) and clear its padding halo."""
        p = self._padding
        r0, r1 = max(0, row - p), min(self.height, row + p + 1)
        c0, c1 = max(0, col - p), min(self.width, col + p + 1)
        self.grid[r0:r1, c0:c1] = "empty"
        self.grid[row, col] = name
        self._placed_centers.append((row, col))

    def _can_place(self, row: int, col: int) -> bool:
        p = self._padding
        return not any(
            abs(row - r0) <= p and abs(col - c0) <= p for r0, c0 in self._placed_centers
        )

    def _sample_assignments(self, count: int, names: list[str], probs: np.ndarray) -> list[str]:
        if count <= 0:
            return []
        return list(self.rng.choice(names, size=count, replace=True, p=probs))

    # -- modes ---------------------------------------------------------------

    def _render_target_coverage(self, bounds, names, probabilities) -> None:
        params = self.config
        row_min, row_max, col_min, col_max = bounds
        avail_h = row_max - row_min + 1
        avail_w = col_max - col_min + 1
        spacing = self._padding + 1
        max_possible = ((avail_h + spacing - 1) // spacing) * ((avail_w + spacing - 1) // spacing)
        if max_possible == 0:
            return
        interior = (self.width - 2) * (self.height - 2)
        desired = int(params.target_coverage * interior)
        goal = 0 if desired == 0 else min(max_possible, max(1, desired))
        if goal == 0:
            return

        if params.building_distributions:
            # Partition buildings by their (possibly overridden) distribution
            # and sample each group separately.
            groups: dict[str, list[int]] = {}
            for i, name in enumerate(names):
                dist = params.building_distributions.get(name, params.distribution)
                groups.setdefault(repr(dist.model_dump()), []).append(i)
            total_weight = float(np.sum(probabilities))
            for indices in groups.values():
                group_names = [names[i] for i in indices]
                dist = params.building_distributions.get(group_names[0], params.distribution)
                group_probs = np.asarray([probabilities[i] for i in indices])
                group_count = max(1, int((group_probs.sum() / total_weight) * goal))
                group_probs = group_probs / group_probs.sum()
                positions = sample_positions(group_count, bounds, dist, self.rng)
                assignments = self._sample_assignments(len(positions), group_names, group_probs)
                for (row, col), name in zip(positions, assignments):
                    if self._can_place(row, col):
                        self._carve_and_place(row, col, name)
        else:
            positions = sample_positions(goal, bounds, params.distribution, self.rng)
            assignments = self._sample_assignments(len(positions), names, probabilities)
            for (row, col), name in zip(positions, assignments):
                if self._can_place(row, col):
                    self._carve_and_place(row, col, name)

    def _render_grid(self, bounds, names, probabilities) -> None:
        params = self.config
        row_min, row_max, col_min, col_max = bounds
        row_positions = linspace_positions(params.rows, self.height - 2)
        col_positions = linspace_positions(params.cols, self.width - 2)
        if not row_positions or not col_positions:
            raise ValueError("rows and cols must be positive for extractor placement")

        positions = list(dict.fromkeys((r, c) for r in row_positions for c in col_positions))
        assignments = self._sample_assignments(len(positions), names, probabilities)
        jitter = max(0, params.jitter)

        for (base_row, base_col), name in zip(positions, assignments):
            row = int(np.clip(base_row, row_min, row_max))
            col = int(np.clip(base_col, col_min, col_max))
            for _ in range(8 if jitter else 1):
                jr = int(np.clip(row + (self.rng.integers(-jitter, jitter + 1) if jitter else 0), row_min, row_max))
                jc = int(np.clip(col + (self.rng.integers(-jitter, jitter + 1) if jitter else 0), col_min, col_max))
                if self._can_place(jr, jc):
                    self._carve_and_place(jr, jc, name)
                    break

    def _resolve_building_distribution(self) -> tuple[list[str], np.ndarray]:
        weights = self.config.building_weights
        if weights:
            filtered = [(n, float(w)) for n, w in weights.items() if float(w) > 0]
            if not filtered:
                raise ValueError("building_weights must contain positive values")
            names = [n for n, _ in filtered]
            weight_array = np.asarray([w for _, w in filtered], dtype=float)
        else:
            names = list(self.config.building_names) or ["carbon_extractor"]
            weight_array = np.asarray(
                [DEFAULT_BUILDING_WEIGHTS.get(n, DEFAULT_FALLBACK_WEIGHT) for n in names],
                dtype=float,
            )
        total = float(weight_array.sum())
        if total <= 0:
            raise ValueError("Sum of extractor weights must be positive")
        return names, weight_array / total
