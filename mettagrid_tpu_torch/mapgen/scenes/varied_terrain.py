"""Varied terrain: styled mix of obstacles, labyrinths, crosses, scattered
walls, and blocks (reference: mapgen/scenes/varied_terrain.py).

Build order: mini labyrinths → obstacles (large, small, crosses) → scattered
walls → blocks → agents → objects. Feature counts come from a named style,
scaled by area relative to a 60x60 grid and capped so no feature type exceeds
~30% of the room.
"""

from __future__ import annotations

import numpy as np

from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig

# Per-style base counts for a 60x60 (3600-cell) room.
STYLE_PARAMETERS: dict[str, dict] = {
    "all-sparse": {
        "large_obstacles": ([10, 25], [0, 2]),
        "small_obstacles": ([3, 6], [0, 2]),
        "crosses": [0, 2],
        "labyrinths": [0, 2],
        "scattered_walls": [0, 2],
        "blocks": [0, 2],
    },
    "balanced": {
        "large_obstacles": ([10, 25], [3, 7]),
        "small_obstacles": ([3, 6], [3, 7]),
        "crosses": [3, 7],
        "labyrinths": [3, 7],
        "scattered_walls": [3, 7],
        "blocks": [3, 7],
    },
    "dense": {
        "large_obstacles": ([10, 25], [8, 15]),
        "small_obstacles": ([3, 6], [8, 15]),
        "crosses": [7, 15],
        "labyrinths": [6, 15],
        "scattered_walls": [40, 60],
        "blocks": [5, 15],
    },
    "maze": {
        "large_obstacles": ([10, 25], [0, 2]),
        "small_obstacles": ([3, 6], [0, 2]),
        "crosses": [0, 2],
        "labyrinths": [10, 20],
        "scattered_walls": [0, 2],
        "blocks": [0, 2],
    },
}

# Approximate average footprint (cells) per feature, for the 30% area cap.
_AVG_SIZES = {
    "large_obstacles": 17.5,
    "small_obstacles": 4.5,
    "crosses": 9.0,
    "labyrinths": 72.0,
    "scattered_walls": 1.0,
    "blocks": 64.0,
}
_ALLOWED_FRACTION = 0.3


class VariedTerrainConfig(SceneConfig):
    objects: dict[str, int]
    agents: int = 1
    style: str = "balanced"


class VariedTerrain(Scene[VariedTerrainConfig]):
    def post_init(self) -> None:
        style = self.config.style
        if style not in STYLE_PARAMETERS:
            raise ValueError(f"Unknown style: {style!r}. Available: {list(STYLE_PARAMETERS)}")
        params = STYLE_PARAMETERS[style]
        area = self.width * self.height
        scale = area / 3600.0

        def count_for(feature: str, base_range) -> int:
            base = int(self.rng.integers(base_range[0], base_range[1]))
            scaled = int(base * scale)
            if scaled <= 0:
                return 0
            cap = int(_ALLOWED_FRACTION * area / _AVG_SIZES[feature])
            return min(scaled, cap)

        self._large_size_range, large_base = params["large_obstacles"]
        self._small_size_range, small_base = params["small_obstacles"]
        self._counts = {
            "large_obstacles": count_for("large_obstacles", large_base),
            "small_obstacles": count_for("small_obstacles", small_base),
            "crosses": count_for("crosses", params["crosses"]),
            "labyrinths": count_for("labyrinths", params["labyrinths"]),
            "scattered_walls": count_for("scattered_walls", params["scattered_walls"]),
            "blocks": count_for("blocks", params["blocks"]),
        }

    def render(self) -> None:
        self._occupancy = np.zeros((self.height, self.width), dtype=bool)

        for _ in range(self._counts["labyrinths"]):
            self._place_pattern(self._labyrinth_pattern(), clearance=0)

        lo, hi = self._large_size_range
        for _ in range(self._counts["large_obstacles"]):
            self._place_pattern(self._random_shape(int(self.rng.integers(lo, hi + 1))), clearance=1)
        lo, hi = self._small_size_range
        for _ in range(self._counts["small_obstacles"]):
            self._place_pattern(self._random_shape(int(self.rng.integers(lo, hi + 1))), clearance=1)
        for _ in range(self._counts["crosses"]):
            self._place_pattern(self._cross_pattern(), clearance=0)

        self._place_scattered_walls(self._counts["scattered_walls"])

        for _ in range(self._counts["blocks"]):
            bh = int(self.rng.integers(2, 15))
            bw = int(self.rng.integers(2, 15))
            self._place_pattern(np.full((bh, bw), "wall", dtype=object), clearance=0)

        for _ in range(self.config.agents):
            if not self._place_single("agent.agent"):
                break
        for obj_name, obj_count in self.config.objects.items():
            missing = obj_count - int((self.grid == obj_name).sum())
            for _ in range(max(0, missing)):
                if not self._place_single(obj_name):
                    break

    # -- placement helpers ---------------------------------------------------

    def _place_single(self, name: str) -> bool:
        empty_flat = np.flatnonzero(~self._occupancy)
        if empty_flat.size == 0:
            return False
        idx = int(self.rng.integers(0, empty_flat.size))
        r, c = np.unravel_index(empty_flat[idx], self._occupancy.shape)
        self.grid[r, c] = name
        self._occupancy[r, c] = True
        return True

    def _empty_window_candidates(self, shape: tuple[int, int]) -> np.ndarray:
        """Top-left corners of fully-empty windows via a sliding-window sum."""
        rh, rw = shape
        H, W = self._occupancy.shape
        if H < rh or W < rw:
            return np.empty((0, 2), dtype=np.int64)
        # 2-D prefix-sum window count; candidate windows have zero occupancy.
        ps = np.zeros((H + 1, W + 1), dtype=np.int32)
        np.cumsum(np.cumsum(self._occupancy, axis=0), axis=1, out=ps[1:, 1:])
        sums = ps[rh:, rw:] - ps[:-rh, rw:] - ps[rh:, :-rw] + ps[:-rh, :-rw]
        return np.argwhere(sums == 0)

    def _place_pattern(self, pattern: np.ndarray, clearance: int) -> bool:
        ph, pw = pattern.shape
        candidates = self._empty_window_candidates((ph + 2 * clearance, pw + 2 * clearance))
        if len(candidates) == 0:
            return False
        r, c = candidates[int(self.rng.integers(0, len(candidates)))]
        r, c = int(r) + clearance, int(c) + clearance
        self.grid[r : r + ph, c : c + pw] = pattern
        self._occupancy[r : r + ph, c : c + pw] |= pattern != "empty"
        return True

    def _place_scattered_walls(self, count: int) -> None:
        empty_flat = np.flatnonzero(~self._occupancy)
        n = min(count, empty_flat.size)
        if n == 0:
            return
        chosen = self.rng.choice(empty_flat, size=n, replace=False)
        rs, cs = np.unravel_index(chosen, self.grid.shape)
        self.grid[rs, cs] = "wall"
        self._occupancy[rs, cs] = True

    # -- pattern generators --------------------------------------------------

    def _random_shape(self, num_blocks: int) -> np.ndarray:
        """Connected random polyomino of `num_blocks` wall cells."""
        cells = {(0, 0)}
        while len(cells) < num_blocks:
            frontier = [
                (r + dr, c + dc)
                for r, c in cells
                for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1))
                if (r + dr, c + dc) not in cells
            ]
            if not frontier:
                break
            cells.add(frontier[int(self.rng.integers(0, len(frontier)))])
        rs = [r for r, _ in cells]
        cs = [c for _, c in cells]
        pattern = np.full((max(rs) - min(rs) + 1, max(cs) - min(cs) + 1), "empty", dtype=object)
        for r, c in cells:
            pattern[r - min(rs), c - min(cs)] = "wall"
        return pattern

    def _cross_pattern(self) -> np.ndarray:
        ch = int(self.rng.integers(1, 9))
        cw = int(self.rng.integers(1, 9))
        pattern = np.full((ch, cw), "empty", dtype=object)
        pattern[ch // 2, :] = "wall"
        pattern[:, cw // 2] = "wall"
        return pattern

    def _labyrinth_pattern(self) -> np.ndarray:
        """DFS maze 11-25 cells per side (odd), border gaps, thickened
        passages, ~3% hub scatter."""
        h = int(self.rng.integers(11, 26))
        w = int(self.rng.integers(11, 26))
        h -= h % 2 == 0
        w -= w % 2 == 0

        maze = np.full((h, w), "wall", dtype=object)
        maze[1, 1] = "empty"
        stack = [(1, 1)]
        while stack:
            r, c = stack[-1]
            neighbors = [
                (r + dr, c + dc)
                for dr, dc in ((-2, 0), (2, 0), (0, -2), (0, 2))
                if 0 <= r + dr < h and 0 <= c + dc < w and maze[r + dr, c + dc] == "wall"
            ]
            if neighbors:
                nr, nc = neighbors[int(self.rng.integers(0, len(neighbors)))]
                maze[(r + nr) // 2, (c + nc) // 2] = "empty"
                maze[nr, nc] = "empty"
                stack.append((nr, nc))
            else:
                stack.pop()

        def has_gap(line: np.ndarray) -> bool:
            run = 0
            for cell in line:
                run = run + 1 if cell == "empty" else 0
                if run >= 2:
                    return True
            return False

        if w > 3 and not has_gap(maze[0, 1 : w - 1]):
            maze[0, 1:3] = "empty"
        if w > 3 and not has_gap(maze[h - 1, 1 : w - 1]):
            maze[h - 1, 1:3] = "empty"
        if h > 3 and not has_gap(maze[1 : h - 1, 0]):
            maze[1:3, 0] = "empty"
        if h > 3 and not has_gap(maze[1 : h - 1, w - 1]):
            maze[1:3, w - 1] = "empty"

        empty_mask = maze == "empty"
        hub_mask = empty_mask & (self.rng.random(maze.shape) < 0.03)
        maze[hub_mask] = "hub"

        thick_prob = 0.7 * self.rng.random()
        thick = maze.copy()
        inner_empty = np.zeros_like(empty_mask)
        inner_empty[1 : h - 1, 1 : w - 1] = maze[1 : h - 1, 1 : w - 1] == "empty"
        right = inner_empty & (self.rng.random(maze.shape) < thick_prob)
        down = inner_empty & (self.rng.random(maze.shape) < thick_prob)
        thick[np.roll(right, 1, axis=1)] = "empty"
        thick[np.roll(down, 1, axis=0)] = "empty"
        return thick
