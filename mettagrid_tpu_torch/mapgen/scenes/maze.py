"""Maze scenes: randomized-Kruskal and randomized-Prim generators
(reference: mapgen/scenes/maze.py — same cell/wall-grid parameterization,
fresh implementations)."""

from __future__ import annotations

import numpy as np

from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig


class _CellGrid:
    """Maze cells of room_size x room_size separated by wall_size walls."""

    def __init__(self, grid: np.ndarray, room_size: int, wall_size: int):
        self.grid = grid
        self.rs = room_size
        self.ws = wall_size
        H, W = grid.shape
        self.rows = (H + wall_size) // (room_size + wall_size)
        self.cols = (W + wall_size) // (room_size + wall_size)

    def carve_cell(self, i: int, j: int) -> None:
        y, x = j * (self.rs + self.ws), i * (self.rs + self.ws)
        self.grid[y : y + self.rs, x : x + self.rs] = "empty"

    def carve_wall(self, i1: int, j1: int, i2: int, j2: int) -> None:
        rs, ws = self.rs, self.ws
        y1, x1 = j1 * (rs + ws), i1 * (rs + ws)
        if i2 == i1 + 1:
            self.grid[y1 : y1 + rs, x1 + rs : x1 + rs + ws] = "empty"
        elif i2 == i1 - 1:
            x2 = i2 * (rs + ws)
            self.grid[y1 : y1 + rs, x2 + rs : x2 + rs + ws] = "empty"
        elif j2 == j1 + 1:
            self.grid[y1 + rs : y1 + rs + ws, x1 : x1 + rs] = "empty"
        else:
            y2 = j2 * (rs + ws)
            self.grid[y2 + rs : y2 + rs + ws, x1 : x1 + rs] = "empty"


class MazeConfig(SceneConfig):
    room_size: int = 1
    wall_size: int = 1
    algorithm: str = "kruskal"  # kruskal | prim


class Maze(Scene[MazeConfig]):
    """Perfect maze over the scene area; walls everywhere else."""

    def render(self) -> None:
        self.grid[:] = "wall"
        cg = _CellGrid(self.grid, self.config.room_size, self.config.wall_size)
        if cg.rows <= 0 or cg.cols <= 0:
            return
        for i in range(cg.cols):
            for j in range(cg.rows):
                cg.carve_cell(i, j)
        if self.config.algorithm == "prim":
            self._prim(cg)
        else:
            self._kruskal(cg)

    def _kruskal(self, cg: _CellGrid) -> None:
        # Union-find over cells; shuffle all interior walls, join when the
        # two sides are in different components.
        parent = list(range(cg.cols * cg.rows))

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        walls = []
        for i in range(cg.cols):
            for j in range(cg.rows):
                if i + 1 < cg.cols:
                    walls.append((i, j, i + 1, j))
                if j + 1 < cg.rows:
                    walls.append((i, j, i, j + 1))
        order = self.rng.permutation(len(walls))
        for wi in order:
            i1, j1, i2, j2 = walls[wi]
            a, b = find(i1 * cg.rows + j1), find(i2 * cg.rows + j2)
            if a != b:
                parent[a] = b
                cg.carve_wall(i1, j1, i2, j2)

    def _prim(self, cg: _CellGrid) -> None:
        visited = np.zeros((cg.cols, cg.rows), dtype=bool)
        start = (int(self.rng.integers(cg.cols)), int(self.rng.integers(cg.rows)))
        visited[start] = True
        frontier = []

        def add_frontier(i, j):
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ni, nj = i + di, j + dj
                if 0 <= ni < cg.cols and 0 <= nj < cg.rows and not visited[ni, nj]:
                    frontier.append((i, j, ni, nj))

        add_frontier(*start)
        while frontier:
            k = int(self.rng.integers(len(frontier)))
            i1, j1, i2, j2 = frontier.pop(k)
            if visited[i2, j2]:
                continue
            visited[i2, j2] = True
            cg.carve_wall(i1, j1, i2, j2)
            add_frontier(i2, j2)


class MazeKruskalConfig(SceneConfig):
    room_size: int = 1
    wall_size: int = 1


class MazeKruskal(Scene[MazeKruskalConfig]):
    """Alias scene matching the reference's MazeKruskal name."""

    def render(self) -> None:
        Maze(
            area=self.area,
            rng=self.rng,
            config=Maze.Config(
                room_size=self.config.room_size,
                wall_size=self.config.wall_size,
                algorithm="kruskal",
            ),
            parent_scene=self.parent_scene,
        ).render()
