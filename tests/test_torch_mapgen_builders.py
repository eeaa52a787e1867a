"""The port's twin of tests/mapgen/test_map_builders2.py: the same properties, held on
the port's copy (the maze and perimeter-in-context map builders)."""

from collections import deque

import numpy as np

from mettagrid_tpu_torch.maps import (
    MazeKruskalMapBuilder,
    MazePrimMapBuilder,
    PerimeterInContextMapBuilder,
)


def _passage_cells_connected(grid: np.ndarray) -> bool:
    """All non-wall cells form one connected component."""
    open_mask = grid != "wall"
    coords = np.argwhere(open_mask)
    if len(coords) == 0:
        return True
    seen = np.zeros_like(open_mask)
    start = tuple(coords[0])
    seen[start] = True
    queue = deque([start])
    while queue:
        i, j = queue.popleft()
        for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ni, nj = i + di, j + dj
            if 0 <= ni < grid.shape[0] and 0 <= nj < grid.shape[1]:
                if open_mask[ni, nj] and not seen[ni, nj]:
                    seen[ni, nj] = True
                    queue.append((ni, nj))
    return bool((seen == open_mask).all())


def test_maze_prim_builds_connected_maze():
    cfg = MazePrimMapBuilder.Config(width=15, height=15, start_pos=(1, 1), end_pos=(-1, -1), seed=3)
    grid = cfg.create().build().grid
    assert grid.shape == (15, 15)
    assert (grid == "agent.agent").sum() == 1
    assert (grid == "hub").sum() == 1
    assert _passage_cells_connected(grid)


def test_maze_kruskal_builds_connected_maze():
    cfg = MazeKruskalMapBuilder.Config(width=15, height=15, seed=5)
    grid = cfg.create().build().grid
    assert (grid == "agent.agent").sum() == 1
    assert (grid == "hub").sum() == 1
    assert _passage_cells_connected(grid)


def test_maze_even_dims_are_trimmed():
    grid = MazePrimMapBuilder.Config(width=12, height=10, seed=0).create().build().grid
    assert grid.shape == (9, 11)


def test_maze_deterministic_by_seed():
    cfg = MazeKruskalMapBuilder.Config(width=13, height=13, seed=9)
    g1 = cfg.create().build().grid
    g2 = cfg.create().build().grid
    assert (g1 == g2).all()


def test_perimeter_incontext_basic():
    cfg = PerimeterInContextMapBuilder.Config(width=9, height=9, objects={"mine": 3}, seed=1)
    grid = cfg.create().build().grid
    assert grid[4, 4] == "agent.agent"
    assert (grid == "mine").sum() == 3
    ys, xs = np.nonzero(grid == "mine")
    for y, x in zip(ys, xs):
        assert y in (0, 8) or x in (0, 8)  # objects on the perimeter
        assert not ((y in (0, 8)) and (x in (0, 8)))  # never in corners


def test_perimeter_incontext_obstacles_keep_reachability():
    builder = PerimeterInContextMapBuilder.Config(
        width=11, height=11, objects={"hub": 2}, density="dense", seed=7
    ).create()
    grid = builder.build().grid
    assert (grid == "wall").sum() > 0
    assert builder._reaches_perimeter(grid, 5, 5)


def test_perimeter_incontext_polymorphic_roundtrip():
    cfg = PerimeterInContextMapBuilder.Config(width=7, height=7)
    dumped = cfg.model_dump()
    from mettagrid_tpu_torch.maps import MapBuilderConfig

    restored = MapBuilderConfig.model_validate(dumped)
    assert isinstance(restored, PerimeterInContextMapBuilder.Config)
