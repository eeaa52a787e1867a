"""A ``mapgen_random`` map drawn from its seed in plain NumPy: upstream's
MapGen (mapgen/mapgen.py) around one Random scene (mapgen/scenes/random.py),
as the configuration file sizes it. Nothing of the program is imported.

MapGen seeds its stream with the map's seed and gives each render of the
instance scene a generator seeded from that stream. Asked for a number of
agents, it first renders the instance once to count the agents in it, so
the map is the second render. Random scatters its objects, then its agents,
over the empty cells: it picks the cells without replacement, shuffles the
symbols and writes them there. The room sits inside a border of walls.
"""

from __future__ import annotations

import numpy as np


def draw(m: dict, seed: int) -> np.ndarray:
    """The map's grid of cell names, (height + 2 border) x (width + 2 border)."""
    stream = np.random.default_rng(seed)
    symbols = [name for name, n in m["objects"].items() for _ in range(n)] + ["agent.agent"] * m["agents"]

    def room() -> np.ndarray:
        rng = np.random.default_rng(stream.integers(2**31))
        grid = np.full((m["height"], m["width"]), "empty", dtype="<U50")
        ys, xs = np.nonzero(grid == "empty")
        chosen = rng.choice(len(ys), size=len(symbols), replace=False)
        sym = np.array(symbols, dtype=grid.dtype)
        rng.shuffle(sym)
        grid[ys[chosen], xs[chosen]] = sym
        return grid

    room()  # the render that counts the agents
    b = m["border_width"]
    grid = np.full((m["height"] + 2 * b, m["width"] + 2 * b), "wall", dtype="<U50")
    grid[b:b + m["height"], b:b + m["width"]] = room()
    return grid
