"""The port's twin of tests/mapgen/test_scenes2.py: the same properties, held on
the port's copy (the texture-synthesis and utility scenes)."""

import numpy as np

from mettagrid_tpu_torch.mapgen import Area
from mettagrid_tpu_torch.mapgen.scenes import (
    WFC,
    ConvChain,
    CopyGrid,
    Dither,
    RadialMaze,
    RandomObjects,
    RemoveAgents,
    Spiral,
)
from mettagrid_tpu_torch.maps.utils import create_grid

SAMPLE = """\
###..
##...
#...#
...##
..###
"""


def render(scene_cfg, h=15, w=15, seed=3):
    grid = create_grid(h, w)
    scene = scene_cfg.create_root(Area.root_area_from_grid(grid), rng=np.random.default_rng(seed))
    scene.render_with_children()
    return grid


def test_convchain_produces_mixed_texture():
    grid = render(ConvChain.Config(pattern=SAMPLE, pattern_size=3, iterations=2, temperature=1.0), 12, 12)
    walls = (grid == "wall").sum()
    assert 0 < walls < 12 * 12  # neither all-wall nor all-empty


def test_wfc_produces_valid_output():
    grid = render(WFC.Config(pattern=SAMPLE, pattern_size=3), 12, 12)
    walls = (grid == "wall").sum()
    assert 0 < walls < 12 * 12


def test_spiral_has_walls_and_corridors():
    grid = render(Spiral.Config(), 15, 15)
    assert (grid == "wall").sum() > 10
    assert (grid == "empty").sum() > 10


def test_radial_maze_arms():
    grid = render(RadialMaze.Config(arms=4), 15, 15)
    cy, cx = 7, 7
    assert grid[cy, cx] == "empty"
    assert (grid == "empty").sum() > 10
    assert (grid == "wall").sum() > 50


def test_random_objects_fraction():
    grid = render(RandomObjects.Config(object_ranges={"mine": 0.25}), 10, 10)
    assert (grid == "mine").sum() == 25


def test_remove_agents():
    grid = create_grid(5, 5)
    grid[2, 2] = "agent.agent"
    scene = RemoveAgents.Config().create_root(Area.root_area_from_grid(grid), rng=np.random.default_rng(0))
    scene.render_with_children()
    assert (grid == "agent.agent").sum() == 0


def test_copy_grid_blits_centered():
    src = create_grid(3, 3, fill_value="wall")
    grid = render(CopyGrid.Config(source=src), 7, 7)
    assert grid[3, 3] == "wall"
    assert (grid == "wall").sum() == 9


def test_dither_density():
    grid = render(Dither.Config(density=0.5), 20, 20)
    frac = (grid == "wall").sum() / 400
    assert 0.3 < frac < 0.7


def test_biomes_render():
    from mettagrid_tpu_torch.mapgen.scenes import (
        BiomeCaves,
        BiomeCity,
        BiomeDesert,
        BiomeForest,
        BiomePlains,
    )

    for cfg in (
        BiomeCaves.Config(),
        BiomePlains.Config(),
        BiomeForest.Config(),
        BiomeDesert.Config(),
        BiomeCity.Config(),
    ):
        grid = render(cfg, 20, 20)
        walls = (grid == "wall").sum()
        assert 0 < walls < 400, type(cfg).__name__
