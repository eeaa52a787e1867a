"""The port's twin of tests/mapgen/test_scenes4.py: the same properties, held on
the port's copy (the composition scenes: auto, compound, varied terrain, building
distributions, grid hubs, multi left-and-right)."""

import numpy as np
import pytest

from mettagrid_tpu_torch.maps.utils import create_grid
from mettagrid_tpu_torch.mapgen.area import Area
from mettagrid_tpu_torch.mapgen.scene import SceneConfig
from mettagrid_tpu_torch.mapgen.scenes import (
    Auto,
    Compound,
    DistributionConfig,
    FourCornerCompounds,
    GridHubs,
    Maze,
    MultiLeftAndRight,
    UniformExtractorScene,
    VariedTerrain,
)


def render(cfg: SceneConfig, h: int, w: int, seed: int = 42) -> np.ndarray:
    grid = create_grid(h, w)
    scene = cfg.create_root(Area.root_area_from_grid(grid), np.random.default_rng(seed))
    scene.render_with_children()
    return grid


def test_auto_scene_full_composition():
    cfg = Auto.Config(
        num_agents=4,
        layout={"grid": 1, "bsp": 1},
        grid={"rows": 2, "columns": 2},
        bsp={"area_count": 3},
        room_symmetry={"none": 1, "horizontal": 1, "vertical": 1, "x4": 1},
        content=[{"scene": Maze.Config(), "weight": 1}],
        objects={"hub": 0.01},
        room_objects={"mine": 0.005},
    )
    for seed in (0, 1, 2):
        grid = render(cfg, 30, 30, seed)
        assert (grid == "agent.agent").sum() == 4


def test_compound_default_layout():
    grid = render(Compound.Config(spawn_count=4, stations=["aligner_station"]), 31, 31)
    assert (grid == "hub").sum() == 1
    assert (grid == "agent.agent").sum() == 4
    assert (grid == "aligner_station").sum() == 1
    for extractor in ("carbon_extractor", "oxygen_extractor", "germanium_extractor", "silicon_extractor"):
        assert (grid == extractor).sum() == 1


def test_compound_tight_layout():
    grid = render(Compound.Config(layout="tight", spawn_count=6), 31, 31)
    assert (grid == "hub").sum() == 1
    assert (grid == "agent.agent").sum() == 6
    assert (grid == "wall").sum() > 0


def test_compound_kitchen_layouts():
    stations = [f"s{i}" for i in range(9)]
    for layout in ("cramped_room", "service_pass_room"):
        grid = render(Compound.Config(layout=layout, stations=stations, hub_width=17, hub_height=13), 25, 25)
        for s in stations:
            assert (grid == s).sum() == 1, (layout, s)
        assert (grid == "agent.agent").sum() == 4


def test_compound_station_offsets():
    grid = render(
        Compound.Config(stations=["a", "b"], station_offsets=[(-3, 5), (3, 5)]), 31, 31
    )
    assert (grid == "a").sum() == 1 and (grid == "b").sum() == 1


def test_four_corner_compounds():
    cfg = FourCornerCompounds.Config(
        num_compounds=4,
        spawn_count=2,
        hub_objects=["hub_0", "hub_1", "hub_2", "hub_3"],
        spawn_symbols=[f"agent.team_{i}" for i in range(4)],
    )
    grid = render(cfg, 60, 60)
    for i in range(4):
        assert (grid == f"hub_{i}").sum() == 1
        assert (grid == f"agent.team_{i}").sum() == 2


def test_varied_terrain_styles():
    for style in ("all-sparse", "balanced", "dense", "maze"):
        grid = render(VariedTerrain.Config(objects={"hub": 3}, agents=2, style=style), 40, 40)
        assert (grid == "agent.agent").sum() == 2, style
        assert (grid == "hub").sum() >= 3, style  # labyrinths may scatter extra hubs


def test_varied_terrain_unknown_style():
    with pytest.raises(ValueError, match="Unknown style"):
        render(VariedTerrain.Config(objects={}, style="nope"), 20, 20)


def test_uniform_extractor_grid_mode():
    grid = render(UniformExtractorScene.Config(rows=3, cols=3, jitter=0), 20, 20)
    placed = sum(
        (grid == name).sum()
        for name in ("carbon_extractor", "oxygen_extractor", "germanium_extractor", "silicon_extractor", "junction")
    )
    assert placed == 9


def test_uniform_extractor_target_coverage_distributions():
    for dist_type in ("uniform", "normal", "exponential", "poisson", "bimodal"):
        cfg = UniformExtractorScene.Config(
            target_coverage=0.02,
            distribution=DistributionConfig(type=dist_type),
            building_names=["junction"],
        )
        grid = render(cfg, 30, 30)
        assert (grid == "junction").sum() > 0, dist_type


def test_uniform_extractor_weights():
    cfg = UniformExtractorScene.Config(rows=4, cols=4, building_weights={"junction": 1.0})
    grid = render(cfg, 25, 25)
    assert (grid == "junction").sum() == 16


def test_grid_hubs():
    grid = render(GridHubs.Config(objects={"hub": 4}, agents=1, margin=3, min_spacing=4), 25, 25)
    assert (grid == "hub").sum() == 4
    assert (grid == "agent.agent").sum() == 1
    assert grid[12, 12] == "agent.agent"


def test_multi_left_and_right():
    cfg = MultiLeftAndRight.Config(rows=1, columns=2, hub_ratio=0.75, total_hubs=4)
    grid = render(cfg, 20, 60)
    assert (grid == "agent.team_1").sum() == 1
    assert (grid == "agent.team_2").sum() == 1
    assert (grid == "hub").sum() > 0
