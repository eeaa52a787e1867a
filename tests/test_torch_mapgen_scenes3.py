"""The port's twin of tests/mapgen/test_scenes3.py: the same properties, held on
the port's copy (the file and dungeon scenes, transplant, the distributions and
MapGen's extras)."""

import numpy as np
import pytest
import yaml

from mettagrid_tpu_torch.maps.utils import create_grid
from mettagrid_tpu_torch.mapgen.area import Area
from mettagrid_tpu_torch.mapgen.distributions import (
    FloatConstantDistribution,
    FloatLognormalDistribution,
    IntUniformDistribution,
)
from mettagrid_tpu_torch.mapgen.mapgen import MapGen
from mettagrid_tpu_torch.mapgen.scene import SceneConfig
from mettagrid_tpu_torch.mapgen.scenes import (
    Ascii,
    AsteroidMask,
    BoundedLayout,
    InlineAscii,
    MeanDistance,
    RandomDungeonScene,
    RandomYamlScene,
    TransplantScene,
    YamlScene,
)


def render(cfg: SceneConfig, h: int, w: int) -> np.ndarray:
    grid = create_grid(h, w)
    scene = cfg.create_root(Area.root_area_from_grid(grid), np.random.default_rng(42))
    scene.render_with_children()
    return grid


def test_bounded_layout_creates_tagged_area():
    grid = create_grid(20, 20)
    cfg = BoundedLayout.Config(max_width=8, max_height=8, tag="zone")
    scene = cfg.create_root(Area.root_area_from_grid(grid), np.random.default_rng(0))
    scene.render_with_children()
    areas = scene._areas
    assert len(areas) == 1
    assert "zone" in areas[0].tags
    assert areas[0].width <= 10 and areas[0].height <= 10


def test_mean_distance_places_agent_and_objects():
    grid = render(MeanDistance.Config(mean_distance=3.0, objects={"mine": 5}), 21, 21)
    assert (grid == "agent.agent").sum() == 1
    assert (grid == "mine").sum() == 5
    assert grid[10, 10] == "agent.agent"


def test_asteroid_mask_carves_walls():
    grid = render(AsteroidMask.Config(chunk_prob=1.0), 20, 20)
    assert (grid == "wall").sum() > 0
    # Interior stays untouched.
    assert (grid[9:11, 9:11] == "empty").all()


def test_yaml_scene_roundtrip(tmp_path):
    from mettagrid_tpu_torch.mapgen.scenes import Maze

    scene_file = tmp_path / "maze.yaml"
    scene_file.write_text(yaml.safe_dump(Maze.Config().model_dump(mode="json")))
    grid = render(YamlScene.Config(file=str(scene_file)), 11, 11)
    assert (grid == "wall").sum() > 0


def test_random_yaml_scene(tmp_path):
    from mettagrid_tpu_torch.mapgen.scenes import Maze

    scene_file = tmp_path / "maze.yaml"
    scene_file.write_text(yaml.safe_dump(Maze.Config().model_dump(mode="json")))
    cfg = RandomYamlScene.Config(candidates=[{"scene_file": str(scene_file)}])
    grid = render(cfg, 11, 11)
    assert (grid == "wall").sum() > 0


def test_random_dungeon_scene_bundled_patterns():
    grid = render(RandomDungeonScene.Config(), 24, 24)
    assert (grid == "wall").sum() > 0


def test_ascii_scene_and_intrinsic_size(tmp_path):
    map_file = tmp_path / "map.yaml"
    map_file.write_text(
        yaml.safe_dump({"map_data": ["###", "#.#", "###"], "char_to_map_name": {}})
    )
    assert Ascii.intrinsic_size(Ascii.Config(uri=str(map_file))) == (3, 3)
    grid = render(Ascii.Config(uri=str(map_file)), 3, 3)
    assert grid[0, 0] == "wall" and grid[1, 1] == "empty"


def test_inline_ascii_intrinsic_size():
    assert InlineAscii.intrinsic_size(InlineAscii.Config(data="###\n#.#")) == (2, 3)


def test_mapgen_intrinsic_size_sizing():
    cfg = MapGen.Config(instance=InlineAscii.Config(data="#.#\n...\n#.#"), border_width=1)
    game_map = cfg.create().build()
    assert game_map.grid.shape == (5, 5)


def test_transplant_scene_preserves_rendered_cells():
    from mettagrid_tpu_torch.mapgen.scenes import Maze

    # Render a maze on a temp grid, then transplant into a larger grid.
    tmp = create_grid(9, 9)
    src = Maze.Config().create_root(Area.root_area_from_grid(tmp), np.random.default_rng(7))
    src.render_with_children()
    rendered = tmp.copy()

    big = create_grid(9, 9)
    cfg = TransplantScene.Config(scene=src)
    scene = cfg.create_root(Area.root_area_from_grid(big), np.random.default_rng(0))
    scene.render_with_children()
    assert (big == rendered).all()


def test_mapgen_instance_object_remap():
    cfg = MapGen.Config(
        instance=InlineAscii.Config(data="h.\n.a", char_to_map_name={"h": "hub", "a": "agent.agent"}),
        instances=2,
        border_width=1,
        instance_border_width=1,
        instance_object_remap={"hub": "hub_{instance_id}"},
    )
    grid = cfg.create().build().grid
    assert (grid == "hub_0").sum() == 1
    assert (grid == "hub_1").sum() == 1


def test_mapgen_border_clear_radius():
    cfg = MapGen.Config(
        instance=InlineAscii.Config(data="##\n##"),
        instances=2,
        border_width=1,
        instance_border_width=1,
        instance_border_clear_radius=1,
    )
    grid = cfg.create().build().grid
    # All instance content near the boundary got cleared back to empty.
    assert (grid[1:-1, 1:-1] == "empty").any()


def test_distributions():
    rng = np.random.default_rng(0)
    assert FloatConstantDistribution(value=0.5).sample(rng) == 0.5
    v = IntUniformDistribution(low=2, high=4).sample(rng)
    assert 2 <= v <= 4
    ln = FloatLognormalDistribution(low=0.01, high=0.1, max=0.05)
    assert all(ln.sample(rng) <= 0.05 for _ in range(50))
    with pytest.raises(ValueError):
        FloatLognormalDistribution(low=0.2, high=0.1).sample(rng)


def test_random_objects_distribution_ranges():
    from mettagrid_tpu_torch.mapgen.scenes import RandomObjects

    grid = render(RandomObjects.Config(object_ranges={"mine": ("uniform", 0.1, 0.2)}), 10, 10)
    count = (grid == "mine").sum()
    assert 10 <= count <= 20
