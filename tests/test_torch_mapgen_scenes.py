"""The port's twin of tests/mapgen/test_scenes.py: the same properties, held on
the port's copy (the basic scenes, MapGen's instance layout and teams, and a scene config's
round trip by its type path)."""

import numpy as np

from mettagrid_tpu_torch.mapgen import Area, ChildrenAction, MapGen
from mettagrid_tpu_torch.mapgen.area import AreaWhere
from mettagrid_tpu_torch.mapgen.scene import GridTransform
from mettagrid_tpu_torch.mapgen.scenes import (
    BSP,
    InlineAscii,
    MakeConnected,
    Maze,
    Mirror,
    Nop,
    Random,
    RandomScene,
    RoomGrid,
)
from mettagrid_tpu_torch.mapgen.scenes.random_scene import RandomSceneCandidate
from mettagrid_tpu_torch.maps.utils import create_grid


def render(scene_cfg, h=11, w=11):
    grid = create_grid(h, w)
    scene = scene_cfg.create_root(Area.root_area_from_grid(grid), rng=np.random.default_rng(42))
    scene.render_with_children()
    return grid, scene


def test_random_scene_places_objects_and_agents():
    grid, _ = render(Random.Config(objects={"wall": 5}, agents=3))
    assert (grid == "wall").sum() == 5
    assert (grid == "agent.agent").sum() == 3


def test_maze_is_connected_and_has_walls():
    grid, _ = render(Maze.Config(algorithm="kruskal"), 11, 11)
    assert (grid == "wall").sum() > 0
    # All empty cells connected (perfect maze property)
    walkable = grid != "wall"
    ys, xs = np.nonzero(walkable)
    seen = {(ys[0], xs[0])}
    stack = [(ys[0], xs[0])]
    while stack:
        y, x = stack.pop()
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            ny, nx = y + dy, x + dx
            if 0 <= ny < 11 and 0 <= nx < 11 and walkable[ny, nx] and (ny, nx) not in seen:
                seen.add((ny, nx))
                stack.append((ny, nx))
    assert len(seen) == walkable.sum()


def test_maze_prim_runs():
    grid, _ = render(Maze.Config(algorithm="prim"), 9, 9)
    assert (grid == "empty").sum() > 0


def test_bsp_rooms_and_corridors_connected():
    grid, scene = render(BSP.Config(rooms=4), 21, 21)
    assert len([a for a in scene._areas if "room" in a.tags]) == 4
    walkable = grid != "wall"
    assert walkable.sum() > 0
    ys, xs = np.nonzero(walkable)
    seen = {(ys[0], xs[0])}
    stack = [(ys[0], xs[0])]
    while stack:
        y, x = stack.pop()
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            ny, nx = y + dy, x + dx
            if 0 <= ny < 21 and 0 <= nx < 21 and walkable[ny, nx] and (ny, nx) not in seen:
                seen.add((ny, nx))
                stack.append((ny, nx))
    assert len(seen) == walkable.sum(), "BSP corridors must connect all rooms"


def test_room_grid_areas_tagged():
    grid, scene = render(RoomGrid.Config(rows=2, columns=2, border_width=1), 11, 11)
    rooms = [a for a in scene._areas if "room" in a.tags]
    assert len(rooms) == 4
    assert (grid == "empty").sum() > 0


def test_children_action_renders_into_tagged_area():
    cfg = RoomGrid.Config(
        rows=1,
        columns=2,
        border_width=1,
        children=[
            ChildrenAction(
                scene=Random.Config(agents=1),
                where=AreaWhere(tags=["room_0_0"]),
            )
        ],
    )
    grid, _ = render(cfg, 7, 11)
    assert (grid == "agent.agent").sum() == 1


def test_inline_ascii():
    grid, _ = render(InlineAscii.Config(data="#@\n#."), 5, 5)
    assert grid[0, 0] == "wall" and grid[0, 1] == "agent.agent"


def test_mirror_horizontal():
    cfg = Mirror.Config(scene=InlineAscii.Config(data="#"), symmetry="horizontal")
    grid, _ = render(cfg, 3, 6)
    assert grid[0, 0] == "wall" and grid[0, 5] == "wall"


def test_make_connected_carves():
    grid = create_grid(5, 7)
    grid[:, 3] = "wall"  # split into two halves
    scene = MakeConnected.Config().create_root(
        Area.root_area_from_grid(grid), rng=np.random.default_rng(0)
    )
    scene.render_with_children()
    walkable = grid != "wall"
    ys, xs = np.nonzero(walkable)
    seen = {(ys[0], xs[0])}
    stack = [(ys[0], xs[0])]
    while stack:
        y, x = stack.pop()
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            ny, nx = y + dy, x + dx
            if 0 <= ny < 5 and 0 <= nx < 7 and walkable[ny, nx] and (ny, nx) not in seen:
                seen.add((ny, nx))
                stack.append((ny, nx))
    assert len(seen) == walkable.sum()


def test_random_scene_picks_candidate():
    cfg = RandomScene.Config(
        candidates=[
            RandomSceneCandidate(scene=InlineAscii.Config(data="#"), weight=1.0),
        ]
    )
    grid, _ = render(cfg, 3, 3)
    assert grid[0, 0] == "wall"


def test_transform_rotates_child():
    cfg = Nop.Config(
        children=[
            ChildrenAction(
                scene=InlineAscii.Config(data="##", transform=GridTransform.ROT_90),
                where="full",
            )
        ]
    )
    grid, _ = render(cfg, 4, 4)
    # Two horizontal walls rotated 90° -> vertical pair
    assert (grid == "wall").sum() == 2


def test_mapgen_multi_instance_layout():
    gm = MapGen(
        MapGen.Config(
            width=5,
            height=5,
            border_width=1,
            instance_border_width=1,
            instance=Random.Config(agents=2),
            num_agents=8,
        )
    ).build()
    assert (gm.grid == "agent.agent").sum() == 8
    # 4 instances in a 2x2 layout: 5*2+1 inner + 2 border
    assert gm.grid.shape == (13, 13)


def test_mapgen_team_assignment():
    gm = MapGen(
        MapGen.Config(
            width=5,
            height=5,
            instance=Random.Config(agents=1),
            instances=2,
            set_team_by_instance=True,
        )
    ).build()
    assert (gm.grid == "agent.team_0").sum() == 1
    assert (gm.grid == "agent.team_1").sum() == 1


def test_scene_config_roundtrip_by_type_path():
    cfg = Random.Config(agents=2, objects={"wall": 1})
    data = cfg.model_dump()
    assert data["type"].endswith("Random.Config")
    from mettagrid_tpu_torch.mapgen.scene import SceneConfig

    cfg2 = SceneConfig.model_validate(data)
    assert isinstance(cfg2, Random.Config)
    assert cfg2.agents == 2
