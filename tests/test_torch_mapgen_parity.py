"""The port's MapGen against the JAX package's, grid for grid.

Both packages build maps on the host with numpy from np.random.default_rng
and Generator.spawn, so the same config and seed must give the same grid
in each (exact). Every scene type of the port is built here from one
config, the same one in each package; so are make_assembly_lines and
MapGen's multi-instance layouts. The two tools run on files the test
writes: ``dungeon_import`` in path mode only, ``gen`` on a YAML config.
"""

import importlib
import inspect
import pkgutil
import sys
import types

import numpy as np
import pytest
import yaml

SAMPLE = "###..\n##...\n#...#\n...##\n..###"


def _pkg(root: str) -> types.SimpleNamespace:
    """The mapgen names of one package (root "mettagrid_tpu" or
    "mettagrid_tpu_torch")."""
    imp = importlib.import_module
    mapgen = imp(f"{root}.mapgen")
    return types.SimpleNamespace(
        root=root,
        S=imp(f"{root}.mapgen.scenes"),
        MapGen=mapgen.MapGen,
        Area=mapgen.Area,
        AreaWhere=mapgen.AreaWhere,
        ChildrenAction=mapgen.ChildrenAction,
        create_grid=imp(f"{root}.maps.utils").create_grid,
        builder=imp(f"{root}.builder"),
        GridObjectConfig=imp(f"{root}.config.game_config").GridObjectConfig,
    )


JAX = _pkg("mettagrid_tpu")
PORT = _pkg("mettagrid_tpu_torch")


def _auto(P):
    return dict(
        num_agents=4,
        layout={"grid": 1, "bsp": 1},
        grid={"rows": 2, "columns": 2},
        bsp={"area_count": 3},
        room_symmetry={"none": 1, "horizontal": 1, "vertical": 1, "x4": 1},
        content=[{"scene": P.S.Maze.Config(), "weight": 1}, {"scene": P.S.Random.Config(objects={"mine": 2}),
                                                               "weight": 1}],
        objects={"hub": 0.01},
        room_objects={"mine": 0.005},
    )


def _in_tag(P, tag, scene):
    return [P.ChildrenAction(scene=scene, where=P.AreaWhere(tags=[tag]))]


def _full(P, *scenes):
    return [P.ChildrenAction(scene=s, where="full") for s in scenes]


def _write(tmp, name, data):
    path = tmp / name
    path.write_text(yaml.safe_dump(data))
    return str(path)


def _rendered_maze(P):
    grid = P.create_grid(13, 13)
    scene = P.S.Maze.Config().create_root(P.Area.root_area_from_grid(grid), np.random.default_rng(7))
    scene.render_with_children()
    return scene


# name -> (config builder (package, tmp dir) -> SceneConfig, height, width).
SCENES = {
    "Ascii": (lambda P, t: P.S.Ascii.Config(uri=_write(t, "map.yaml", {
        "map_data": ["#####", "#.@.#", "#####"], "char_to_map_name": {}})), 3, 5),
    "AsteroidMask": (lambda P, t: P.S.AsteroidMask.Config(chunk_prob=0.7), 20, 20),
    "Auto": (lambda P, t: P.S.Auto.Config(**_auto(P)), 30, 30),
    "AutoLayout": (lambda P, t: P.S.AutoLayout.Config(auto_config=P.S.Auto.Config(**_auto(P))), 30, 30),
    "AutoSymmetry": (lambda P, t: P.S.AutoSymmetry.Config(auto_config=P.S.Auto.Config(**_auto(P))), 15, 15),
    "BSP": (lambda P, t: P.S.BSP.Config(rooms=5, children=_full(P, P.S.Random.Config(agents=3))), 25, 25),
    "BSPLayout": (lambda P, t: P.S.BSPLayout.Config(area_count=4, children=_in_tag(
        P, "zone", P.S.Random.Config(objects={"mine": 1}))), 24, 24),
    "BiomeCaves": (lambda P, t: P.S.BiomeCaves.Config(), 20, 20),
    "BiomeCity": (lambda P, t: P.S.BiomeCity.Config(), 20, 20),
    "BiomeDesert": (lambda P, t: P.S.BiomeDesert.Config(), 20, 20),
    "BiomeForest": (lambda P, t: P.S.BiomeForest.Config(), 20, 20),
    "BiomePlains": (lambda P, t: P.S.BiomePlains.Config(), 20, 20),
    "BoundedLayout": (lambda P, t: P.S.BoundedLayout.Config(max_width=8, max_height=8, tag="zone", children=_in_tag(
        P, "zone", P.S.Random.Config(agents=2, objects={"wall": 3}))), 20, 20),
    "Compound": (lambda P, t: P.S.Compound.Config(spawn_count=4, stations=["aligner_station"]), 31, 31),
    "ConvChain": (lambda P, t: P.S.ConvChain.Config(pattern=SAMPLE, pattern_size=3, iterations=2,
                                                    temperature=1.0), 12, 12),
    "CopyGrid": (lambda P, t: P.S.CopyGrid.Config(source=np.array([["wall", "mine"], ["empty", "wall"]])), 6, 7),
    "Dither": (lambda P, t: P.S.Dither.Config(density=0.4), 16, 16),
    "FourCornerCompounds": (lambda P, t: P.S.FourCornerCompounds.Config(
        num_compounds=4, spawn_count=2, hub_objects=[f"hub_{i}" for i in range(4)],
        spawn_symbols=[f"agent.team_{i}" for i in range(4)]), 60, 60),
    "GridHubs": (lambda P, t: P.S.GridHubs.Config(objects={"hub": 4}, agents=1, margin=3, min_spacing=4,
                                                  randomize_position=2), 25, 25),
    "InlineAscii": (lambda P, t: P.S.InlineAscii.Config(data="#@\n#.", row=1, column=2), 5, 5),
    "Layout": (lambda P, t: P.S.Layout.Config(
        areas=[{"width": 4, "height": 3, "placement": "top-right", "tag": "z"}],
        children=_in_tag(P, "z", P.S.Random.Config(agents=1, objects={"mine": 2}))), 9, 9),
    "MakeConnected": (lambda P, t: P.S.Nop.Config(children=_full(
        P, P.S.Random.Config(objects={"wall": 60}), P.S.MakeConnected.Config())), 12, 12),
    "Maze": (lambda P, t: P.S.Maze.Config(algorithm="prim", room_size=2), 17, 17),
    "MazeKruskal": (lambda P, t: P.S.MazeKruskal.Config(), 15, 15),
    "MeanDistance": (lambda P, t: P.S.MeanDistance.Config(mean_distance=3.0, objects={"mine": 5}), 21, 21),
    "Mirror": (lambda P, t: P.S.Mirror.Config(scene=P.S.Random.Config(objects={"wall": 4}, agents=1),
                                              symmetry="x4"), 10, 12),
    "MultiLeftAndRight": (lambda P, t: P.S.MultiLeftAndRight.Config(rows=1, columns=2, hub_ratio=0.75,
                                                                    total_hubs=4), 20, 60),
    "Nop": (lambda P, t: P.S.Nop.Config(children=_full(P, P.S.Random.Config(agents=2))), 7, 7),
    "RadialMaze": (lambda P, t: P.S.RadialMaze.Config(arms=6, arm_width=2), 17, 17),
    "Random": (lambda P, t: P.S.Random.Config(objects={"wall": 5, "mine": 2}, agents={"team_0": 2, "team_1": 1}),
               11, 11),
    "RandomDungeonScene": (lambda P, t: P.S.RandomDungeonScene.Config(), 24, 24),
    "RandomObjects": (lambda P, t: P.S.RandomObjects.Config(object_ranges={"mine": ("uniform", 0.1, 0.2),
                                                                           "hub": 0.05}), 12, 12),
    "RandomScene": (lambda P, t: P.S.RandomScene.Config(candidates=[
        {"scene": P.S.Maze.Config(), "weight": 1.0}, {"scene": P.S.Spiral.Config(), "weight": 2.0}]), 13, 13),
    "RandomYamlScene": (lambda P, t: P.S.RandomYamlScene.Config(candidates=[
        {"scene_file": _write(t, "maze.yaml", P.S.Maze.Config().model_dump(mode="json"))},
        {"scene_file": _write(t, "dither.yaml", P.S.Dither.Config(density=0.3).model_dump(mode="json"))}]), 11, 11),
    "RemoveAgents": (lambda P, t: P.S.Nop.Config(children=_full(
        P, P.S.Random.Config(agents=3, objects={"mine": 2}), P.S.RemoveAgents.Config())), 8, 8),
    "RoomGrid": (lambda P, t: P.S.RoomGrid.Config(rows=2, columns=3, border_width=1, children=_in_tag(
        P, "room_1_2", P.S.Random.Config(agents=1))), 11, 16),
    "Spiral": (lambda P, t: P.S.Spiral.Config(wall_gap=3), 15, 15),
    "TransplantScene": (lambda P, t: P.S.TransplantScene.Config(scene=_rendered_maze(P)), 13, 13),
    "UniformExtractorScene": (lambda P, t: P.S.UniformExtractorScene.Config(
        target_coverage=0.02, distribution=P.S.DistributionConfig(type="bimodal")), 30, 30),
    "VariedTerrain": (lambda P, t: P.S.VariedTerrain.Config(objects={"hub": 3}, agents=2, style="maze"), 40, 40),
    "WFC": (lambda P, t: P.S.WFC.Config(pattern=SAMPLE, pattern_size=3), 12, 12),
    "YamlScene": (lambda P, t: P.S.YamlScene.Config(file=_write(
        t, "bsp.yaml", P.S.BSP.Config(rooms=3).model_dump(mode="json"))), 16, 16),
}


def _render(P, name, tmp, seed):
    make, h, w = SCENES[name]
    tmp.mkdir(parents=True, exist_ok=True)
    grid = P.create_grid(h, w)
    scene = make(P, tmp).create_root(P.Area.root_area_from_grid(grid), np.random.default_rng(seed))
    scene.render_with_children()
    return grid


def _port_scene_types():
    from mettagrid_tpu_torch.mapgen import scenes
    from mettagrid_tpu_torch.mapgen.scene import Scene

    found = set()
    for info in pkgutil.iter_modules(scenes.__path__, scenes.__name__ + "."):
        mod = importlib.import_module(info.name)
        for obj in vars(mod).values():
            if inspect.isclass(obj) and issubclass(obj, Scene) and obj.__module__ == mod.__name__:
                found.add(obj.__name__)
    return found


def test_every_scene_type_has_a_case():
    assert _port_scene_types() == set(SCENES)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_grid_matches_jax(name, tmp_path):
    for seed in (42, 7):
        ref = _render(JAX, name, tmp_path / "jax", seed)
        got = _render(PORT, name, tmp_path / "port", seed)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref, err_msg=f"{name} seed {seed}")


def _assembly_lines(P, num_agents, seed, **kw):
    cfg = P.builder.make_assembly_lines(
        num_agents, 50, {"mine": P.GridObjectConfig(name="mine"), "hub": P.GridObjectConfig(name="hub")},
        {"mine": 2, "hub": 2}, terrain="balanced")
    mb = cfg.game.map_builder
    # The JAX package builds an unseeded builder instance from fresh entropy;
    # a seeded instance makes both packages' maps a function of the seed.
    mb.instance.seed = seed
    for k, v in kw.items():
        setattr(mb, k, v)
    return mb


def _bsp_arena(P, size, agents):
    return P.MapGen.Config(
        width=size, height=size, border_width=5, seed=3,
        instance=P.S.BSP.Config(rooms=12, min_room_size=4, min_room_size_ratio=0.4, max_room_size_ratio=0.8,
                                children=_full(P, P.S.Random.Config(agents=agents, objects={"wall": 20}))))


# name -> (map builder config of a package, agents).
MAPS = {
    "assembly_lines": (lambda P: _assembly_lines(P, 24, 5), 24),
    "assembly_lines_teams": (lambda P: _assembly_lines(P, 4, 9, set_team_by_instance=True,
                                                       instance_object_remap={"hub": "hub_{instance_id}"}), 4),
    "bsp_arena": (lambda P: _bsp_arena(P, 48, 6), 6),
    "instances_from_agents": (lambda P: P.MapGen.Config(
        width=7, height=7, border_width=2, instance_border_width=1, seed=11, instance_border_clear_radius=1,
        instance=P.S.Random.Config(agents=2, objects={"wall": 6}),
        instance_names=["red", "blue", "green"], instance_object_remap={"agent.agent": "agent.{instance_name}"}), 6),
    "auto": (lambda P: P.MapGen.Config(width=30, height=30, seed=2, instance=P.S.Auto.Config(**_auto(P))), 4),
}


@pytest.mark.parametrize("name", sorted(MAPS))
def test_mapgen_grid_matches_jax(name):
    make, agents = MAPS[name]
    ref = make(JAX).create().build_for_num_agents(agents).grid
    got = make(PORT).create().build_for_num_agents(agents).grid
    np.testing.assert_array_equal(got, ref)
    assert np.char.startswith(got.astype(str), "agent").sum() == agents


def test_seeded_mapgen_seeds_builder_instance():
    """An unseeded builder instance under a seeded MapGen (make_assembly_lines)
    builds the same maps for the same MapGen seed, and a pool seeded
    seed + i, as MettaGridVectorEnv seeds it, holds distinct maps."""
    from mettagrid_tpu_torch.envs.vector_env import MettaGridVectorEnv

    cfg = PORT.builder.make_assembly_lines(4, 50, {"mine": PORT.GridObjectConfig(name="mine")}, {"mine": 2},
                                           terrain="dense")
    mb = cfg.game.map_builder
    assert mb.instance.seed is None
    grids = []
    for seed in (4, 4, 5):
        mb.seed = seed
        grids.append(mb.create().build_for_num_agents(4).grid)
    assert np.array_equal(grids[0], grids[1]) and not np.array_equal(grids[0], grids[2])
    envs = [MettaGridVectorEnv(cfg, num_envs=2, map_pool=3, seed=8, device="cpu") for _ in range(2)]
    pools = [env._init.grid for env in envs]
    np.testing.assert_array_equal(pools[0], pools[1])
    assert len({pools[0][i].tobytes() for i in range(3)}) == 3


DES = """NAME: test_vault_one
ORIENT: float
MAP
xxxxxxx
x.....x
x.xxx.x
x.....x
xxxxxxx
ENDMAP

NAME: test_vault_two
MAP
xx..xx
x....x
..xx..
x....x
xx..xx
ENDMAP

NAME: empty_vault
MAP
......
ENDMAP
"""


def _run_dungeon_import(root, monkeypatch, src, out):
    mod = importlib.import_module(f"{root}.mapgen.tools.dungeon_import")
    monkeypatch.setattr(sys, "argv", ["dungeon_import", "--src", str(src), "--out", str(out)])
    mod.main()
    return {p.relative_to(out).as_posix(): p.read_text() for p in sorted(out.rglob("*.yaml"))}


def test_dungeon_import_path_mode(tmp_path, monkeypatch):
    src = tmp_path / "vaults.des"
    src.write_text(DES)
    ref = _run_dungeon_import("mettagrid_tpu", monkeypatch, src, tmp_path / "jax")
    got = _run_dungeon_import("mettagrid_tpu_torch", monkeypatch, src, tmp_path / "port")
    assert set(got) == set(ref) and "convchain/test_vault_one.yaml" in got
    from mettagrid_tpu_torch.mapgen import SceneConfig

    for rel, text in got.items():
        assert text == ref[rel].replace("type: mettagrid_tpu.", "type: mettagrid_tpu_torch."), rel
        data = yaml.safe_load(text)
        assert data["type"].startswith("mettagrid_tpu_torch.mapgen.scenes."), rel
        assert type(SceneConfig.model_validate(data)).__module__.startswith("mettagrid_tpu_torch.")


@pytest.mark.parametrize("mode", ["config", "scene"])
def test_gen_renders_yaml(mode, tmp_path, capsys):
    outs = []
    for P in (JAX, PORT):
        if mode == "config":
            data = _bsp_arena(P, 24, 3).model_dump(mode="json")
            args = [f"--config={_write(tmp_path, P.root + '.yaml', data)}", "--seed=4"]
        else:
            data = P.S.Maze.Config(children=_full(P, P.S.Random.Config(agents=2))).model_dump(mode="json")
            args = [f"--scene={_write(tmp_path, P.root + '.yaml', data)}", "--width=15", "--height=11", "--seed=2"]
        assert importlib.import_module(f"{P.root}.mapgen.tools.gen").main(args) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert "@" in outs[1] and "#" in outs[1]
