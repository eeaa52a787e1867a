"""Auto: randomized full-map composition — layout (room grid or BSP), per-room
symmetry-wrapped content, global objects, connectivity, agents
(reference: mapgen/scenes/auto.py)."""

from __future__ import annotations

import numpy as np

from mettagrid_tpu_torch.base_config import Config
from mettagrid_tpu_torch.mapgen.area import AreaWhere
from mettagrid_tpu_torch.mapgen.distributions import FloatDistribution, IntDistribution
from mettagrid_tpu_torch.mapgen.scene import ChildrenAction, Scene, SceneConfig
from mettagrid_tpu_torch.mapgen.scenes.bsp import BSPLayout
from mettagrid_tpu_torch.mapgen.scenes.make_connected import MakeConnected
from mettagrid_tpu_torch.mapgen.scenes.mirror import Mirror
from mettagrid_tpu_torch.mapgen.scenes.misc import RandomObjects
from mettagrid_tpu_torch.mapgen.scenes.random import Random
from mettagrid_tpu_torch.mapgen.scenes.random_scene import RandomScene, RandomSceneCandidate
from mettagrid_tpu_torch.mapgen.scenes.room_grid import RoomGrid


class AutoConfigLayout(Config):
    grid: int
    bsp: int


class AutoConfigGrid(Config):
    rows: IntDistribution
    columns: IntDistribution


class AutoConfigBSP(Config):
    area_count: IntDistribution


class AutoConfigRoomSymmetry(Config):
    none: int
    horizontal: int
    vertical: int
    x4: int


class AutoConfig(SceneConfig):
    num_agents: int = 0
    layout: AutoConfigLayout
    grid: AutoConfigGrid
    bsp: AutoConfigBSP
    room_symmetry: AutoConfigRoomSymmetry
    content: list[RandomSceneCandidate]
    objects: dict[str, FloatDistribution]
    room_objects: dict[str, FloatDistribution]


def _weighted_choice(rng: np.random.Generator, options: list[str], weights: list[float]) -> str:
    probs = np.asarray(weights, dtype=np.float32)
    probs /= probs.sum()
    return str(rng.choice(options, p=probs))


class Auto(Scene[AutoConfig]):
    def get_children(self) -> list[ChildrenAction]:
        return [
            ChildrenAction(scene=AutoLayout.Config(auto_config=self.config), where="full"),
            ChildrenAction(scene=RandomObjects.Config(object_ranges=self.config.objects), where="full"),
            ChildrenAction(scene=MakeConnected.Config(), where="full"),
            ChildrenAction(scene=Random.Config(agents=self.config.num_agents), where="full"),
        ]

    def render(self) -> None:
        pass


class AutoLayoutConfig(SceneConfig):
    auto_config: AutoConfig


class AutoLayout(Scene[AutoLayoutConfig]):
    def get_children(self) -> list[ChildrenAction]:
        auto = self.config.auto_config
        layout = _weighted_choice(self.rng, ["grid", "bsp"], [auto.layout.grid, auto.layout.bsp])

        def room_children(tag: str) -> list[ChildrenAction]:
            return [
                ChildrenAction(
                    scene=AutoSymmetry.Config(auto_config=auto),
                    where=AreaWhere(tags=[tag]),
                ),
                ChildrenAction(
                    scene=RandomObjects.Config(object_ranges=auto.room_objects),
                    where=AreaWhere(tags=[tag]),
                ),
            ]

        if layout == "grid":
            return [
                ChildrenAction(
                    scene=RoomGrid.Config(
                        rows=auto.grid.rows.sample(self.rng),
                        columns=auto.grid.columns.sample(self.rng),
                        border_width=0,
                        children=room_children("room"),
                    ),
                    where="full",
                )
            ]
        return [
            ChildrenAction(
                scene=BSPLayout.Config(
                    area_count=auto.bsp.area_count.sample(self.rng),
                    children=room_children("zone"),
                ),
                where="full",
            )
        ]

    def render(self) -> None:
        pass


class AutoSymmetryConfig(SceneConfig):
    auto_config: AutoConfig


class AutoSymmetry(Scene[AutoSymmetryConfig]):
    def get_children(self) -> list[ChildrenAction]:
        sym_cfg = self.config.auto_config.room_symmetry
        symmetry = _weighted_choice(
            self.rng,
            ["none", "horizontal", "vertical", "x4"],
            [sym_cfg.none, sym_cfg.horizontal, sym_cfg.vertical, sym_cfg.x4],
        )
        scene: SceneConfig = RandomScene.Config(candidates=self.config.auto_config.content)
        if symmetry != "none":
            scene = Mirror.Config(scene=scene, symmetry=symmetry)
        return [ChildrenAction(scene=scene, where="full")]

    def render(self) -> None:
        pass
