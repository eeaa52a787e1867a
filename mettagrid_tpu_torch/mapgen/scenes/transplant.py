"""Transplant a pre-rendered scene tree onto this area
(reference: mapgen/scenes/transplant_scene.py).

Used by MapGen's prebuilt-instance path: an instance rendered on a temporary
grid (to discover its size / agent count) is salvaged — scene tree included —
onto the final multi-instance grid.
"""

from __future__ import annotations

import copy

from pydantic import ConfigDict, Field

from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig


class TransplantSceneConfig(SceneConfig):
    model_config = ConfigDict(arbitrary_types_allowed=True)

    # The already-rendered scene to transplant (excluded from serialization).
    scene: Scene = Field(exclude=True)


class TransplantScene(Scene[TransplantSceneConfig]):
    def render(self) -> None:
        src = self.config.scene
        if self.width != src.area.width or self.height != src.area.height:
            raise ValueError(
                "TransplantScene requires a target area with the same width/height as the source scene"
            )
        scene_copy = copy.deepcopy(src)
        scene_copy.transplant_to_grid(
            self.area.outer_grid,
            self.area.x - src.area.x,
            self.area.y - src.area.y,
        )
        self.children.append(scene_copy)
