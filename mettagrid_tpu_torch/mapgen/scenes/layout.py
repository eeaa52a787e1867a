"""Layout scene: carve fixed-size tagged areas at anchored positions
(reference: mapgen/scenes/layout.py)."""

from __future__ import annotations

from typing import Literal, Optional

from pydantic import Field

from mettagrid_tpu_torch.base_config import Config
from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig

Anchor = Literal["center", "top-left", "top-right", "bottom-left", "bottom-right"]


class LayoutArea(Config):
    width: int
    height: int
    placement: Anchor = "center"
    tag: str = "zone"


class LayoutConfig(SceneConfig):
    areas: list[LayoutArea] = Field(default_factory=list)


class Layout(Scene[LayoutConfig]):
    def render(self) -> None:
        for spec in self.config.areas:
            w, h = min(spec.width, self.width), min(spec.height, self.height)
            if spec.placement == "center":
                x, y = (self.width - w) // 2, (self.height - h) // 2
            elif spec.placement == "top-left":
                x, y = 0, 0
            elif spec.placement == "top-right":
                x, y = self.width - w, 0
            elif spec.placement == "bottom-left":
                x, y = 0, self.height - h
            else:
                x, y = self.width - w, self.height - h
            self.make_area(x, y, w, h, tags=[spec.tag])
