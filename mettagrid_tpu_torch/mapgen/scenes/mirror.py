"""Mirror scene: render a child on one half, reflect onto the other
(reference: mapgen/scenes/mirror.py)."""

from __future__ import annotations

from typing import Literal

import numpy as np

from mettagrid_tpu_torch.mapgen.scene import AnySceneConfig, Scene, SceneConfig


class MirrorConfig(SceneConfig):
    scene: AnySceneConfig
    symmetry: Literal["horizontal", "vertical", "x4"] = "horizontal"


class Mirror(Scene[MirrorConfig]):
    def render(self) -> None:
        sym = self.config.symmetry
        H, W = self.height, self.width
        if sym == "horizontal":
            half_w = (W + 1) // 2
            sub = self.make_area(0, 0, half_w, H)
            child = self.config.scene.create_as_child(self, sub)
            self.children.append(child)
            child.render_with_children()
            self.grid[:, W - half_w :] = np.flip(self.grid[:, :half_w], axis=1)
        elif sym == "vertical":
            half_h = (H + 1) // 2
            sub = self.make_area(0, 0, W, half_h)
            child = self.config.scene.create_as_child(self, sub)
            self.children.append(child)
            child.render_with_children()
            self.grid[H - half_h :, :] = np.flip(self.grid[:half_h, :], axis=0)
        else:  # x4
            half_w, half_h = (W + 1) // 2, (H + 1) // 2
            sub = self.make_area(0, 0, half_w, half_h)
            child = self.config.scene.create_as_child(self, sub)
            self.children.append(child)
            child.render_with_children()
            self.grid[:half_h, W - half_w :] = np.flip(self.grid[:half_h, :half_w], axis=1)
            self.grid[H - half_h :, :] = np.flip(self.grid[:half_h, :], axis=0)
