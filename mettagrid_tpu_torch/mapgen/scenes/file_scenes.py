"""Scenes loaded from external files: ASCII maps, YAML scene configs, and the
bundled dungeon-pattern library
(reference: mapgen/scenes/{ascii,yaml,random_yaml_scene,random_dcss_scene}.py).
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional

import numpy as np
import yaml as _yaml
from pydantic import model_validator

from mettagrid_tpu_torch.base_config import Config
from mettagrid_tpu_torch.maps.ascii import AsciiMapBuilder
from mettagrid_tpu_torch.mapgen.scene import ChildrenAction, Scene, SceneConfig
from mettagrid_tpu_torch.mapgen.scenes.inline_ascii import InlineAscii


class AsciiConfig(SceneConfig):
    uri: str


class Ascii(Scene[AsciiConfig]):
    """Render an ASCII map file (YAML AsciiMapBuilder config) into this area
    (reference: mapgen/scenes/ascii.py)."""

    def post_init(self) -> None:
        ascii_config = AsciiMapBuilder.Config.from_uri(self.config.uri)
        self.ascii_data = "\n".join("".join(line) for line in ascii_config.map_data)
        self.char_to_map_name = ascii_config.char_to_map_name

    def get_children(self) -> list[ChildrenAction]:
        return [
            ChildrenAction(
                scene=InlineAscii.Config(data=self.ascii_data, char_to_map_name=self.char_to_map_name),
                where="full",
            )
        ]

    def render(self) -> None:
        pass

    @classmethod
    def intrinsic_size(cls, config: AsciiConfig) -> Optional[tuple[int, int]]:
        config = cls.Config.model_validate(config)
        ascii_config = AsciiMapBuilder.Config.from_uri(config.uri)
        return ascii_config.height, ascii_config.width


class YamlSceneConfig(SceneConfig):
    file: str


class YamlScene(Scene[YamlSceneConfig]):
    """Load a full scene config from a YAML file and render it over this area
    (reference: mapgen/scenes/yaml.py)."""

    def get_children(self) -> list[ChildrenAction]:
        with open(self.config.file, "r") as fh:
            scene = SceneConfig.model_validate(_yaml.safe_load(fh))
        return [ChildrenAction(scene=scene, where="full")]

    def render(self) -> None:
        pass


class RandomYamlSceneCandidate(Config):
    scene_file: str
    weight: float = 1


class RandomYamlSceneConfig(SceneConfig):
    candidates: list[RandomYamlSceneCandidate]


class RandomYamlScene(Scene[RandomYamlSceneConfig]):
    """Pick one YAML scene file by weight (reference: mapgen/scenes/random_yaml_scene.py)."""

    def get_children(self) -> list[ChildrenAction]:
        weights = np.array([c.weight for c in self.config.candidates], dtype=np.float32)
        weights /= weights.sum()
        idx = int(self.rng.choice(len(self.config.candidates), p=weights))
        return [
            ChildrenAction(
                scene=YamlScene.Config(file=self.config.candidates[idx].scene_file),
                where="full",
            )
        ]

    def render(self) -> None:
        pass


_DUNGEON_ROOT = os.path.join(os.path.dirname(__file__), "dungeon_patterns")


class RandomDungeonSceneConfig(SceneConfig):
    """Pick a random pattern-synthesis scene from the bundled dungeon library.

    Mirrors the reference's DCSS-derived scene pool
    (reference: mapgen/scenes/random_dcss_scene.py) with original bundled
    patterns; point `root` at a directory produced by
    `mettagrid_tpu_torch.mapgen.tools.dungeon_import` for larger libraries.
    """

    wfc: bool = True
    convchain: bool = True
    root: Optional[str] = None

    @model_validator(mode="after")
    def _validate(self) -> "RandomDungeonSceneConfig":
        if not self.wfc and not self.convchain:
            raise ValueError("At least one of wfc/convchain must be true")
        return self


class RandomDungeonScene(Scene[RandomDungeonSceneConfig]):
    def get_children(self) -> list[ChildrenAction]:
        root = self.config.root or _DUNGEON_ROOT
        candidates: list[RandomYamlSceneCandidate] = []
        if self.config.wfc:
            for f in sorted(glob(os.path.join(root, "wfc", "*.yaml"))):
                candidates.append(RandomYamlSceneCandidate(scene_file=f))
        if self.config.convchain:
            for f in sorted(glob(os.path.join(root, "convchain", "*.yaml"))):
                candidates.append(RandomYamlSceneCandidate(scene_file=f))
        if not candidates:
            raise ValueError(f"No pattern candidates found under {root}")
        return [
            ChildrenAction(scene=RandomYamlScene.Config(candidates=candidates), where="full")
        ]

    def render(self) -> None:
        pass


# Alias matching the reference class name for config-file compatibility.
RandomDcssScene = RandomDungeonScene
