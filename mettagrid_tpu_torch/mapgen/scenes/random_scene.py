"""Pick one of several candidate scenes by weight
(reference: mapgen/scenes/random_scene.py)."""

from __future__ import annotations

from pydantic import Field

from mettagrid_tpu_torch.base_config import Config
from mettagrid_tpu_torch.mapgen.scene import AnySceneConfig, ChildrenAction, Scene, SceneConfig


class RandomSceneCandidate(Config):
    scene: AnySceneConfig
    weight: float = 1.0


class RandomSceneConfig(SceneConfig):
    candidates: list[RandomSceneCandidate] = Field(default_factory=list)


class RandomScene(Scene[RandomSceneConfig]):
    def get_children(self) -> list[ChildrenAction]:
        weights = [c.weight for c in self.config.candidates]
        total = sum(weights)
        probs = [w / total for w in weights]
        idx = int(self.rng.choice(len(probs), p=probs))
        return [ChildrenAction(scene=self.config.candidates[idx].scene, where="full")]

    def render(self) -> None:
        pass
