"""No-op scene (reference: mapgen/scenes/nop.py) — container for children."""

from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig


class NopConfig(SceneConfig):
    pass


class Nop(Scene[NopConfig]):
    def render(self) -> None:
        pass
