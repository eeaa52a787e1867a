"""Inline ASCII scene (reference: mapgen/scenes/inline_ascii.py)."""

from __future__ import annotations

import numpy as np
from pydantic import Field

from mettagrid_tpu_torch.maps.ascii_grid import merge_with_global_defaults
from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig


class InlineAsciiConfig(SceneConfig):
    data: str
    row: int = 0
    column: int = 0
    char_to_map_name: dict[str, str] = Field(default_factory=dict)


class InlineAscii(Scene[InlineAsciiConfig]):
    @classmethod
    def intrinsic_size(cls, config: InlineAsciiConfig) -> tuple[int, int] | None:
        config = cls.Config.model_validate(config)
        lines = [line for line in config.data.splitlines() if line]
        if not lines:
            return None
        return (
            len(lines) + config.row,
            max(len(line) for line in lines) + config.column,
        )

    def render(self) -> None:
        legend = merge_with_global_defaults(dict(self.config.char_to_map_name))
        lines = [line for line in self.config.data.splitlines() if line]
        if not lines:
            return
        h, w = len(lines), max(len(line) for line in lines)
        r0, c0 = self.config.row, self.config.column
        if r0 + h > self.height or c0 + w > self.width:
            raise ValueError(f"ASCII {w}x{h} at ({c0},{r0}) exceeds grid {self.width}x{self.height}")
        for i, line in enumerate(lines):
            for j, ch in enumerate(line):
                self.grid[r0 + i, c0 + j] = legend[ch]
