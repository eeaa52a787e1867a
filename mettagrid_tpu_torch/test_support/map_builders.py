"""Literal-grid map builder for tests
(reference: mettagrid_tpu/test_support/map_builders.py)."""

from __future__ import annotations

import numpy as np

from mettagrid_tpu_torch.maps.map_builder import GameMap, MapBuilder, MapBuilderConfig
from mettagrid_tpu_torch.maps.types import map_grid_dtype


class ObjectNameMapBuilderConfig(MapBuilderConfig["ObjectNameMapBuilder"]):
    """Map given directly as a grid of map_name strings."""

    map_data: list[list[str]]


class ObjectNameMapBuilder(MapBuilder[ObjectNameMapBuilderConfig]):
    Config = ObjectNameMapBuilderConfig

    def build(self) -> GameMap:
        return GameMap(np.array(self.config.map_data, dtype=map_grid_dtype))
