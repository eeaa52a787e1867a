"""Map areas: rectangular views into the shared map grid
(reference: python/src/mettagrid/mapgen/area.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Optional, Union

import numpy as np

from mettagrid_tpu_torch.base_config import Config


@dataclass
class Area:
    """A sub-rectangle of the outer map grid. `grid` is a live numpy view."""

    outer_grid: np.ndarray
    x: int
    y: int
    width: int
    height: int
    tags: list[str] = field(default_factory=list)

    @property
    def grid(self) -> np.ndarray:
        return self.outer_grid[self.y : self.y + self.height, self.x : self.x + self.width]

    @classmethod
    def root_area_from_grid(cls, grid: np.ndarray) -> "Area":
        return cls(outer_grid=grid, x=0, y=0, width=grid.shape[1], height=grid.shape[0])

    def make_subarea(
        self, x: int, y: int, width: int, height: int, tags: Optional[list[str]] = None
    ) -> "Area":
        if x + width > self.width or y + height > self.height:
            raise ValueError(
                f"Subarea at ({x},{y}) size {width}x{height} extends beyond parent {self.width}x{self.height}"
            )
        return Area(
            outer_grid=self.outer_grid,
            x=self.x + x,
            y=self.y + y,
            width=width,
            height=height,
            tags=tags or [],
        )

    def transplant_to_grid(self, grid: np.ndarray, shift_x: int, shift_y: int, copy_grid: bool) -> None:
        original = self.grid.copy() if copy_grid else None
        self.outer_grid = grid
        self.x += shift_x
        self.y += shift_y
        if copy_grid and original is not None:
            self.grid[:] = original


class AreaWhere(Config):
    tags: list[str] = []


class AreaQuery(Config):
    """Select child areas: filter by tags, order, paginate, lock
    (reference: mapgen/area.py:84-120)."""

    limit: Optional[int] = None
    offset: Optional[int] = None
    lock: Optional[str] = None
    where: Union[Literal["full"], AreaWhere, None] = None
    order_by: Literal["random", "first", "last"] = "random"
