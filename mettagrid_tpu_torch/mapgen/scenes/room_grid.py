"""Equal-sized isolated rooms grid (reference: mapgen/scenes/room_grid.py)."""

from __future__ import annotations

from typing import Optional

from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig


class RoomGridConfig(SceneConfig):
    rows: Optional[int] = None
    columns: Optional[int] = None
    layout: Optional[list[list[str]]] = None
    border_width: int = 5
    border_object: str = "wall"


class RoomGrid(Scene[RoomGridConfig]):
    """Tile the area with rows x columns rooms separated by border walls.
    Each room becomes an area tagged "room"/"room_{r}_{c}" (or the layout
    entry when a layout is given)."""

    def render(self) -> None:
        cfg = self.config
        if cfg.layout is not None:
            rows, cols = len(cfg.layout), len(cfg.layout[0])
            for row in cfg.layout:
                assert len(row) == cols, "layout rows must be equal length"
        else:
            assert cfg.rows and cfg.columns, "need layout or rows+columns"
            rows, cols = cfg.rows, cfg.columns

        room_w = (self.width - cfg.border_width * (cols - 1)) // cols
        room_h = (self.height - cfg.border_width * (rows - 1)) // rows
        self.grid[:] = cfg.border_object
        for r in range(rows):
            for c in range(cols):
                x = c * (room_w + cfg.border_width)
                y = r * (room_h + cfg.border_width)
                self.grid[y : y + room_h, x : x + room_w] = "empty"
                tags = [cfg.layout[r][c]] if cfg.layout is not None else ["room", f"room_{r}_{c}"]
                self.make_area(x, y, room_w, room_h, tags=tags)
