"""Binary space partitioning: dungeon rooms + corridors
(reference: mapgen/scenes/bsp.py — same capability, fresh implementation)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig


@dataclass
class _Zone:
    x: int
    y: int
    w: int
    h: int
    left: Optional["_Zone"] = None
    right: Optional["_Zone"] = None
    room: Optional[tuple[int, int, int, int]] = None  # x, y, w, h

    def leaves(self) -> list["_Zone"]:
        if self.left is None:
            return [self]
        return self.left.leaves() + self.right.leaves()


def _split(zone: _Zone, count: int, rng: np.random.Generator, min_size: int = 3) -> None:
    """Split recursively until the tree has `count` leaves."""
    leaves = [zone]
    while len(leaves) < count:
        # Split the largest splittable leaf.
        leaves.sort(key=lambda z: z.w * z.h, reverse=True)
        for z in leaves:
            horiz = z.w < z.h if z.w != z.h else bool(rng.integers(2))
            extent = z.h if horiz else z.w
            if extent < 2 * min_size:
                continue
            cut = int(rng.integers(min_size, extent - min_size + 1))
            if horiz:
                z.left = _Zone(z.x, z.y, z.w, cut)
                z.right = _Zone(z.x, z.y + cut, z.w, z.h - cut)
            else:
                z.left = _Zone(z.x, z.y, cut, z.h)
                z.right = _Zone(z.x + cut, z.y, z.w - cut, z.h)
            leaves.remove(z)
            leaves.extend([z.left, z.right])
            break
        else:
            break  # nothing splittable


class BSPLayoutConfig(SceneConfig):
    area_count: int = 4


class BSPLayout(Scene[BSPLayoutConfig]):
    """Pure layout: partitions the area into `area_count` zones tagged "zone"."""

    def render(self) -> None:
        root = _Zone(0, 0, self.width, self.height)
        _split(root, self.config.area_count, self.rng)
        for z in root.leaves():
            self.make_area(z.x, z.y, z.w, z.h, tags=["zone"])


class BSPConfig(SceneConfig):
    rooms: int = 4
    min_room_size: int = 3
    min_room_size_ratio: float = 0.4
    max_room_size_ratio: float = 0.9
    skip_corridors: bool = False


class BSP(Scene[BSPConfig]):
    """Roguelike dungeon: walls everywhere, a room per BSP leaf, L-shaped
    corridors between sibling rooms."""

    def render(self) -> None:
        cfg = self.config
        self.grid[:] = "wall"
        root = _Zone(0, 0, self.width, self.height)
        _split(root, cfg.rooms, self.rng, min_size=max(cfg.min_room_size + 1, 3))

        for z in root.leaves():
            max_w = max(int(z.w * cfg.max_room_size_ratio), cfg.min_room_size)
            min_w = max(int(z.w * cfg.min_room_size_ratio), cfg.min_room_size)
            max_h = max(int(z.h * cfg.max_room_size_ratio), cfg.min_room_size)
            min_h = max(int(z.h * cfg.min_room_size_ratio), cfg.min_room_size)
            rw = int(self.rng.integers(min_w, max(max_w, min_w) + 1))
            rh = int(self.rng.integers(min_h, max(max_h, min_h) + 1))
            rw, rh = min(rw, z.w), min(rh, z.h)
            rx = z.x + int(self.rng.integers(0, z.w - rw + 1))
            ry = z.y + int(self.rng.integers(0, z.h - rh + 1))
            z.room = (rx, ry, rw, rh)
            self.grid[ry : ry + rh, rx : rx + rw] = "empty"
            self.make_area(rx, ry, rw, rh, tags=["room"])

        if not cfg.skip_corridors:
            self._connect(root)

    def _room_center(self, z: _Zone) -> tuple[int, int]:
        rooms = [leaf.room for leaf in z.leaves() if leaf.room]
        rx, ry, rw, rh = rooms[len(rooms) // 2]
        return (rx + rw // 2, ry + rh // 2)

    def _connect(self, z: _Zone) -> None:
        if z.left is None:
            return
        self._connect(z.left)
        self._connect(z.right)
        (x1, y1), (x2, y2) = self._room_center(z.left), self._room_center(z.right)
        # L-shaped corridor, random elbow order
        if self.rng.integers(2):
            self.grid[y1, min(x1, x2) : max(x1, x2) + 1] = "empty"
            self.grid[min(y1, y2) : max(y1, y2) + 1, x2] = "empty"
        else:
            self.grid[min(y1, y2) : max(y1, y2) + 1, x1] = "empty"
            self.grid[y2, min(x1, x2) : max(x1, x2) + 1] = "empty"
