"""Compound bases: symmetric hub structures with extractors, stations, spawn
pads, and gated walls (reference: mapgen/scenes/compound.py), plus the
four-corner-compounds composition (reference: mapgen/scenes/four_corner_compounds.py).

Layouts:
- "default": plus-shaped corridors, hub at center, corner extractors,
  ring-expanded spawn pads.
- "tight": L-shaped exits, compact core with a gated perimeter wall.
- "cramped_room" / "service_pass_room": fixed kitchen-style floorplans with
  station anchors (Overcooked-inspired geometry, independently drawn).
"""

from __future__ import annotations

from typing import Literal, Sequence

import numpy as np
from pydantic import Field

from mettagrid_tpu_torch.mapgen.area import AreaWhere
from mettagrid_tpu_torch.mapgen.scene import ChildrenAction, Scene, SceneConfig

DEFAULT_EXTRACTORS: tuple[str, str, str, str] = (
    "carbon_extractor",
    "oxygen_extractor",
    "germanium_extractor",
    "silicon_extractor",
)

# Fixed station anchors / spawns for the kitchen floorplans, (x, y) within a
# 17x13 template placed at the bottom-right of the hub region.
CRAMPED_ROOM_STATION_ANCHORS: tuple[tuple[int, int], ...] = (
    (3, 3), (5, 3), (11, 5), (7, 3), (9, 3), (11, 3), (9, 7), (11, 7), (7, 7),
)
CRAMPED_ROOM_SPAWNS: tuple[tuple[int, int], ...] = ((6, 5), (8, 5), (6, 6), (8, 6))

SERVICE_PASS_ROOM_STATION_ANCHORS: tuple[tuple[int, int], ...] = (
    (3, 2), (8, 2), (12, 10), (5, 5), (10, 5), (13, 2), (8, 10), (15, 8), (1, 4),
)
SERVICE_PASS_ROOM_SPAWNS: tuple[tuple[int, int], ...] = ((6, 6), (10, 6), (6, 8), (10, 8))

_TEMPLATE_W, _TEMPLATE_H = 17, 13


class CompoundConfig(SceneConfig):
    hub_object: str = "hub"
    corner_generator: str | None = None
    spawn_symbol: str = "agent.agent"
    spawn_count: int | None = None
    hub_width: int = 21
    hub_height: int = 21
    include_inner_wall: bool = True
    outer_clearance: int = 3
    # Corner objects (TL, TR, BL, BR); explicit list wins over bundle.
    corner_objects: list[str] | None = None
    corner_bundle: Literal["extractors", "none", "custom"] = "extractors"
    cross_objects: list[str] | None = None
    cross_bundle: Literal["none", "extractors", "custom"] = "none"
    cross_distance: int = 4
    layout: Literal["default", "tight", "cramped_room", "service_pass_room"] = "default"
    randomize_spawn_positions: bool = False
    stations: list[str] = []
    # Explicit (dx, dy) offsets from hub center, one per station; overrides
    # the default row placement.
    station_offsets: list[tuple[int, int]] | None = Field(default=None)


class Compound(Scene[CompoundConfig]):
    def render(self) -> None:
        cfg = self.config
        full_grid, full_h, full_w = self.grid, self.height, self.width

        hub_w = max(7, min(cfg.hub_width, full_w))
        hub_h = max(7, min(cfg.hub_height, full_h))
        x0 = (full_w - hub_w) // 2
        y0 = (full_h - hub_h) // 2

        clearance = max(0, int(cfg.outer_clearance))
        if clearance > 0:
            full_grid[
                max(0, y0 - clearance) : min(full_h, y0 + hub_h + clearance),
                max(0, x0 - clearance) : min(full_w, x0 + hub_w + clearance),
            ] = "empty"

        hub = full_grid[y0 : y0 + hub_h, x0 : x0 + hub_w]
        hub[:] = "empty"
        cx, cy = hub_w // 2, hub_h // 2

        if cfg.include_inner_wall and hub_h >= 3 and hub_w >= 3:
            hub[0, :] = "wall"
            hub[-1, :] = "wall"
            hub[:, 0] = "wall"
            hub[:, -1] = "wall"
            g = 2  # gate half-width
            for row in (0, 1, hub_h - 2, hub_h - 1):
                hub[row, cx - g : cx + g + 1] = "empty"
            for col in (0, 1, hub_w - 2, hub_w - 1):
                hub[cy - g : cy + g + 1, col] = "empty"

        # Render the chosen layout against the hub sub-grid.
        saved = (self.grid, self.height, self.width)
        try:
            self.grid, self.height, self.width = hub, hub_h, hub_w
            if cfg.layout == "tight":
                self._render_tight(cx, cy)
            elif cfg.layout == "cramped_room":
                self._render_kitchen(CRAMPED_ROOM_STATION_ANCHORS, CRAMPED_ROOM_SPAWNS, self._draw_cramped_walls)
            elif cfg.layout == "service_pass_room":
                self._render_kitchen(
                    SERVICE_PASS_ROOM_STATION_ANCHORS, SERVICE_PASS_ROOM_SPAWNS, self._draw_service_walls
                )
            else:
                self._render_default(cx, cy)
        finally:
            self.grid, self.height, self.width = saved

    # -- shared helpers (operate on the hub sub-grid) ------------------------

    def _place_spawn_pads(self, positions: Sequence[tuple[int, int]]) -> None:
        for x, y in positions:
            if 1 <= x < self.width - 1 and 1 <= y < self.height - 1 and self.grid[y, x] == "empty":
                self.grid[y, x] = self.config.spawn_symbol

    def _random_spawn_positions(
        self, count: int, min_x: int = 1, min_y: int = 1, max_x: int | None = None, max_y: int | None = None
    ) -> list[tuple[int, int]]:
        min_x, min_y = max(1, min_x), max(1, min_y)
        max_x = self.width - 1 if max_x is None else min(self.width - 1, max_x)
        max_y = self.height - 1 if max_y is None else min(self.height - 1, max_y)
        if min_x >= max_x or min_y >= max_y:
            return []
        interior = self.grid[min_y:max_y, min_x:max_x]
        ys, xs = np.where(interior == "empty")
        count = min(count, len(xs))
        idx = self.rng.choice(len(xs), size=count, replace=False)
        return [(int(xs[i]) + min_x, int(ys[i]) + min_y) for i in idx]

    def _fill_missing_spawns(self, positions: Sequence[tuple[int, int]], desired: int) -> list[tuple[int, int]]:
        if desired <= 0:
            return []
        seen: set[tuple[int, int]] = set()
        valid: list[tuple[int, int]] = []

        def consider(pos: tuple[int, int]) -> None:
            if pos in seen:
                return
            seen.add(pos)
            x, y = pos
            if 1 <= x < self.width - 1 and 1 <= y < self.height - 1 and self.grid[y, x] == "empty":
                valid.append(pos)

        for pos in positions:
            if len(valid) >= desired:
                return valid
            consider(pos)
        for pos in self._random_spawn_positions(desired):
            if len(valid) >= desired:
                break
            consider(pos)
        return valid

    def _place_stations(self, cx: int, cy: int, base_y: int) -> None:
        """Stations in a compressed row centered at cx near base_y, or at
        explicit offsets from the hub center."""
        stations = self.config.stations
        if not stations:
            return
        grid, h, w = self.grid, self.height, self.width
        offsets = self.config.station_offsets
        if offsets is not None:
            if len(offsets) != len(stations):
                raise ValueError(
                    f"Expected {len(stations)} station offsets, got {len(offsets)}"
                )
            for name, (dx, dy) in zip(stations, offsets):
                x, y = cx + int(dx), cy + int(dy)
                if not (1 <= x < w - 1 and 1 <= y < h - 1):
                    raise ValueError(f"Station {name!r} at ({x},{y}) is out of bounds")
                if grid[y, x] != "empty":
                    raise ValueError(f"Station {name!r} at ({x},{y}): tile occupied by {grid[y, x]!r}")
                grid[y, x] = name
            return

        n = len(stations)
        interior_w = max(1, w - 2)
        spacing = 1 if n <= 1 else min(2, max(1, (interior_w - 1) // (n - 1)))
        row_span = 1 + (n - 1) * spacing if n > 1 else 1
        start_x = cx - row_span // 2
        for i, name in enumerate(stations):
            x = start_x + i * spacing
            if not (1 <= x < w - 1):
                raise ValueError(f"Station {name!r} does not fit in hub width {w}")
            placed = False
            for dy in range(max(h, w)):
                for try_y in (base_y + dy, base_y - dy):
                    if 1 <= try_y < h - 1 and grid[try_y, x] == "empty":
                        grid[try_y, x] = name
                        placed = True
                        break
                if placed:
                    break
            if not placed:
                raise ValueError(f"No empty position for station {name!r} at x={x}")

    def _corner_names(self) -> list[str]:
        cfg = self.config
        if cfg.corner_objects and len(cfg.corner_objects) == 4:
            return list(cfg.corner_objects)
        if cfg.corner_generator:
            return [cfg.corner_generator] * 4
        if cfg.corner_bundle == "extractors":
            return list(DEFAULT_EXTRACTORS)
        return []

    def _cross_names(self) -> list[str]:
        cfg = self.config
        if cfg.cross_objects and len(cfg.cross_objects) == 4:
            return list(cfg.cross_objects)
        if cfg.cross_bundle == "extractors":
            return list(DEFAULT_EXTRACTORS)
        return []

    def _cross_positions(self, cx: int, cy: int) -> list[tuple[int, int]]:
        d = max(1, self.config.cross_distance)
        return [(cx, cy - d), (cx + d, cy), (cx, cy + d), (cx - d, cy)]

    def _place_named(self, positions: Sequence[tuple[int, int]], names: Sequence[str]) -> None:
        if names and len(names) != len(positions):
            raise ValueError(f"Expected {len(positions)} names, got {len(names)}")
        for (x, y), name in zip(positions, names):
            if name and 0 <= x < self.width and 0 <= y < self.height:
                self.grid[y, x] = name

    def _desired_spawns(self, default: int = 4) -> int:
        cfg = self.config
        return max(0, int(cfg.spawn_count)) if cfg.spawn_count is not None else default

    # -- layouts -------------------------------------------------------------

    def _render_default(self, cx: int, cy: int) -> None:
        grid, h, w = self.grid, self.height, self.width
        cfg = self.config
        half = 2  # corridor half-width (5-wide plus)

        grid[1 : h - 1, max(1, cx - half) : min(w - 1, cx + half + 1)] = "empty"
        grid[max(1, cy - half) : min(h - 1, cy + half + 1), 1 : w - 1] = "empty"

        if 1 <= cx < w - 1 and 1 <= cy < h - 1:
            grid[cy, cx] = cfg.hub_object
            self._place_stations(cx, cy, cy + 4)

        desired = self._desired_spawns()
        if cfg.randomize_spawn_positions:
            valid = self._random_spawn_positions(desired)
        else:
            valid = []
            for sx, sy in [(cx, cy - 2), (cx + 2, cy), (cx, cy + 2), (cx - 2, cy)]:
                if len(valid) >= desired:
                    break
                if 0 <= sx < w and 0 <= sy < h and grid[sy, sx] == "empty":
                    valid.append((sx, sy))
            radius = 3
            while len(valid) < desired and radius < max(h, w):
                for sx, sy in [
                    (cx + radius, cy), (cx - radius, cy), (cx, cy + radius), (cx, cy - radius),
                    (cx + radius, cy + radius), (cx + radius, cy - radius),
                    (cx - radius, cy + radius), (cx - radius, cy - radius),
                ]:
                    if len(valid) >= desired:
                        break
                    if 0 <= sx < w and 0 <= sy < h and grid[sy, sx] == "empty":
                        valid.append((sx, sy))
                radius += 1
        self._place_spawn_pads(valid[:desired])

        corner_positions = [(2, 2), (w - 3, 2), (2, h - 3), (w - 3, h - 3)]
        names = self._corner_names()
        if names:
            if len(names) != 4:
                raise ValueError(f"Expected 4 corner names, got {len(names)}")
            for (x, y), name in zip(corner_positions, names):
                if name and 1 <= x < w - 1 and 1 <= y < h - 1:
                    grid[y, x] = name

        cross = self._cross_names()
        if cross:
            self._place_named(self._cross_positions(cx, cy), cross)

    def _render_tight(self, cx: int, cy: int) -> None:
        grid, h, w = self.grid, self.height, self.width
        cfg = self.config

        self._carve_L(1, 1, "right-down")
        self._carve_L(w - 4, 1, "left-down")
        self._carve_L(1, h - 4, "right-up")
        self._carve_L(w - 4, h - 4, "left-up")

        core_radius = 3
        grid[
            max(0, cy - core_radius) : min(h, cy + core_radius + 1),
            max(0, cx - core_radius) : min(w, cx + core_radius + 1),
        ] = "empty"

        placed: list[tuple[int, int]] = []

        def place(x: int, y: int, name: str) -> None:
            if 1 <= x < w - 1 and 1 <= y < h - 1 and grid[y, x] == "empty":
                grid[y, x] = name
                placed.append((x, y))

        place(cx, cy, cfg.hub_object)
        names = self._corner_names()
        if names:
            if len(names) != 4:
                raise ValueError(f"Expected 4 corner names, got {len(names)}")
            for (x, y), name in zip(
                [(cx - 2, cy - 2), (cx + 2, cy - 2), (cx - 2, cy + 2), (cx + 2, cy + 2)], names
            ):
                if name:
                    place(x, y, name)
        cross = self._cross_names()
        if cross:
            self._place_named(self._cross_positions(cx, cy), cross)

        # One-cell clearance halo around every placed building.
        for x, y in placed:
            for nx in range(max(0, x - 1), min(w, x + 2)):
                for ny in range(max(0, y - 1), min(h, y + 2)):
                    if (nx, ny) != (x, y):
                        grid[ny, nx] = "empty"

        perimeter_radius = core_radius + 1
        self._build_perimeter(cx, cy, perimeter_radius, gate_half=2)
        self._place_stations(cx, cy, cy - 2)

        desired = self._desired_spawns()
        if cfg.randomize_spawn_positions:
            valid = self._random_spawn_positions(desired)
        else:
            d = perimeter_radius + 1
            positions = [(cx, cy - d), (cx + d, cy), (cx, cy + d), (cx - d, cy)]
            step = max(1, (2 * perimeter_radius + 1) // 4)
            if len(positions) < desired:
                for dx in range(-perimeter_radius, perimeter_radius + 1, step):
                    positions += [(cx + dx, cy - d), (cx + dx, cy + d)]
                for dy in range(-perimeter_radius, perimeter_radius + 1, step):
                    positions += [(cx - d, cy + dy), (cx + d, cy + dy)]
            valid = self._fill_missing_spawns(positions[:desired], desired)
        self._place_spawn_pads(valid)

    def _render_kitchen(self, anchors, spawns, draw_walls) -> None:
        grid, h, w = self.grid, self.height, self.width
        cfg = self.config
        if h < _TEMPLATE_H or w < _TEMPLATE_W:
            raise ValueError(
                f"{cfg.layout} layout requires at least {_TEMPLATE_W}x{_TEMPLATE_H}, got hub size {w}x{h}"
            )
        if len(cfg.stations) != len(anchors):
            raise ValueError(
                f"{cfg.layout} layout expects exactly {len(anchors)} stations, got {len(cfg.stations)}"
            )
        ox = max(0, w - _TEMPLATE_W)
        oy = max(0, h - _TEMPLATE_H)
        grid[:] = "empty"
        draw_walls(ox, oy)
        for name, (ax, ay) in zip(cfg.stations, anchors):
            grid[oy + ay, ox + ax] = name

        spawn_positions = [(ox + x, oy + y) for x, y in spawns]
        desired = self._desired_spawns(len(spawn_positions))
        if cfg.randomize_spawn_positions:
            valid = self._random_spawn_positions(
                desired, min_x=ox + 1, min_y=oy + 1, max_x=ox + _TEMPLATE_W - 1, max_y=oy + _TEMPLATE_H - 1
            )
        else:
            valid = self._fill_missing_spawns(spawn_positions, desired)
        self._place_spawn_pads(valid[:desired])

    def _draw_cramped_walls(self, ox: int, oy: int) -> None:
        grid = self.grid
        grid[oy + 3, ox + 2 : ox + 13] = "wall"   # top prep counter
        grid[oy + 7, ox + 6 : ox + 13] = "wall"   # bottom service counter
        grid[oy + 3 : oy + 8, ox + 12] = "wall"   # right dish/serve spine
        grid[oy + 4, ox + 11] = "wall"
        grid[oy + 6, ox + 11] = "wall"

    def _draw_service_walls(self, ox: int, oy: int) -> None:
        grid = self.grid
        grid[oy + 2, ox + 2 : ox + 14] = "wall"       # long top prep run
        grid[oy + 3 : oy + 8, ox + 1] = "wall"        # left order-board spine
        grid[oy + 5, ox + 4 : ox + 7] = "wall"        # prep island
        grid[oy + 5, ox + 9 : ox + 12] = "wall"       # cook island
        grid[oy + 10, ox + 6 : ox + 14] = "wall"      # bottom service pass
        grid[oy + 3 : oy + 10, ox + 15] = "wall"      # right wash spine
        grid[oy + 5, ox + 14] = "wall"
        grid[oy + 7, ox + 14] = "wall"

    def _build_perimeter(self, cx: int, cy: int, radius: int, gate_half: int) -> None:
        if radius <= 0:
            return
        grid, h, w = self.grid, self.height, self.width
        for x in range(cx - radius, cx + radius + 1):
            for y in range(cy - radius, cy + radius + 1):
                if not (0 <= x < w and 0 <= y < h):
                    continue
                on_perimeter = max(abs(x - cx), abs(y - cy)) == radius
                on_gate = (abs(x - cx) <= gate_half and abs(y - cy) == radius) or (
                    abs(y - cy) <= gate_half and abs(x - cx) == radius
                )
                if on_perimeter and not on_gate:
                    grid[y, x] = "wall"

    def _carve_L(self, x: int, y: int, orientation: str) -> None:
        grid, h, w = self.grid, self.height, self.width
        width = 5
        leg = max(3, min(h, w) // 3)

        def carve(x0: int, y0: int, cw: int, ch: int) -> None:
            x1, y1 = max(0, x0), max(0, y0)
            x2, y2 = min(w, x0 + cw), min(h, y0 + ch)
            if x2 > x1 and y2 > y1:
                grid[y1:y2, x1:x2] = "empty"

        if orientation == "right-down":
            carve(x, y, leg, width)
            carve(x + leg - width, y, width, leg)
            carve(x, 0, width, 1)
        elif orientation == "left-down":
            carve(x - leg + width, y, leg, width)
            carve(x - leg + width, y, width, leg)
            carve(x - width + 1, 0, width, 1)
        elif orientation == "right-up":
            carve(x, y, leg, width)
            carve(x + leg - width, y - leg + width, width, leg)
            carve(0, y - width + 1, width, width)
        elif orientation == "left-up":
            carve(x - leg + width, y, leg, width)
            carve(x - leg + width, y - leg + width, width, leg)
            carve(x - width + 1, h - 1, width, 1)


class FourCornerCompoundsConfig(SceneConfig):
    """Place 1-4 compounds at the corners of the map (TL, TR, BL, BR)."""

    compound: CompoundConfig = Field(default_factory=CompoundConfig)
    num_compounds: int = Field(default=4, ge=1, le=4)
    spawn_count: int = 8
    hub_objects: list[str] | None = None
    stations_per_compound: list[list[str]] | None = None
    spawn_symbols: list[str] | None = None


class FourCornerCompounds(Scene[FourCornerCompoundsConfig]):
    def render(self) -> None:
        h, w = self.height, self.width
        half_w, half_h = w // 2, h // 2
        quadrants = [
            (0, 0, half_w, half_h),
            (half_w, 0, w - half_w, half_h),
            (0, half_h, half_w, h - half_h),
            (half_w, half_h, w - half_w, h - half_h),
        ]
        for i in range(self.config.num_compounds):
            x, y, qw, qh = quadrants[i]
            self.make_area(x, y, qw, qh, tags=[f"corner_{i}"])

    def get_children(self) -> list[ChildrenAction]:
        cfg = self.config
        children: list[ChildrenAction] = []
        for i in range(cfg.num_compounds):
            updates: dict = {"spawn_count": cfg.spawn_count}
            if cfg.hub_objects and i < len(cfg.hub_objects):
                updates["hub_object"] = cfg.hub_objects[i]
            if cfg.stations_per_compound and i < len(cfg.stations_per_compound):
                updates["stations"] = cfg.stations_per_compound[i]
            if cfg.spawn_symbols and i < len(cfg.spawn_symbols):
                updates["spawn_symbol"] = cfg.spawn_symbols[i]
            children.append(
                ChildrenAction(
                    scene=cfg.compound.model_copy(deep=True, update=updates),
                    where=AreaWhere(tags=[f"corner_{i}"]),
                    limit=1,
                    order_by="first",
                )
            )
        return children
