"""MapGen: the scene-graph map builder with multi-instance layout
(reference: python/src/mettagrid/mapgen/mapgen.py:19-130).

Renders one instance scene per compute-derived instance count, laid out in a
near-square grid separated by instance borders, wrapped in an outer border.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Union

import numpy as np
from pydantic import Field, field_validator

from mettagrid_tpu_torch.maps.map_builder import (
    AnyMapBuilderConfig,
    GameMap,
    HasSeed,
    MapBuilder,
    MapBuilderConfig,
)
from mettagrid_tpu_torch.maps.utils import create_grid
from mettagrid_tpu_torch.mapgen.area import Area
from mettagrid_tpu_torch.mapgen.scene import AnySceneConfig, GridTransform, SceneConfig, load_symbol

_TRANSPOSING_TRANSFORMS = (
    GridTransform.ROT_90,
    GridTransform.ROT_270,
    GridTransform.TRANSPOSE,
    GridTransform.TRANSPOSE_ALT,
)


class MapGenConfig(MapBuilderConfig["MapGen"]):
    # Outer border guarantees agents can't see beyond the map.
    border_width: int = Field(default=5, ge=0)
    seed: Optional[int] = Field(default=None, ge=0)

    # The per-instance scene (or nested MapBuilder config).
    instance: Any = Field(default=None)
    width: Optional[int] = Field(default=None, ge=0)
    height: Optional[int] = Field(default=None, ge=0)

    # Multi-instance: explicit count, or derived from num_agents.
    instances: Optional[int] = Field(default=None, ge=1)
    num_agents: Optional[int] = Field(default=None, ge=0)
    instance_border_width: int = Field(default=5, ge=0)
    instance_border_object: str = Field(default="wall")
    # Clear procedural walls within this many cells of instance boundaries.
    instance_border_clear_radius: int = Field(default=0, ge=0)
    set_team_by_instance: bool = Field(default=False)
    # Keep map spawn order deterministic instead of shuffling spawn indices.
    fixed_spawn_order: bool = Field(default=False)
    # Remap object symbols per instance, e.g. {"hub": "hub_{instance_id}"} or
    # "hub_{instance_name}" with `instance_names` set.
    instance_object_remap: dict[str, str] = Field(default_factory=dict)
    instance_names: Optional[list[str]] = Field(default=None)

    @field_validator("instance", mode="before")
    @classmethod
    def _validate_instance(cls, v: Any):
        if v is None or isinstance(v, (SceneConfig, MapBuilderConfig)):
            return v
        if isinstance(v, dict):
            t = v.get("type")
            if t is None:
                raise ValueError("instance dict requires a 'type' field")
            target = load_symbol(t) if isinstance(t, str) else t
            if isinstance(target, type) and issubclass(target, SceneConfig):
                return SceneConfig.model_validate(v)
            if isinstance(target, type) and issubclass(target, MapBuilderConfig):
                return MapBuilderConfig.model_validate(v)
            raise ValueError(f"Invalid instance type: {target!r}")
        raise ValueError(f"Invalid instance configuration: {v!r}")


class MapGen(MapBuilder[MapGenConfig]):
    Config = MapGenConfig

    def __init__(self, config: MapGenConfig):
        super().__init__(config)
        assert self.config.instance is not None, "instance is required"
        self._rng = np.random.default_rng(self.config.seed)

    def _instance_size(self) -> tuple[int, int]:
        cfg = self.config
        if isinstance(cfg.instance, MapBuilderConfig):
            probe = cfg.instance.create().build()
            return probe.grid.shape
        if cfg.width and cfg.height:
            return (cfg.height, cfg.width)
        # Scenes with a fixed natural size (ASCII data etc.) can be used
        # without explicit width/height (reference: mapgen.py:222-227).
        size = cfg.instance.scene_cls.intrinsic_size(cfg.instance)
        if not size:
            raise ValueError("width/height must be provided when the instance scene has no intrinsic size")
        if cfg.instance.transform in _TRANSPOSING_TRANSFORMS:
            size = size[::-1]
        return size

    def _count_agents_in_instance(self) -> int:
        grid = self._render_one_instance()
        return int(np.char.startswith(grid.astype(str), "agent").sum())

    def _render_one_instance(self) -> np.ndarray:
        cfg = self.config
        if isinstance(cfg.instance, MapBuilderConfig):
            instance = cfg.instance
            # A seeded MapGen seeds an unseeded builder instance from its own
            # stream, so its maps are a function of its seed. (The reference
            # builds such an instance from fresh entropy; ROADMAP Queue 3.)
            if cfg.seed is not None and isinstance(instance, HasSeed) and instance.seed is None:
                instance = instance.model_copy(update={"seed": int(self._rng.integers(2**31))})
            return instance.create().build().grid
        h, w = self._instance_size()
        grid = create_grid(h, w)
        area = Area.root_area_from_grid(grid)
        scene = cfg.instance.create_root(area, rng=np.random.default_rng(self._rng.integers(2**31)))
        scene.render_with_children()
        return grid

    def build(self) -> GameMap:
        cfg = self.config
        ih, iw = self._instance_size()

        instances = cfg.instances
        if instances is None and cfg.num_agents:
            per = self._count_agents_in_instance()
            if per <= 0:
                raise ValueError("num_agents set but the instance scene places no agents")
            if cfg.num_agents % per != 0:
                raise ValueError(f"num_agents={cfg.num_agents} not divisible by per-instance agents={per}")
            instances = cfg.num_agents // per
        instances = instances or 1

        cols = math.ceil(math.sqrt(instances))
        rows = math.ceil(instances / cols)
        ibw = cfg.instance_border_width if instances > 1 else 0
        inner_h = rows * ih + (rows - 1) * ibw
        inner_w = cols * iw + (cols - 1) * ibw
        bw = cfg.border_width
        grid = create_grid(inner_h + 2 * bw, inner_w + 2 * bw, fill_value=cfg.instance_border_object)
        grid[bw : bw + inner_h, bw : bw + inner_w] = cfg.instance_border_object

        if cfg.instance_names is not None and len(cfg.instance_names) != instances:
            raise ValueError(
                f"instance_names length ({len(cfg.instance_names)}) must match instances ({instances})"
            )

        for k in range(instances):
            r, c = divmod(k, cols)
            y = bw + r * (ih + ibw)
            x = bw + c * (iw + ibw)
            inst = self._render_one_instance()
            if cfg.set_team_by_instance:
                inst = inst.copy()
                mask = np.char.startswith(inst.astype(str), "agent")
                inst[mask] = f"agent.team_{k}"
            if cfg.instance_object_remap:
                inst = inst.copy()
                name = cfg.instance_names[k] if cfg.instance_names else str(k)
                for original, fmt in cfg.instance_object_remap.items():
                    inst[inst == original] = fmt.format(instance_id=k, instance_name=name)
            grid[y : y + ih, x : x + iw] = inst

        if cfg.instance_border_clear_radius > 0 and instances > 1:
            self._clear_instance_borders(grid, ih, iw, rows, cols)

        # Outer border walls
        if bw > 0:
            grid[:bw, :] = "wall"
            grid[-bw:, :] = "wall"
            grid[:, :bw] = "wall"
            grid[:, -bw:] = "wall"
        return GameMap(grid)

    def _clear_instance_borders(self, grid: np.ndarray, ih: int, iw: int, rows: int, cols: int) -> None:
        """Replace walls near instance boundaries with empty cells
        (reference: mapgen.py:475-508)."""
        cfg = self.config
        radius = cfg.instance_border_clear_radius
        bw = cfg.border_width
        ibw = cfg.instance_border_width
        gh, gw = grid.shape
        for row_idx in range(rows - 1):
            gap_start = bw + (row_idx + 1) * ih + row_idx * ibw
            r0 = max(bw, gap_start - radius)
            r1 = min(gh - bw, gap_start + ibw + radius)
            band = grid[r0:r1, bw : gw - bw]
            band[band == "wall"] = "empty"
        for col_idx in range(cols - 1):
            gap_start = bw + (col_idx + 1) * iw + col_idx * ibw
            c0 = max(bw, gap_start - radius)
            c1 = min(gw - bw, gap_start + ibw + radius)
            band = grid[bw : gh - bw, c0:c1]
            band[band == "wall"] = "empty"

    def shuffle_spawn_indices(self, indices: np.ndarray) -> None:
        if self.config.fixed_spawn_order:
            return
        self._rng.shuffle(indices)

    def build_for_num_agents(self, num_agents: int) -> GameMap:
        if self.config.instances is None and self.config.num_agents is None:
            self.config.num_agents = num_agents
        return self.build()
