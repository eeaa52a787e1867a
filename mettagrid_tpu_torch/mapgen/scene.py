"""Scene graph: composable procedural map generation
(reference: python/src/mettagrid/mapgen/scene.py).

A Scene renders into its Area's grid view (optionally through a transform),
declares sub-areas of interest, and recursively renders child scenes chosen
by AreaQuery actions. Scene configs are polymorphic via a dotted `type`
path, so whole scene trees load from YAML/JSON.
"""

from __future__ import annotations

from enum import Enum
from typing import Any, ClassVar, Generic, Optional, TypeVar, get_args, get_origin

import numpy as np
from pydantic import SerializeAsAny, model_serializer, model_validator

from mettagrid_tpu_torch.base_config import Config
from mettagrid_tpu_torch.mapgen.area import Area, AreaQuery, AreaWhere
# The port's one dotted-path resolver: it refuses paths into the JAX package.
from mettagrid_tpu_torch.util.module import load_symbol


class GridTransform(str, Enum):
    """Grid symmetries; applied as numpy views so children write through."""

    IDENTITY = "identity"
    ROT_90 = "rot_90"
    ROT_180 = "rot_180"
    ROT_270 = "rot_270"
    FLIP_H = "flip_h"
    FLIP_V = "flip_v"
    TRANSPOSE = "transpose"
    TRANSPOSE_ALT = "transpose_alt"

    @property
    def _flags(self) -> tuple[bool, bool, bool]:  # (transpose, flip_v, flip_h)
        return _TRANSFORM_FLAGS[self]

    def apply(self, grid: np.ndarray) -> np.ndarray:
        t, fv, fh = self._flags
        out = grid.T if t else grid
        if fv:
            out = np.flip(out, axis=0)
        if fh:
            out = np.flip(out, axis=1)
        return out

    def apply_to_coords(self, grid: np.ndarray, x: int, y: int) -> tuple[int, int]:
        H, W = grid.shape
        t, fv, fh = self._flags
        if t:
            x, y = y, x
            H, W = W, H
        if fv:
            y = H - 1 - y
        if fh:
            x = W - 1 - x
        return x, y

    def inverse(self) -> "GridTransform":
        if self == GridTransform.ROT_90:
            return GridTransform.ROT_270
        if self == GridTransform.ROT_270:
            return GridTransform.ROT_90
        return self

    def compose(self, other: "GridTransform") -> "GridTransform":
        probe = np.arange(4).reshape(2, 2)
        target = other.apply(self.apply(probe))
        for t in GridTransform:
            if np.array_equal(t.apply(probe), target):
                return t
        raise RuntimeError("unreachable")


_TRANSFORM_FLAGS = {
    GridTransform.IDENTITY: (False, False, False),
    GridTransform.ROT_90: (True, False, True),
    GridTransform.ROT_180: (False, True, True),
    GridTransform.ROT_270: (True, True, False),
    GridTransform.FLIP_H: (False, False, True),
    GridTransform.FLIP_V: (False, True, False),
    GridTransform.TRANSPOSE: (True, False, False),
    GridTransform.TRANSPOSE_ALT: (True, True, True),
}


class SceneConfig(Config):
    """Base config; bound to its Scene class by Scene.__init_subclass__."""

    _scene_cls: ClassVar[Optional[type]] = None

    children: list["ChildrenAction"] = []
    seed: Optional[int] = None
    transform: GridTransform = GridTransform.IDENTITY

    @property
    def scene_cls(self) -> type:
        assert self._scene_cls is not None, f"{type(self).__name__} is not bound to a scene"
        return self._scene_cls

    @classmethod
    def _type_str(cls) -> str:
        sc = cls._scene_cls
        assert sc is not None
        return f"{sc.__module__}.{sc.__name__}.Config"

    @model_serializer(mode="wrap")
    def _serialize_with_type(self, handler):
        return {"type": self._type_str(), **handler(self)}

    @model_validator(mode="wrap")
    @classmethod
    def _validate_with_type(cls, v: Any, handler):
        if isinstance(v, SceneConfig):
            if not isinstance(v, cls):
                raise TypeError(f"Expected {cls.__qualname__}, got {type(v).__qualname__}")
            return v
        if not isinstance(v, dict):
            raise ValueError("SceneConfig params must be a dict")
        t = v.get("type")
        if t is None:
            return handler(v)
        type_cls = load_symbol(t) if isinstance(t, str) else t
        if not (isinstance(type_cls, type) and issubclass(type_cls, cls)):
            raise TypeError(f"'type' {t} is not a subclass of {cls.__qualname__}")
        return type_cls.model_validate({k: x for k, x in v.items() if k != "type"})

    def create_root(self, area: Area, rng: Optional[np.random.Generator] = None) -> "Scene":
        return self.scene_cls(area=area, config=self, rng=rng or np.random.default_rng())

    def create_as_child(self, parent: "Scene", area: Area) -> "Scene":
        return self.scene_cls(area=area, config=self, rng=parent.rng.spawn(1)[0], parent_scene=parent)


AnySceneConfig = SerializeAsAny[SceneConfig]


class ChildrenAction(AreaQuery):
    scene: AnySceneConfig


SceneConfig.model_rebuild()

ConfigT = TypeVar("ConfigT", bound=SceneConfig)


class Scene(Generic[ConfigT]):
    """Base scene. Subclasses inherit Scene[TheirConfig] and implement render()."""

    Config: type[ConfigT]

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        bases = [b for b in getattr(cls, "__orig_bases__", ()) if get_origin(b) is Scene]
        if len(bases) != 1:
            raise TypeError(f"{cls.__name__} must inherit Scene[ConfigT]")
        cfg = get_args(bases[0])[0]
        if cfg._scene_cls is not None:
            raise ValueError(f"{cfg.__name__} already bound to {cfg._scene_cls.__name__}")
        cfg._scene_cls = cls
        cls.Config = cfg

    def __init__(
        self,
        area: Area,
        rng: np.random.Generator,
        config: ConfigT,
        parent_scene: Optional["Scene"] = None,
    ):
        self.config = self.Config.model_validate(config)
        self.area = area
        self.parent_scene = parent_scene
        self.children: list[Scene] = []
        self.transform = (
            parent_scene.transform.compose(self.config.transform)
            if parent_scene
            else self.config.transform
        )
        # Render through the inverse transform so the net effect on the
        # original grid is the configured transform.
        self.grid = self.transform.inverse().apply(self.area.grid)
        self.height, self.width = self.grid.shape
        self.rng = np.random.default_rng(self.config.seed) if self.config.seed is not None else rng
        self._areas: list[Area] = []
        self._locks: dict[str, set[int]] = {}
        self.post_init()

    def post_init(self) -> None:
        pass

    @classmethod
    def intrinsic_size(cls, config: "SceneConfig") -> Optional[tuple[int, int]]:
        """(height, width) for scenes with a fixed size (e.g. ASCII data), else
        None. Used by MapGen to size the map when width/height are omitted
        (reference: mapgen/scene.py:475-493)."""
        return None

    def _update_grid_view(self) -> None:
        """Recompute the (possibly transformed) grid view from the area."""
        self.grid = self.transform.inverse().apply(self.area.grid)
        self.height, self.width = self.grid.shape

    def transplant_to_grid(self, grid: np.ndarray, shift_x: int, shift_y: int, is_root: bool = True) -> None:
        """Re-root this rendered scene (and its subtree) onto a new outer grid,
        copying the rendered cells once at the top level
        (reference: mapgen/scene.py:497-528)."""
        if is_root:
            self.area.transplant_to_grid(grid, shift_x, shift_y, copy_grid=True)
        self._update_grid_view()
        for sub_area in self._areas:
            sub_area.transplant_to_grid(grid, shift_x, shift_y, copy_grid=False)
        for child in self.children:
            child.transplant_to_grid(grid, shift_x, shift_y, is_root=False)

    def render(self) -> None:
        raise NotImplementedError

    def get_children(self) -> list[ChildrenAction]:
        """Dynamically generated children (static config children always append)."""
        return []

    def render_with_children(self) -> None:
        self.render()
        for action in self.get_children() + list(self.config.children):
            for area in self.select_areas(action):
                child = action.scene.create_as_child(self, area)
                self.children.append(child)
                child.render_with_children()

    def make_area(self, x: int, y: int, width: int, height: int, tags: Optional[list[str]] = None) -> Area:
        inv = self.transform.inverse()
        x1, y1 = inv.apply_to_coords(self.grid, x, y)
        x2, y2 = inv.apply_to_coords(self.grid, x + width - 1, y + height - 1)
        if x1 > x2:
            x1, x2 = x2, x1
        if y1 > y2:
            y1, y2 = y2, y1
        area = self.area.make_subarea(x=x1, y=y1, width=x2 - x1 + 1, height=y2 - y1 + 1, tags=tags)
        self._areas.append(area)
        return area

    def select_areas(self, query: AreaQuery) -> list[Area]:
        """Tag/lock-aware area selection (reference: mapgen/scene.py:420-480)."""
        if query.where == "full":
            return [self.area]
        areas = list(self._areas)
        if isinstance(query.where, AreaWhere):
            for tag in query.where.tags:
                areas = [a for a in areas if tag in a.tags]
        if query.lock is not None:
            locked = self._locks.setdefault(query.lock, set())
            areas = [a for a in areas if id(a) not in locked]
        if query.order_by == "random":
            idx = self.rng.permutation(len(areas))
            areas = [areas[i] for i in idx]
        elif query.order_by == "last":
            areas = areas[::-1]
        offset = query.offset or 0
        if query.limit is not None:
            areas = areas[offset : offset + query.limit]
        elif offset:
            areas = areas[offset:]
        if query.lock is not None:
            self._locks[query.lock].update(id(a) for a in areas)
        return areas
