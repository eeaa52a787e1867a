"""Scene-graph procedural map generation (reference: python/src/mettagrid/mapgen/).

Host-side NumPy: maps are built at reset and uploaded to device."""

from mettagrid_tpu_torch.mapgen.area import Area, AreaQuery, AreaWhere
from mettagrid_tpu_torch.mapgen.mapgen import MapGen, MapGenConfig
from mettagrid_tpu_torch.mapgen.scene import ChildrenAction, GridTransform, Scene, SceneConfig

__all__ = [
    "Area",
    "AreaQuery",
    "AreaWhere",
    "ChildrenAction",
    "GridTransform",
    "MapGen",
    "MapGenConfig",
    "Scene",
    "SceneConfig",
]
