"""Mapgen utilities (reference: python/src/mettagrid/mapgen/utils/)."""

from mettagrid_tpu_torch.mapgen.utils.make_scene_config import (
    make_convchain_config_from_pattern,
    make_wfc_config_from_pattern,
)

__all__ = [
    "make_convchain_config_from_pattern",
    "make_wfc_config_from_pattern",
]
