"""Prebuilt environment configurations (reference: python/src/mettagrid/builder/)."""

from mettagrid_tpu_torch.builder import building
from mettagrid_tpu_torch.builder.envs import make_arena, make_assembly_lines, make_navigation

__all__ = ["building", "make_arena", "make_assembly_lines", "make_navigation"]
