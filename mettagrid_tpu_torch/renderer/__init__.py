"""Renderers (reference: python/src/mettagrid/renderer/)."""

from mettagrid_tpu_torch.renderer.log_renderer import LogRenderer
from mettagrid_tpu_torch.renderer.miniscope import InteractiveMiniscope, MiniscopeRenderer
from mettagrid_tpu_torch.renderer.renderer import Renderer

__all__ = ["InteractiveMiniscope", "LogRenderer", "MiniscopeRenderer", "Renderer"]
