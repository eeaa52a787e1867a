"""Miniscope terminal renderers (reference: renderer/miniscope/).

- `MiniscopeRenderer`: simple non-blocking frame renderer (map + status).
- `InteractiveMiniscope`: full TUI — panels, playback control, manual agent
  takeover, vibe picker, help modal.
"""

from mettagrid_tpu_torch.renderer.miniscope.components import (
    AgentControlComponent,
    AgentInfoComponent,
    HelpPanelComponent,
    MapComponent,
    MiniscopeComponent,
    ObjectInfoComponent,
    SimControlComponent,
    SymbolsTableComponent,
    VibePickerComponent,
)
from mettagrid_tpu_torch.renderer.miniscope.interactive import InteractiveMiniscope
from mettagrid_tpu_torch.renderer.miniscope.simple import MiniscopeRenderer
from mettagrid_tpu_torch.renderer.miniscope.state import MiniscopeState, PlaybackState, RenderMode

__all__ = [
    "AgentControlComponent",
    "AgentInfoComponent",
    "HelpPanelComponent",
    "InteractiveMiniscope",
    "MapComponent",
    "MiniscopeComponent",
    "MiniscopeRenderer",
    "MiniscopeState",
    "ObjectInfoComponent",
    "PlaybackState",
    "RenderMode",
    "SimControlComponent",
    "SymbolsTableComponent",
    "VibePickerComponent",
]
