"""Build pattern-synthesis scene configs from ASCII samples
(reference: mapgen/utils/make_scene_config.py)."""

from __future__ import annotations

from typing import Optional

from mettagrid_tpu_torch.mapgen.scene import SceneConfig
from mettagrid_tpu_torch.mapgen.scenes.convchain import ConvChain
from mettagrid_tpu_torch.mapgen.scenes.wfc import WFC


def make_convchain_config_from_pattern(pattern: str) -> SceneConfig:
    return ConvChain.Config(pattern_size=3, iterations=10, temperature=1, pattern=pattern)


def make_wfc_config_from_pattern(pattern: str, probe_size: int = 40) -> Optional[SceneConfig]:
    """Return a WFC config for the pattern, or None if generation fails on a
    probe grid (some samples over-constrain the wave and always contradict)."""
    from mettagrid_tpu_torch.mapgen.mapgen import MapGen

    scene_config = WFC.Config(pattern_size=3, pattern=pattern)
    probe = MapGen.Config(width=probe_size, height=probe_size, instance=scene_config).create()
    try:
        probe.build()
    except Exception:
        return None
    return scene_config
