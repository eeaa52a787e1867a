"""Renderer base: a SimulatorEventHandler with display duties
(reference: python/src/mettagrid/renderer/renderer.py)."""

from __future__ import annotations

from mettagrid_tpu_torch.simulator.interface import SimulatorEventHandler


class Renderer(SimulatorEventHandler):
    """Base class for renderers; hooks fire from the Simulation."""

    @property
    def sim(self):
        return self._simulation
