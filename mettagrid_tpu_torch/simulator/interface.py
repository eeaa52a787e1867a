"""Simulation interfaces: observation views + event-handler hooks
(reference: python/src/mettagrid/simulator/interface.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, NamedTuple, Optional

if TYPE_CHECKING:
    from mettagrid_tpu_torch.simulator.simulator import Simulation

GLOBAL_LOCATION = 0xFE
EMPTY_BYTE = 0xFF


class Location(NamedTuple):
    """A grid location (row, col)."""

    r: int
    c: int

    @property
    def x(self) -> int:
        return self.c

    @property
    def y(self) -> int:
        return self.r


@dataclass(frozen=True)
class ObservationToken:
    """One observation token [location_byte, feature_id, value]."""

    location_byte: int
    feature_id: int
    feature_name: str
    value: int

    @property
    def is_global(self) -> bool:
        return self.location_byte == GLOBAL_LOCATION

    @property
    def location(self) -> Optional[Location]:
        if self.is_global or self.location_byte == EMPTY_BYTE:
            return None
        return Location(r=(self.location_byte >> 4) & 0x0F, c=self.location_byte & 0x0F)

    @property
    def row(self) -> Optional[int]:
        loc = self.location
        return loc.r if loc else None

    @property
    def col(self) -> Optional[int]:
        loc = self.location
        return loc.c if loc else None


@dataclass
class AgentObservation:
    """Decoded token observation for one agent."""

    tokens: list[ObservationToken] = field(default_factory=list)


class SimulatorEventHandler:
    """Hook interface: subclass and register with a Simulator
    (reference: simulator/interface.py:75-93). Consumers: replay writers,
    stats writers, renderers, early-reset handlers."""

    def __init__(self):
        self._simulation: Optional["Simulation"] = None

    def set_simulation(self, simulation: "Simulation") -> None:
        self._simulation = simulation

    def on_episode_start(self) -> None:
        pass

    def on_episode_end(self) -> None:
        pass

    def on_step(self) -> None:
        pass

    def on_close(self) -> None:
        pass
