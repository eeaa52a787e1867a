"""MapBuilder base classes (reference: python/src/mettagrid/map_builder/map_builder.py).

A MapBuilderConfig is a polymorphic pydantic model discriminated by a dotted
"type" path; `create()` instantiates its bound builder; `build()` returns a
GameMap (NumPy grid of map_name strings). `build_for_num_agents()` validates
and trims agent spawn points.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from pathlib import Path
from typing import (
    Any,
    ClassVar,
    Generic,
    Protocol,
    Self,
    TypeVar,
    cast,
    runtime_checkable,
)

import numpy as np
from pydantic import ModelWrapValidatorHandler, SerializeAsAny, model_serializer, model_validator

from mettagrid_tpu_torch.base_config import Config
from mettagrid_tpu_torch.maps.types import MapGrid
from mettagrid_tpu_torch.util.module import load_symbol

logger = logging.getLogger(__name__)


class GameMap:
    """A built game map: a 2-D grid of map_name strings ("wall", "empty", "agent.agent", ...)."""

    grid: MapGrid

    def __init__(self, grid: MapGrid):
        self.grid = grid


TBuilder = TypeVar("TBuilder", bound="MapBuilder[Any]")


class MapBuilderConfig(Config, Generic[TBuilder]):
    """Base class for all map builder configs; serializes with a dotted "type" key."""

    _builder_cls: ClassVar[type[MapBuilder] | None] = None

    @classmethod
    def builder_cls(cls) -> type[TBuilder]:
        if cls._builder_cls is None:
            raise TypeError(f"{cls.__qualname__} is not bound to a MapBuilder")
        return cast(type[TBuilder], cls._builder_cls)

    def create(self) -> TBuilder:
        """Instantiate the bound MapBuilder."""
        return self.builder_cls()(self)  # type: ignore[call-arg]

    @classmethod
    def from_uri(cls, uri: str | Path) -> Self:
        """Load a builder config from a YAML or JSON file."""
        import yaml

        path = Path(uri)
        with path.open("r", encoding="utf-8") as f:
            return cls.from_str(f.read())

    @classmethod
    def from_str(cls, data: str | bytes) -> Self:
        import yaml

        return cls.model_validate(yaml.safe_load(data))

    @classmethod
    def _type_str(cls) -> str:
        builder_cls = cls.builder_cls()
        return f"{builder_cls.__module__}.{builder_cls.__qualname__}.Config"

    @model_serializer(mode="wrap")
    def _serialize_with_type(self, handler):
        data = handler(self)
        return {"type": self._type_str(), **data}

    @model_validator(mode="wrap")
    @classmethod
    def _validate_with_type(cls, v: Any, handler: ModelWrapValidatorHandler[Self]) -> Self:
        """Accepts a specific MapBuilderConfig instance, or a dict with an
        optional {"type": "<dotted.path.to.Builder.Config>"} discriminator.
        A type path into the JAX package (``mettagrid_tpu.``) raises
        ImportError before anything is imported (util.module.load_symbol)."""
        if isinstance(v, MapBuilderConfig):
            if not isinstance(v, cls):
                raise TypeError(f"Expected {cls.__qualname__} subclass, got {type(v).__qualname__}")
            return v

        if not isinstance(v, dict):
            raise ValueError("MapBuilderConfig params must be a dict")

        t = v.pop("type", None)
        if t is None:
            # Direct instantiation from Python won't include "type".
            return handler(v)

        config_cls = load_symbol(t)
        if not (isinstance(config_cls, type) and issubclass(config_cls, MapBuilderConfig)):
            raise TypeError(f"{t} is not a MapBuilderConfig subclass")
        if config_cls is cls:
            return handler(v)
        return cast(Self, config_cls.model_validate(v))


# Any polymorphic map builder config: SerializeAsAny so subclass fields
# survive round-trips through fields declared with the base type
# (reference: map_builder.py uses the same pattern).
AnyMapBuilderConfig = SerializeAsAny[MapBuilderConfig]


TConfig = TypeVar("TConfig", bound=MapBuilderConfig)


@runtime_checkable
class HasSeed(Protocol):
    """Type-safe check for configs that carry a seed."""

    seed: int | None


class MapBuilder(ABC, Generic[TConfig]):
    """Builds GameMaps from a bound config class.

    Subclasses declare a nested/associated Config class; binding happens in
    __init_subclass__ by inspecting the `Config` attribute.
    """

    Config: ClassVar[type[MapBuilderConfig]]

    def __init__(self, config: TConfig):
        self.config = config

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        config_cls = cls.__dict__.get("Config") or getattr(cls, "Config", None)
        if config_cls is not None:
            if config_cls._builder_cls is not None and config_cls._builder_cls is not cls:
                # Config reused by another builder: clone it so each builder
                # has a distinct bound config class.
                config_cls = type(config_cls.__name__, (config_cls,), {})
                cls.Config = config_cls
            config_cls._builder_cls = cls

    @abstractmethod
    def build(self) -> GameMap: ...

    def build_for_num_agents(self, num_agents: int, retry_budget: int = 0) -> GameMap:
        """Build a map, validating/trimming agent spawn points; retries builds
        that fail with ValueError up to retry_budget times."""
        for attempt in range(retry_budget + 1):
            try:
                game_map = self.build()
                self._designate_agent_spawn_points(game_map, num_agents)
                return game_map
            except ValueError as exc:
                if attempt == retry_budget:
                    raise exc
                logger.warning(
                    "Map build failed with ValueError on attempt %s/%s: %s; retrying",
                    attempt + 1,
                    retry_budget + 1,
                    exc,
                )
        raise ValueError(f"Failed to build map for {num_agents} agents")

    def shuffle_spawn_indices(self, indices: np.ndarray) -> None:
        """Shuffle candidate spawn indices (seed-dependent when config has a seed)."""
        seed = self.config.seed if isinstance(self.config, HasSeed) else None
        np.random.default_rng(seed).shuffle(indices)

    def _designate_agent_spawn_points(self, game_map: GameMap, num_agents: int) -> None:
        """Validate spawn-point count; excess "agent*" cells become "empty"."""
        spawn_mask = np.char.startswith(game_map.grid, "agent")
        level_agents = int(np.count_nonzero(spawn_mask))

        if level_agents < num_agents:
            raise ValueError(f"Number of agents {num_agents} exceeds available spawn points {level_agents} in map.")

        if level_agents > num_agents:
            spawn_indices = np.argwhere(spawn_mask)
            self.shuffle_spawn_indices(spawn_indices)
            for idx in spawn_indices[num_agents:]:
                game_map.grid[tuple(idx)] = "empty"
