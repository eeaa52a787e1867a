"""State-query helper catalog for scripted agents
(reference: sdk/agent/helpers.py)."""

from __future__ import annotations

from collections import Counter
from typing import Optional, Protocol, Union, runtime_checkable

from pydantic import BaseModel

from mettagrid_tpu_torch.sdk.state import MettagridState, SemanticEntity

AttrValue = Union[str, int, float, bool]


class HelperCapability(BaseModel):
    name: str
    description: str


class HelperCatalog:
    def __init__(self, capabilities: list[HelperCapability]) -> None:
        self._capabilities = list(capabilities)

    def list_capabilities(self) -> list[HelperCapability]:
        return list(self._capabilities)

    def render_capability_summary(self, max_items: int | None = None) -> str:
        caps = self.list_capabilities()
        if max_items is not None:
            caps = caps[:max_items]
        if not caps:
            return "none"
        return "\n".join(f"- {c.name}: {c.description}" for c in caps)


_STATE_CAPABILITIES: tuple[tuple[str, str], ...] = (
    ("agent_id", "Return the current agent id."),
    ("shared_inventory", "Return the current team shared inventory."),
    ("shared_objectives", "Return the current team shared objectives."),
    ("seen_resources", "Return resource names recorded in seen_resource:* shared objectives."),
    ("missing_resources", "Return resource names recorded in missing_resource:* shared objectives."),
    ("self_attribute", "Return an attribute from state.self_state.attributes with an optional default."),
    ("position", "Return the current semantic (x, y) position."),
    ("visible_entity_counts", "Return counts of visible semantic entities by entity_type."),
    ("recent_event_types", "Return recent semantic event types in order of appearance."),
    ("visible_entities", "Return visible entities filtered by entity_type, label, or max_distance."),
    ("nearest_visible_entity", "Return the nearest visible entity after optional filtering."),
    ("distance_to_entity", "Return Manhattan distance to one visible entity by id, or None."),
    ("visible_entity_ids", "Return entity ids for visible entities after optional filtering."),
    ("entity_by_id", "Return one currently visible entity by id, or None."),
)


def _manhattan(state: MettagridState, entity: SemanticEntity) -> int:
    return abs(entity.position.x - state.self_state.position.x) + abs(
        entity.position.y - state.self_state.position.y
    )


class StateHelperCatalog(HelperCatalog):
    """Read-only semantic queries over one MettagridState snapshot."""

    def __init__(
        self, state: MettagridState, capabilities: Optional[list[HelperCapability]] = None
    ) -> None:
        super().__init__(
            capabilities
            if capabilities is not None
            else [HelperCapability(name=n, description=d) for n, d in _STATE_CAPABILITIES]
        )
        self._state = state

    def agent_id(self) -> int:
        value = self.self_attribute("agent_id", 0)
        assert isinstance(value, (str, int, bool))
        return int(value)

    def shared_inventory(self) -> dict[str, int]:
        team = self._state.team_summary
        return dict(team.shared_inventory) if team is not None else {}

    def shared_objectives(self) -> list[str]:
        team = self._state.team_summary
        return list(team.shared_objectives) if team is not None else []

    def _objective_values(self, prefix: str) -> list[str]:
        tag = f"{prefix}:"
        return [o[len(tag):] for o in self.shared_objectives() if o.startswith(tag)]

    def seen_resources(self) -> list[str]:
        return self._objective_values("seen_resource")

    def missing_resources(self) -> list[str]:
        return self._objective_values("missing_resource")

    def self_attribute(self, name: str, default: AttrValue | None = None) -> AttrValue | None:
        return self._state.self_state.attributes.get(name, default)

    def position(self) -> tuple[int, int]:
        return (self._state.self_state.position.x, self._state.self_state.position.y)

    def visible_entity_counts(self) -> dict[str, int]:
        return dict(sorted(Counter(e.entity_type for e in self._state.visible_entities).items()))

    def recent_event_types(self) -> list[str]:
        return list(dict.fromkeys(e.event_type for e in self._state.recent_events))

    def visible_entities(
        self,
        entity_type: str | None = None,
        label: str | None = None,
        max_distance: int | None = None,
    ) -> list[SemanticEntity]:
        out = []
        for e in self._state.visible_entities:
            if entity_type is not None and e.entity_type != entity_type:
                continue
            if label is not None and label not in e.labels:
                continue
            if max_distance is not None and _manhattan(self._state, e) > max_distance:
                continue
            out.append(e)
        return out

    def visible_entity_ids(
        self,
        entity_type: str | None = None,
        label: str | None = None,
        max_distance: int | None = None,
    ) -> list[str]:
        return [
            e.entity_id
            for e in self.visible_entities(
                entity_type=entity_type, label=label, max_distance=max_distance
            )
        ]

    def entity_by_id(self, entity_id: str) -> SemanticEntity | None:
        for e in self._state.visible_entities:
            if e.entity_id == entity_id:
                return e
        return None

    def nearest_visible_entity(
        self,
        entity_type: str | None = None,
        label: str | None = None,
        max_distance: int | None = None,
    ) -> SemanticEntity | None:
        candidates = self.visible_entities(
            entity_type=entity_type, label=label, max_distance=max_distance
        )
        return min(
            candidates,
            key=lambda e: (_manhattan(self._state, e), e.entity_id),
            default=None,
        )

    def distance_to_entity(self, entity_id: str) -> int | None:
        e = self.entity_by_id(entity_id)
        return None if e is None else _manhattan(self._state, e)


@runtime_checkable
class MettagridHelpers(Protocol):
    def list_capabilities(self) -> list[HelperCapability]: ...

    def render_capability_summary(self, max_items: int | None = None) -> str: ...
