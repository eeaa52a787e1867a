"""Semantic state views for scripted/LLM agents
(reference: sdk/agent/state.py:6-67)."""

from __future__ import annotations

from typing import Optional, Union

from pydantic import BaseModel, Field


class GridPosition(BaseModel):
    x: int
    y: int


class SemanticEntity(BaseModel):
    entity_id: str
    entity_type: str
    position: GridPosition
    labels: list[str] = Field(default_factory=list)
    attributes: dict[str, Union[str, int, float, bool]] = Field(default_factory=dict)


class SelfState(SemanticEntity):
    role: Optional[str] = None
    inventory: dict[str, int] = Field(default_factory=dict)
    status: list[str] = Field(default_factory=list)


class TeamMemberSummary(BaseModel):
    entity_id: str
    role: str
    position: GridPosition
    status: list[str] = Field(default_factory=list)


class TeamSummary(BaseModel):
    team_id: str
    members: list[TeamMemberSummary] = Field(default_factory=list)
    shared_inventory: dict[str, int] = Field(default_factory=dict)
    shared_objectives: list[str] = Field(default_factory=list)


class KnownWorldState(BaseModel):
    """Exploration bookkeeping (reference: sdk/agent/state.py KnownWorldState)."""

    explored_regions: list[str] = Field(default_factory=list)
    frontier_regions: list[str] = Field(default_factory=list)
    contested_regions: list[str] = Field(default_factory=list)


class SemanticEvent(BaseModel):
    """A notable event surfaced to scripted agents."""

    event_id: str
    event_type: str
    step: int
    location: Optional[GridPosition] = None
    importance: float = 0.0
    summary: str
    evidence: list[str] = Field(default_factory=list)


class MettagridState(BaseModel):
    """Top-level semantic snapshot handed to a scripted agent."""

    game: str
    step: Optional[int] = None
    self_state: SelfState
    visible_entities: list[SemanticEntity] = Field(default_factory=list)
    known_world: KnownWorldState = Field(default_factory=KnownWorldState)
    team_summary: Optional[TeamSummary] = None
    recent_events: list[SemanticEvent] = Field(default_factory=list)
