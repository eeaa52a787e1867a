"""Macro-action catalog for scripted/LLM agents
(reference: sdk/agent/actions.py)."""

from __future__ import annotations

from typing import Protocol, Union, runtime_checkable

from pydantic import BaseModel, Field


class ActionDescriptor(BaseModel):
    """Describes one macro action a scripted agent may request."""

    name: str
    description: str
    preconditions: list[str] = Field(default_factory=list)
    terminal_reasons: list[str] = Field(default_factory=list)


class ActionOutcome(BaseModel):
    """Result of a finished macro action."""

    action: str
    success: bool
    reason: str
    step_started: int
    step_finished: int
    evidence: list[str] = Field(default_factory=list)
    metadata: dict[str, Union[str, int, float, bool]] = Field(default_factory=dict)


class ActionCatalog:
    def __init__(self, actions: list[ActionDescriptor]) -> None:
        self._actions = list(actions)

    def list_actions(self) -> list[ActionDescriptor]:
        return list(self._actions)


@runtime_checkable
class MettagridActions(Protocol):
    def list_actions(self) -> list[ActionDescriptor]: ...
